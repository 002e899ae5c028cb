"""StoreIndex algebra: merge / prune / split / validate / copy.

Reference: Longtail_MergeStoreIndex src/longtail.c:9151 (local blocks keep
precedence, remote-only blocks appended), Longtail_PruneStoreIndex :9287,
Longtail_SplitStoreIndex :9607, Longtail_ValidateStore :9423,
Longtail_CopyStoreIndex / GetExistingContent helpers.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from longtail_jax.formats.store_index import StoreIndex


def merge_store_index(local: StoreIndex, remote: StoreIndex) -> StoreIndex:
    """Union of blocks; the local index wins for blocks present in both."""
    if local.block_count == 0 and remote.block_count == 0:
        return StoreIndex.from_blocks([])
    if local.block_count and remote.block_count and \
            local.hash_identifier != remote.hash_identifier:
        raise ValueError("conflicting hash identifiers in store merge")
    blocks = []
    seen: set[int] = set()
    for src in (local, remote):
        for b in range(src.block_count):
            h = int(src.block_hashes[b])
            if h in seen:
                continue
            seen.add(h)
            blocks.append(src.get_block_index(b))
    return StoreIndex.from_blocks(blocks)


def prune_store_index(index: StoreIndex, keep_block_hashes) -> StoreIndex:
    keep = keep_block_hashes if isinstance(keep_block_hashes, set) else \
        set(int(h) for h in np.asarray(keep_block_hashes, dtype=np.uint64))
    blocks = [index.get_block_index(b) for b in range(index.block_count)
              if int(index.block_hashes[b]) in keep]
    return StoreIndex.from_blocks(blocks)


def copy_store_index(index: StoreIndex) -> StoreIndex:
    return StoreIndex.from_bytes(index.to_bytes())


def split_store_index(index: StoreIndex,
                      max_size_bytes: int) -> list[StoreIndex]:
    """Split into partial indexes each serializing to <= max_size_bytes
    (Longtail_SplitStoreIndex, src/longtail.c:9607)."""
    out: list[StoreIndex] = []
    current: list = []
    # serialized cost: 16-byte header + per block 8+4+4+4 + per chunk 8+4
    size = 16
    for b in range(index.block_count):
        bi = index.get_block_index(b)
        cost = 20 + 12 * bi.chunk_count
        if current and size + cost > max_size_bytes:
            out.append(StoreIndex.from_blocks(current))
            current = []
            size = 16
        current.append(bi)
        size += cost
    if current or not out:
        out.append(StoreIndex.from_blocks(current))
    return out


@dataclasses.dataclass
class ValidationResult:
    ok: bool
    missing_chunk_hashes: np.ndarray
    size_mismatch_chunk_hashes: np.ndarray


def validate_store(store_index: StoreIndex, version_index) -> ValidationResult:
    """Longtail_ValidateStore (src/longtail.c:9423): every chunk the version
    references must exist in the store with a matching size."""
    v_hashes = np.asarray(version_index.chunk_hashes, dtype=np.uint64)
    v_sizes = np.asarray(version_index.chunk_sizes, dtype=np.uint32)
    s_hashes = np.asarray(store_index.chunk_hashes, dtype=np.uint64)
    s_sizes = np.asarray(store_index.chunk_sizes, dtype=np.uint32)

    present = np.isin(v_hashes, s_hashes)
    missing = v_hashes[~present]

    mismatched = []
    if len(s_hashes):
        order = np.argsort(s_hashes, kind="stable")
        pos = np.searchsorted(s_hashes[order], v_hashes[present])
        store_size = s_sizes[order[pos]]
        bad = store_size != v_sizes[present]
        mismatched = v_hashes[present][bad]
    return ValidationResult(
        ok=(len(missing) == 0 and len(mismatched) == 0),
        missing_chunk_hashes=missing,
        size_mismatch_chunk_hashes=np.asarray(mismatched, dtype=np.uint64))
