"""Dedup planning: which chunks are new, and how to pack them into blocks.

Mirrors the semantics of ``DiffHashes`` (src/longtail.c:6620-6744),
``Longtail_CreateStoreIndex`` :6745-6881, ``Longtail_CreateMissingContent``
:6882-6999, ``Longtail_GetMissingChunks`` :7000-7058 and
``Longtail_GetExistingStoreIndex`` :7087-7326 — expressed as vectorized set
algebra over hash arrays instead of per-item hash-table walks.
"""

from __future__ import annotations

import numpy as np

from longtail_jax.formats.store_index import BlockIndex, StoreIndex
from longtail_jax.formats.version_index import VersionIndex
from longtail_jax.ops.hash_registry import get_hasher


def added_hashes_in_order(reference_hashes: np.ndarray,
                          new_hashes: np.ndarray) -> np.ndarray:
    """Hashes present in new but not reference, deduplicated, ordered by
    first occurrence in ``new_hashes`` (DiffHashes reorders added hashes back
    to creation order so related chunks land in the same block,
    src/longtail.c:6717-6741)."""
    new_hashes = np.asarray(new_hashes, dtype=np.uint64)
    ref = np.asarray(reference_hashes, dtype=np.uint64)
    mask = ~np.isin(new_hashes, ref)
    added = new_hashes[mask]
    _, first = np.unique(added, return_index=True)
    return added[np.sort(first)]


def pack_blocks(chunk_hashes: np.ndarray, chunk_sizes: np.ndarray,
                chunk_tags: np.ndarray | None,
                max_block_size: int, max_chunks_per_block: int,
                hash_identifier: int) -> StoreIndex:
    """Greedy packing of unique chunks into blocks
    (Longtail_CreateStoreIndex, src/longtail.c:6806-6856):

    - runs of equal tags only;
    - at most max_chunks_per_block chunks;
    - block byte size may overshoot max_block_size by 10%.

    Block hash = hash of the block's chunk-hash array bytes
    (Longtail_CreateBlockIndex, src/longtail.c:3744-3747).
    """
    hasher = get_hasher(hash_identifier)
    chunk_hashes = np.asarray(chunk_hashes, dtype=np.uint64)
    chunk_sizes = np.asarray(chunk_sizes, dtype=np.uint32)
    n = len(chunk_hashes)
    if chunk_tags is None:
        chunk_tags = np.zeros(n, dtype=np.uint32)
    else:
        chunk_tags = np.asarray(chunk_tags, dtype=np.uint32)

    # keep-last-occurrence unique (GetUniqueHashes takes the last index for a
    # repeated hash, src/longtail.c:4330-4343) while preserving order
    _, first = np.unique(chunk_hashes, return_index=True)
    keep = np.sort(first)
    hashes, sizes, tags = chunk_hashes[keep], chunk_sizes[keep], chunk_tags[keep]

    limit = max_block_size + max_block_size // 10
    blocks: list[BlockIndex] = []
    i = 0
    n = len(hashes)
    while i < n:
        j = i + 1
        current = int(sizes[i])
        while j < n:
            if tags[j] != tags[i]:
                break
            if j - i == max_chunks_per_block:
                break
            if current + int(sizes[j]) > limit:
                break
            current += int(sizes[j])
            j += 1
        bh = hasher.hash_buffer(hashes[i:j].astype("<u8").tobytes())
        blocks.append(BlockIndex(
            block_hash=bh, hash_identifier=hash_identifier,
            tag=int(tags[i]), chunk_hashes=hashes[i:j],
            chunk_sizes=sizes[i:j]))
        i = j
    return StoreIndex.from_blocks(blocks)


def create_missing_content(store_index: StoreIndex,
                           version_index: VersionIndex,
                           max_block_size: int,
                           max_chunks_per_block: int) -> StoreIndex:
    """Longtail_CreateMissingContent (src/longtail.c:6882)."""
    added = added_hashes_in_order(store_index.chunk_hashes,
                                  version_index.chunk_hashes)
    if len(added) == 0:
        return StoreIndex.from_blocks([])
    # look up sizes/tags from the version index
    order = np.argsort(version_index.chunk_hashes, kind="stable")
    pos = order[np.searchsorted(version_index.chunk_hashes[order], added)]
    return pack_blocks(
        added, version_index.chunk_sizes[pos], version_index.chunk_tags[pos],
        max_block_size, max_chunks_per_block, version_index.hash_identifier)


def get_missing_chunks(store_index: StoreIndex,
                       chunk_hashes: np.ndarray) -> np.ndarray:
    """Longtail_GetMissingChunks (src/longtail.c:7000): subset of
    chunk_hashes not present in the store (order preserved, not dedup'd)."""
    chunk_hashes = np.asarray(chunk_hashes, dtype=np.uint64)
    return chunk_hashes[~np.isin(chunk_hashes, store_index.chunk_hashes)]


def get_existing_store_index(store_index: StoreIndex,
                             chunk_hashes: np.ndarray,
                             min_block_usage_percent: int = 0) -> StoreIndex:
    """Longtail_GetExistingStoreIndex (src/longtail.c:7087-7326).

    Select a minimal-ish subset of blocks covering the wanted chunks:
    score each block by % of its bytes used, drop blocks under the
    usage cutoff, then greedily take blocks in usage order (ties by
    store position) until every wanted chunk is covered.
    """
    wanted = np.unique(np.asarray(chunk_hashes, dtype=np.uint64))
    if len(wanted) == 0 or store_index.block_count == 0 \
            or min_block_usage_percent > 100:
        return StoreIndex.from_blocks([])

    sizes = store_index.chunk_sizes.astype(np.uint64)
    in_wanted = np.isin(store_index.chunk_hashes, wanted)

    # per-block usage percent
    block_ids = np.repeat(np.arange(store_index.block_count),
                          store_index.block_chunk_counts)
    block_size = np.bincount(block_ids, weights=sizes,
                             minlength=store_index.block_count)
    block_use = np.bincount(block_ids, weights=sizes * in_wanted,
                            minlength=store_index.block_count)
    with np.errstate(divide="ignore", invalid="ignore"):
        pct = np.where(block_size > 0,
                       (block_use * 100 // np.maximum(block_size, 1)), 0)

    candidate = block_use > 0
    if min_block_usage_percent > 0:
        candidate &= pct >= min_block_usage_percent
    cand_idx = np.flatnonzero(candidate)
    if len(cand_idx) == 0:
        return StoreIndex.from_blocks([])

    # sort by usage high->low, stable by store order (SortBlockUsageHighToLow
    # src/longtail.c:7059-7085 ties on index ascending)
    order = cand_idx[np.argsort(-pct[cand_idx], kind="stable")]

    # greedy cover; `wanted` is sorted-unique so membership is searchsorted
    # against a boolean coverage array (no per-chunk Python)
    covered = np.zeros(len(wanted), dtype=bool)
    n_covered = 0
    picked: list[int] = []
    for b in order:
        if n_covered >= len(wanted):
            break
        h, _ = store_index.block_chunks(int(b))
        wi = np.searchsorted(wanted, h)
        wi_c = np.minimum(wi, len(wanted) - 1)
        hit = wi_c[(wanted[wi_c] == h) & ~covered[wi_c]]
        if len(hit):
            covered[hit] = True
            n_covered += len(np.unique(hit))
            picked.append(int(b))
    if not picked:
        return StoreIndex.from_blocks([])
    # emit blocks in store order (the reference walks store order when
    # building the result, src/longtail.c:7270-7280)
    picked.sort()
    return StoreIndex.from_blocks(
        [store_index.get_block_index(b) for b in picked])
