"""Control-plane scale: the planning paths must be vectorized numpy, not
Python loops — the reference handles 239k files / tens of millions of
chunks (CHANGELOG.md:77), so a 1M-chunk plan must build in about a second.
"""

import time

import numpy as np
import pytest

from longtail_jax.formats.store_index import StoreIndex
from longtail_jax.formats.version_index import VersionIndex


def synth_version(n_assets: int, chunks_per_asset: int) -> VersionIndex:
    n_chunks = n_assets * chunks_per_asset
    rng = np.random.default_rng(3)
    names = bytearray()
    offs = []
    for a in range(n_assets):
        offs.append(len(names))
        names += f"dir{a % 97}/file{a}.bin".encode() + b"\0"
    return VersionIndex(
        hash_identifier=0x626C6B33,
        target_chunk_size=32768,
        path_hashes=rng.integers(0, 2**63, n_assets, dtype=np.uint64),
        content_hashes=rng.integers(0, 2**63, n_assets, dtype=np.uint64),
        asset_sizes=np.full(n_assets, chunks_per_asset * 1000, np.uint64),
        asset_chunk_counts=np.full(n_assets, chunks_per_asset, np.uint32),
        asset_chunk_index_starts=np.arange(
            0, n_chunks, chunks_per_asset, dtype=np.uint32),
        asset_chunk_indexes=np.arange(n_chunks, dtype=np.uint32),
        chunk_hashes=rng.permutation(
            np.arange(1, n_chunks + 1, dtype=np.uint64)),
        chunk_sizes=np.full(n_chunks, 1000, np.uint32),
        chunk_tags=np.zeros(n_chunks, np.uint32),
        name_offsets=np.asarray(offs, dtype=np.uint32),
        permissions=np.full(n_assets, 0o644, np.uint16),
        name_data=bytes(names),
    )


def synth_store(vi: VersionIndex, chunks_per_block: int) -> StoreIndex:
    n = vi.chunk_count
    n_blocks = -(-n // chunks_per_block)
    counts = np.full(n_blocks, chunks_per_block, np.uint32)
    counts[-1] = n - chunks_per_block * (n_blocks - 1)
    offsets = np.cumsum(counts, dtype=np.uint32) - counts
    return StoreIndex(
        hash_identifier=vi.hash_identifier,
        block_hashes=np.arange(1, n_blocks + 1, dtype=np.uint64),
        chunk_hashes=vi.chunk_hashes.copy(),
        block_chunks_offsets=offsets,
        block_chunk_counts=counts,
        block_tags=np.zeros(n_blocks, np.uint32),
        chunk_sizes=vi.chunk_sizes.copy(),
    )


@pytest.fixture(scope="module")
def million():
    vi = synth_version(n_assets=4000, chunks_per_asset=250)  # 1M chunks
    si = synth_store(vi, chunks_per_block=512)
    return vi, si


def test_asset_part_lookup_scales(million):
    from longtail_jax.core.write import create_asset_part_lookup

    vi, _ = million
    t0 = time.process_time()          # CPU time: immune to co-tenants
    lookup = create_asset_part_lookup(vi)
    dt = time.process_time() - t0
    assert len(lookup) == vi.chunk_count
    a, off, size = lookup[int(vi.chunk_hashes[12345])]
    assert size == 1000
    assert dt < 3.0, f"asset part lookup took {dt:.2f}s CPU"


def test_block_write_infos_scale(million):
    from longtail_jax.core.change import _build_block_write_infos

    vi, si = million
    t0 = time.process_time()          # CPU time: immune to co-tenants
    per_block = _build_block_write_infos(
        vi, si, np.arange(vi.asset_count, dtype=np.int64))
    dt = time.process_time() - t0
    assert len(per_block) == si.block_count
    n_writes = sum(len(v[0]) for v in per_block.values())
    assert n_writes == vi.chunk_count
    assert dt < 3.0, f"block write plan took {dt:.2f}s CPU"


def test_block_write_infos_matches_oracle():
    """Vectorized plan == a straightforward dict/loop oracle on a small
    randomized instance (including duplicate chunks across blocks)."""
    from longtail_jax.core.change import _build_block_write_infos

    vi = synth_version(n_assets=13, chunks_per_asset=7)
    si = synth_store(vi, chunks_per_block=5)
    per_block = _build_block_write_infos(
        vi, si, np.arange(vi.asset_count, dtype=np.int64))

    # oracle
    chunk_to_block = {}
    for b in range(si.block_count):
        hashes, sizes = si.block_chunks(b)
        off = 0
        for h, s in zip(hashes, sizes):
            chunk_to_block.setdefault(int(h), (b, off))
            off += int(s)
    want = {}
    for a in range(vi.asset_count):
        fo = 0
        for ci in vi.asset_chunks(a):
            h = int(vi.chunk_hashes[ci])
            size = int(vi.chunk_sizes[ci])
            b, boff = chunk_to_block[h]
            want.setdefault(b, []).append((a, fo, boff, size))
            fo += size
    assert set(per_block) == set(want)
    for b, (assets, fo, bo, sz) in per_block.items():
        got = sorted(zip(assets.tolist(), fo.tolist(),
                         bo.tolist(), sz.tolist()))
        assert got == sorted(want[b])


def test_required_chunk_hashes_scale(million):
    from longtail_jax.core.diff import VersionDiff, get_required_chunk_hashes

    vi, _ = million
    z = np.zeros(0, np.int64)
    diff = VersionDiff(
        source_removed_asset_indexes=z,
        target_added_asset_indexes=np.arange(vi.asset_count, dtype=np.int64),
        source_content_modified_asset_indexes=z,
        target_content_modified_asset_indexes=z,
        source_permissions_modified_asset_indexes=z,
        target_permissions_modified_asset_indexes=z,
    )
    t0 = time.process_time()          # CPU time: immune to co-tenants
    req = get_required_chunk_hashes(vi, diff)
    dt = time.process_time() - t0
    assert len(req) == vi.chunk_count
    # first-seen order: the first asset's chunks lead
    assert req[0] == vi.chunk_hashes[int(vi.asset_chunks(0)[0])]
    assert dt < 3.0, f"required chunk hashes took {dt:.2f}s"


def test_existing_store_index_scales(million):
    from longtail_jax.core.dedup import get_existing_store_index

    vi, si = million
    t0 = time.process_time()          # CPU time: immune to co-tenants
    sub = get_existing_store_index(si, vi.chunk_hashes[: 200_000])
    dt = time.process_time() - t0
    assert sub.block_count > 0
    assert dt < 10.0, f"existing store index took {dt:.2f}s"
