"""CacheBlockStore two-tier semantics (reference
lib/cacheblockstore/longtail_cacheblockstore.c): local-tier coverage in
planning (:671-760), write-back on remote gets (:106-200), offline-remote
degradation, and preflight warming both tiers."""

import numpy as np
import pytest

from longtail_jax import api
from longtail_jax.stores.cacheblockstore import CacheBlockStore
from longtail_jax.stores.fsblockstore import FSBlockStore
from longtail_jax.stores.storage import MemStorage

from test_roundtrip import make_source, read_tree


class _OfflineStore:
    """A remote that fails every call (network down)."""

    def get_stored_block(self, h):
        raise ConnectionError("remote offline")

    def put_stored_block(self, b):
        raise ConnectionError("remote offline")

    def preflight_get(self, hashes):
        raise ConnectionError("remote offline")

    def get_existing_content(self, chunk_hashes,
                             min_block_usage_percent=0):
        raise ConnectionError("remote offline")

    def flush(self):
        pass


def _populated_local():
    """Upsync a tree into a store that will act as the LOCAL cache tier."""
    rng = np.random.default_rng(3)
    storage = MemStorage()
    storage.create_dir("src")
    files = make_source(storage, "src", rng)
    local = FSBlockStore(storage, "cache")
    vi, _ = api.upsync(storage, "src", local, target_chunk_size=2048,
                       workers=2)
    return storage, files, local, vi


def test_local_only_blocks_visible_to_planning():
    """Blocks present only in the local cache must contribute to
    get_existing_content coverage (the reference merges local into the
    remote's answer; a remote missing blocks must not hide local ones)."""
    storage, files, local, vi = _populated_local()
    empty_remote = FSBlockStore(storage, "remote")   # has nothing
    cache = CacheBlockStore(local, empty_remote)

    idx = cache.get_existing_content(vi.chunk_hashes)
    covered = np.isin(vi.chunk_hashes,
                      np.asarray(idx.chunk_hashes, np.uint64))
    assert covered.all(), "local-only blocks invisible to planning"

    # and a full downsync completes from the local tier alone
    api.downsync(cache, storage, "dst", vi, workers=2)
    assert read_tree(storage, "dst") == files


def test_offline_remote_degrades_to_local():
    """An unreachable remote must degrade planning and reads to the
    local tier instead of raising."""
    storage, files, local, vi = _populated_local()
    cache = CacheBlockStore(local, _OfflineStore())

    idx = cache.get_existing_content(vi.chunk_hashes)
    assert idx.block_count > 0
    api.downsync(cache, storage, "dst2", vi, workers=2)
    assert read_tree(storage, "dst2") == files


def test_remote_precedence_and_writeback():
    """Blocks in both tiers plan from the remote's index (remote is the
    source of truth); a remote get writes the block back to local."""
    storage, files, local, vi = _populated_local()
    # build a remote with the same content
    remote = FSBlockStore(storage, "remote2")
    api.upsync(storage, "src", remote, target_chunk_size=2048, workers=2)

    fresh_local = FSBlockStore(storage, "cache2")    # empty local tier
    cache = CacheBlockStore(fresh_local, remote)
    idx = cache.get_existing_content(vi.chunk_hashes)
    covered = np.isin(vi.chunk_hashes,
                      np.asarray(idx.chunk_hashes, np.uint64))
    assert covered.all()

    h = int(idx.block_hashes[0])
    blk = cache.get_stored_block(h)
    cache.flush()    # drain the async write-back
    got = fresh_local.get_stored_block(h)
    assert got.to_bytes() == blk.to_bytes()


def test_preflight_warms_both_tiers():
    storage, files, local, vi = _populated_local()

    seen = {}

    class _Spy:
        def __init__(self, inner, name):
            self._i, self._n = inner, name

        def preflight_get(self, hashes):
            seen[self._n] = list(hashes)
            return self._i.preflight_get(hashes)

        def __getattr__(self, a):
            return getattr(self._i, a)

    cache = CacheBlockStore(_Spy(local, "local"),
                            _Spy(FSBlockStore(storage, "r3"), "remote"))
    cache.preflight_get([1, 2, 3])
    assert seen == {"local": [1, 2, 3], "remote": [1, 2, 3]}
