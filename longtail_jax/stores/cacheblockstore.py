"""Two-tier cache store (lib/cacheblockstore/longtail_cacheblockstore.c):
gets try the local store and fall back to remote with an async write-back to
local (:106-200); puts go to both (:427-560); get_existing_content consults
remote and completes from local (:671-720)."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from longtail_jax.formats.store_index import StoredBlock
from longtail_jax.stores.blockstore import BlockStoreBase


class CacheBlockStore(BlockStoreBase):
    def __init__(self, local, remote, writeback_workers: int = 2):
        super().__init__()
        self.local = local
        self.remote = remote
        self._writeback = ThreadPoolExecutor(max_workers=writeback_workers)
        self._pending = []

    def get_stored_block(self, block_hash: int) -> StoredBlock:
        self.stats.bump("get_stored_block_count")
        try:
            return self.local.get_stored_block(block_hash)
        except Exception:
            pass
        block = self.remote.get_stored_block(block_hash)
        fut = self._writeback.submit(self.local.put_stored_block, block)
        self._pending.append(fut)
        return block

    def put_stored_block(self, stored_block: StoredBlock) -> None:
        self.stats.bump("put_stored_block_count")
        self.remote.put_stored_block(stored_block)
        self.local.put_stored_block(stored_block)

    def preflight_get(self, block_hashes) -> None:
        # warm both tiers: local hits skip the remote fetch entirely,
        # and the remote hint lets a slow backend begin staging
        # (reference forwards the preflight through the chain,
        # lib/cacheblockstore/longtail_cacheblockstore.c:614-668)
        # preflight is a staging HINT: a failing tier must not kill the
        # operation (the reads themselves handle fallback)
        try:
            self.local.preflight_get(block_hashes)
        except Exception:
            pass
        try:
            self.remote.preflight_get(block_hashes)
        except Exception:
            pass

    def get_existing_content(self, chunk_hashes: np.ndarray,
                             min_block_usage_percent: int = 0):
        """Two-tier planning coverage: remote blocks take precedence,
        then chunks the remote cannot supply are completed from the
        LOCAL cache (reference
        lib/cacheblockstore/longtail_cacheblockstore.c:671-760) — a
        populated local tier contributes blocks the remote lacks, and
        an offline remote degrades to local-only planning instead of
        killing the downsync."""
        from longtail_jax.core.store_algebra import merge_store_index

        self.stats.bump("get_existing_content_count")
        chunk_hashes = np.asarray(chunk_hashes, dtype=np.uint64)
        try:
            remote_idx = self.remote.get_existing_content(
                chunk_hashes, min_block_usage_percent)
        except Exception:
            return self.local.get_existing_content(
                chunk_hashes, min_block_usage_percent)
        covered = np.isin(chunk_hashes,
                          np.asarray(remote_idx.chunk_hashes,
                                     dtype=np.uint64))
        missing = chunk_hashes[~covered]
        if len(missing) == 0:
            return remote_idx
        try:
            local_idx = self.local.get_existing_content(missing, 0)
        except Exception:
            return remote_idx
        if local_idx.block_count == 0:
            return remote_idx
        # remote precedence for blocks present in both tiers
        return merge_store_index(remote_idx, local_idx)

    def prune_blocks(self, keep_block_hashes) -> int:
        return self.remote.prune_blocks(keep_block_hashes)

    def flush(self) -> None:
        for fut in self._pending:
            try:
                fut.result()
            except Exception:
                pass  # cache write-back failures are non-fatal
        self._pending = []
        self.local.flush()
        self.remote.flush()
        self.stats.bump("flush_count")
