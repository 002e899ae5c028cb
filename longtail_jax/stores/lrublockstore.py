"""LRU wrapper (lib/lrublockstore/longtail_lrublockstore.c): caches the most
recently fetched blocks in memory.  Obsolete for the block-centric
change_version path (CHANGELOG 0.4.1 note) but kept for API parity and for
random-access readers (blockstorestorage)."""

from __future__ import annotations

import collections
import threading

from longtail_jax.stores.blockstore import BlockStoreBase


class LRUBlockStore(BlockStoreBase):
    def __init__(self, backing, max_count: int = 32):
        super().__init__()
        self.backing = backing
        self.max_count = max_count
        self._lock = threading.Lock()
        self._cache: collections.OrderedDict = collections.OrderedDict()

    def get_stored_block(self, block_hash: int):
        key = int(block_hash)
        with self._lock:
            if key in self._cache:
                self._cache.move_to_end(key)
                self.stats.bump("get_stored_block_count")
                return self._cache[key]
        block = self.backing.get_stored_block(key)
        with self._lock:
            self._cache[key] = block
            self._cache.move_to_end(key)
            while len(self._cache) > self.max_count:
                self._cache.popitem(last=False)
        self.stats.bump("get_stored_block_count")
        return block

    def put_stored_block(self, stored_block) -> None:
        self.stats.bump("put_stored_block_count")
        self.backing.put_stored_block(stored_block)


    def get_stored_block_raw(self, block_hash: int):
        # raw fetches bypass this wrapper's caching/dedup (the downsync
        # job graph fetches each block exactly once) and reach the codec
        # layer below
        return self.backing.get_stored_block_raw(block_hash)

    def decompress_stored_block(self, stored_block):
        return self.backing.decompress_stored_block(stored_block)

    def preflight_get(self, block_hashes) -> None:
        self.backing.preflight_get(block_hashes)

    def get_existing_content(self, chunk_hashes,
                             min_block_usage_percent: int = 0):
        self.stats.bump("get_existing_content_count")
        return self.backing.get_existing_content(
            chunk_hashes, min_block_usage_percent)

    def prune_blocks(self, keep_block_hashes) -> int:
        return self.backing.prune_blocks(keep_block_hashes)

    def flush(self) -> None:
        self.backing.flush()
        self.stats.bump("flush_count")
