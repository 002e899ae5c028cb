"""Share wrapper (lib/shareblockstore/longtail_shareblockstore.c): coalesces
concurrent get_stored_block calls for the same block so the backing store
sees one fetch (:12-35, :106-200)."""

from __future__ import annotations

import threading

from longtail_jax.stores.blockstore import BlockStoreBase


class _SharedRequest:
    """One in-flight fetch; waiters hold the request object itself (the
    analog of the reference's explicit per-hash waiter lists, :12-35), so
    the result's lifetime is exactly the waiters' — no timers, no global
    result cache."""

    __slots__ = ("event", "result", "error")

    def __init__(self):
        self.event = threading.Event()
        self.result = None
        self.error = None


class ShareBlockStore(BlockStoreBase):
    def __init__(self, backing):
        super().__init__()
        self.backing = backing
        self._lock = threading.Lock()
        self._in_flight: dict[int, _SharedRequest] = {}

    def get_stored_block(self, block_hash: int):
        key = int(block_hash)
        with self._lock:
            req = self._in_flight.get(key)
            owner = req is None
            if owner:
                req = _SharedRequest()
                self._in_flight[key] = req
        if not owner:
            req.event.wait()
            if req.error is not None:
                self.stats.bump("get_stored_block_fail_count")
                raise req.error
            self.stats.bump("get_stored_block_count")
            return req.result
        try:
            req.result = self.backing.get_stored_block(key)
        except BaseException as e:
            req.error = e
        with self._lock:
            # late arrivals after this point start their own fetch
            del self._in_flight[key]
        req.event.set()
        if req.error is not None:
            self.stats.bump("get_stored_block_fail_count")
            raise req.error
        self.stats.bump("get_stored_block_count")
        return req.result

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
