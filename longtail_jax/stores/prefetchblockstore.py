"""Prefetching block-store wrapper: makes ``preflight_get`` a real
read-ahead pipeline.

The reference overlaps block fetch with decompress/scatter through
channel-1 block-reader jobs capped at 32 in flight
(src/longtail.c:5169, MAX_BLOCKS_PER_PARTIAL_ASSET_WRITE :4997,
GetMaxParallelBlockReadJobs :5026); ``PreflightGet`` is the hint that
starts them (src/longtail.h:789-799).  This wrapper is the composable
form: on preflight it starts bounded background fetches through the
backing store; ``get_stored_block`` consumes the prefetched result (or
falls through).  The residency bound caps peak memory at
``max_resident`` undelivered blocks — the analog of the reference's
in-flight cap, and the lever behind its 0.4.1 peak-memory fix
(CHANGELOG.md:73-76).

The bound is enforced by capping SUBMITTED-undelivered futures (each
delivery submits the next pending hash), never by blocking a worker on
a semaphore: with workers parked on permits, a permit released by the
consumer can be barged by a later task (CPython semaphores are not
FIFO under contention), and once every permit is held by done-but-
undelivered later blocks the earliest block can never fetch — a real
deadlock this module shipped with until a suite run wedged on it.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np

from longtail_jax.formats.store_index import StoreIndex, StoredBlock
from longtail_jax.stores.blockstore import BlockStoreBase


class PrefetchBlockStore(BlockStoreBase):
    def __init__(self, backing, workers: int = 4, max_resident: int = 32):
        super().__init__()
        self.backing = backing
        self._pool = ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="block-prefetch")
        self._max_resident = max_resident
        self._lock = threading.Lock()
        self._futures: OrderedDict[int, Future] = OrderedDict()
        self._pending: OrderedDict[int, None] = OrderedDict()

    def _submit_next_locked(self) -> None:
        while self._pending and len(self._futures) < self._max_resident:
            h, _ = self._pending.popitem(last=False)
            self._futures[h] = self._pool.submit(
                self.backing.get_stored_block, h)

    def preflight_get(self, block_hashes) -> None:
        self.stats.bump("preflight_count")
        with self._lock:
            for h in np.asarray(block_hashes, dtype=np.uint64):
                h = int(h)
                if h not in self._futures and h not in self._pending:
                    self._pending[h] = None
            self._submit_next_locked()

    def get_stored_block(self, block_hash: int) -> StoredBlock:
        h = int(block_hash)
        with self._lock:
            fut = self._futures.pop(h, None)
            if fut is None:
                # not in flight: a queued-but-unsubmitted prefetch (or
                # never preflighted) fetches directly
                self._pending.pop(h, None)
            else:
                self._submit_next_locked()   # a residency slot freed
        if fut is None:
            return self.backing.get_stored_block(h)
        block = fut.result()
        self.stats.bump("get_stored_block_count")
        return block

    def cancel_prefetch(self) -> None:
        """Drop undelivered prefetches (releasing their memory bound)."""
        with self._lock:
            futures = list(self._futures.values())
            self._futures.clear()
            self._pending.clear()
        for fut in futures:
            if not fut.cancel():
                try:
                    fut.result()
                except BaseException:
                    pass

    # -- forwards ----------------------------------------------------------

    def put_stored_block(self, stored_block: StoredBlock) -> None:
        self.backing.put_stored_block(stored_block)

    def get_existing_content(self, chunk_hashes: np.ndarray,
                             min_block_usage_percent: int = 0) -> StoreIndex:
        return self.backing.get_existing_content(
            chunk_hashes, min_block_usage_percent)

    def prune_blocks(self, keep_block_hashes) -> int:
        return self.backing.prune_blocks(keep_block_hashes)

    def flush(self) -> None:
        self.cancel_prefetch()
        self.backing.flush()
