"""PrefetchBlockStore: preflight_get becomes a real bounded read-ahead
(the reference's channel-1 block readers, src/longtail.c:5169, in-flight
cap :4997)."""

import threading
import time

import numpy as np
import pytest

from longtail_jax.formats.store_index import BlockIndex, StoredBlock
from longtail_jax.stores.blockstore import BlockStoreBase
from longtail_jax.stores.prefetchblockstore import PrefetchBlockStore


class SlowStore(BlockStoreBase):
    """In-memory store with injectable per-get latency + concurrency probe."""

    def __init__(self, latency=0.0):
        super().__init__()
        self.blocks = {}
        self.latency = latency
        self.inflight = 0
        self.max_inflight = 0
        self.resident_peak = 0
        self._l = threading.Lock()

    def add(self, h, payload=b"x" * 64):
        bi = BlockIndex(block_hash=h, hash_identifier=1, tag=0,
                        chunk_hashes=np.array([h], np.uint64),
                        chunk_sizes=np.array([len(payload)], np.uint32))
        self.blocks[h] = StoredBlock(block_index=bi, block_data=payload)

    def get_stored_block(self, block_hash):
        with self._l:
            self.inflight += 1
            self.max_inflight = max(self.max_inflight, self.inflight)
        time.sleep(self.latency)
        with self._l:
            self.inflight -= 1
        return self.blocks[int(block_hash)]

    def flush(self):
        pass


def test_prefetch_overlaps_fetch_latency():
    inner = SlowStore(latency=0.05)
    hashes = list(range(1, 17))
    for h in hashes:
        inner.add(h)
    store = PrefetchBlockStore(inner, workers=8)
    t0 = time.perf_counter()
    store.preflight_get(np.array(hashes, np.uint64))
    got = [store.get_stored_block(h) for h in hashes]
    dt = time.perf_counter() - t0
    assert all(g.block_index.block_hash == h for g, h in zip(got, hashes))
    # serial would be 16 * 0.05 = 0.8s; 8-way overlap should beat half that
    assert dt < 0.4, f"no overlap: {dt:.2f}s"
    assert inner.max_inflight > 1


def test_prefetch_residency_bound():
    inner = SlowStore()
    hashes = list(range(1, 101))
    for h in hashes:
        inner.add(h)
    store = PrefetchBlockStore(inner, workers=4, max_resident=8)
    store.preflight_get(np.array(hashes, np.uint64))
    time.sleep(0.2)  # let workers run to the residency cap
    # at most max_resident blocks fetched while none are being consumed
    done = sum(1 for f in store._futures.values() if f.done())
    assert done <= 8, f"{done} blocks resident, cap is 8"
    # draining still delivers everything exactly once
    for h in hashes:
        assert store.get_stored_block(h).block_index.block_hash == h


def test_unprefetched_get_falls_through():
    inner = SlowStore()
    inner.add(7)
    store = PrefetchBlockStore(inner)
    assert store.get_stored_block(7).block_index.block_hash == 7


def test_flush_cancels_undelivered():
    inner = SlowStore(latency=0.01)
    for h in range(1, 40):
        inner.add(h)
    store = PrefetchBlockStore(inner, workers=2, max_resident=4)
    store.preflight_get(np.arange(1, 40, dtype=np.uint64))
    store.flush()
    assert not store._futures
    # store still usable afterwards
    assert store.get_stored_block(5).block_index.block_hash == 5


def test_share_store_coalesces_concurrent_gets():
    """N threads fetching the same block -> one backing fetch
    (lib/shareblockstore/longtail_shareblockstore.c waiter lists)."""
    from concurrent.futures import ThreadPoolExecutor

    from longtail_jax.stores.shareblockstore import ShareBlockStore

    inner = SlowStore()
    inner.add(42)
    calls = []
    arrived = threading.Event()
    orig = inner.get_stored_block

    def counting_get(h):
        # hold the backing fetch open until every thread has joined the
        # waiter list — a latency-window race flaked under load
        calls.append(h)
        assert arrived.wait(timeout=30)
        return orig(h)

    inner.get_stored_block = counting_get
    store = ShareBlockStore(inner)
    with ThreadPoolExecutor(max_workers=16) as pool:
        futs = [pool.submit(store.get_stored_block, 42)
                for _ in range(16)]
        deadline = time.time() + 30
        while time.time() < deadline:
            with store._lock:
                req = store._in_flight.get(42)
                n = len(req.event._cond._waiters) if req else 0
            if calls and n >= 15:
                break
            time.sleep(0.002)
        arrived.set()
        results = [f.result() for f in futs]
    assert len(calls) == 1, f"backing saw {len(calls)} fetches"
    assert all(r.block_index.block_hash == 42 for r in results)
    # sequential get after completion fetches again (no stale cache)
    store.get_stored_block(42)
    assert len(calls) == 2


def test_share_store_propagates_errors_to_all_waiters():
    from concurrent.futures import ThreadPoolExecutor

    from longtail_jax.stores.shareblockstore import ShareBlockStore

    inner = SlowStore(latency=0.05)  # block 99 never added -> KeyError
    store = ShareBlockStore(inner)

    def attempt(_):
        try:
            store.get_stored_block(99)
            return None
        except KeyError as e:
            return e

    with ThreadPoolExecutor(max_workers=8) as pool:
        errors = list(pool.map(attempt, range(8)))
    assert all(isinstance(e, KeyError) for e in errors)


def test_in_order_drain_never_wedges():
    """Regression: the semaphore formulation could deadlock — a permit
    released by the consumer could be barged by a later parked task
    (CPython semaphores are not FIFO), and once all permits were held
    by done-but-undelivered later blocks the earliest block could never
    fetch.  Hammer the exact shape that wedged: in-order drain with a
    tiny residency cap and more workers than permits."""
    def drain_all():
        for _ in range(15):
            inner = SlowStore(latency=0.0005)
            hashes = list(range(1, 41))
            for h in hashes:
                inner.add(h)
            store = PrefetchBlockStore(inner, workers=4, max_resident=2)
            store.preflight_get(np.array(hashes, np.uint64))
            for h in hashes:
                assert store.get_stored_block(h).block_index.block_hash == h

    t = threading.Thread(target=drain_all, daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), "prefetch drain wedged (residency deadlock)"
