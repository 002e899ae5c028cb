"""End-to-end upsync/downsync round-trips (mirrors the reference e2e tests
test/test.cpp AsyncBlockStore :4149 and version round-trip cases): write a
version into a store, reconstruct bit-exact, then incremental delta sync."""

import numpy as np
import pytest

from longtail_jax import api
from longtail_jax.core import store_algebra
from longtail_jax.formats import constants as C
from longtail_jax.stores.compressblockstore import CompressBlockStore
from longtail_jax.stores.fsblockstore import FSBlockStore
from longtail_jax.stores.storage import FSStorage, MemStorage


def make_source(storage, root: str, rng) -> dict[str, bytes]:
    files = {
        "readme.txt": b"hello longtail\n" * 10,
        "bin/a.dat": rng.integers(0, 256, 100_000, dtype=np.uint8).tobytes(),
        "bin/b.dat": rng.integers(0, 4, 150_000, dtype=np.uint8).tobytes(),
        "bin/sub/c.bin": rng.integers(0, 256, 1_000, dtype=np.uint8).tobytes(),
        "empty.txt": b"",
        "strange/€.txt": "euro € file".encode("utf-8"),
    }
    for path, data in files.items():
        parts = path.split("/")
        for d in range(1, len(parts)):
            p = f"{root}/" + "/".join(parts[:d])
            if not storage.is_dir(p):
                storage.create_dir(p)
        storage.write(f"{root}/{path}", data)
    return files


def read_tree(storage, root: str) -> dict[str, bytes]:
    from longtail_jax.stores.storage import walk_files
    out = {}
    for path, size, _perm in walk_files(storage, root):
        if not path.endswith("/"):
            out[path] = storage.read(f"{root}/{path}")
    return out


@pytest.mark.parametrize("compression", [
    C.COMPRESSION_TYPE_NONE, C.COMPRESSION_TYPE_LZ4_DEFAULT])
def test_upsync_downsync_roundtrip_mem(compression):
    rng = np.random.default_rng(11)
    storage = MemStorage()
    storage.create_dir("src")
    files = make_source(storage, "src", rng)

    store = CompressBlockStore(FSBlockStore(storage, "store"))
    vi, vsi = api.upsync(storage, "src", store, target_chunk_size=2048,
                         compression_tag=compression, workers=2)
    assert vi.asset_count == len(files) + 3  # + bin/, bin/sub/, strange/
    assert vsi.chunk_count >= vi.chunk_count

    api.downsync(store, storage, "dst", vi, workers=2)
    got = read_tree(storage, "dst")
    assert got == files

    # store index validates against the version
    result = api.validate_version(store, vi)
    assert result.ok


def test_incremental_sync_only_fetches_missing(tmp_path):
    rng = np.random.default_rng(5)
    storage = FSStorage(str(tmp_path))
    storage.create_dir("src")
    files = make_source(storage, "src", rng)

    fs_store = FSBlockStore(storage, "store")
    store = CompressBlockStore(fs_store)
    vi1, _ = api.upsync(storage, "src", store, target_chunk_size=2048,
                        workers=1)
    api.downsync(store, storage, "dst", vi1, workers=1)
    assert read_tree(storage, "dst") == files

    # mutate the source: change one file, add one, remove one
    storage.write("src/readme.txt", b"changed content!\n" * 4)
    storage.write("src/bin/new.bin",
                  rng.integers(0, 256, 5_000, dtype=np.uint8).tobytes())
    storage.remove_file("src/empty.txt")
    files2 = read_tree(storage, "src")

    vi2, _ = api.upsync(storage, "src", store, target_chunk_size=2048,
                        workers=1)
    gets_before = fs_store.get_stats().get_stored_block_count
    api.downsync(store, storage, "dst", vi2, workers=1)
    gets = fs_store.get_stats().get_stored_block_count - gets_before
    assert read_tree(storage, "dst") == files2
    # incremental: only blocks for changed/new content are fetched
    total_blocks = fs_store.get_existing_content(vi2.chunk_hashes).block_count
    assert 0 < gets < total_blocks


def test_downsync_into_dirty_target():
    rng = np.random.default_rng(9)
    storage = MemStorage()
    storage.create_dir("src")
    files = make_source(storage, "src", rng)
    store = CompressBlockStore(FSBlockStore(storage, "store"))
    vi, _ = api.upsync(storage, "src", store, target_chunk_size=2048, workers=1)

    # target contains stale junk that must be removed/overwritten
    storage.create_dir("dst")
    storage.write("dst/stale.bin", b"junk" * 100)
    storage.create_dir("dst/bin")
    storage.write("dst/bin/a.dat", b"old")
    api.downsync(store, storage, "dst", vi, workers=1)
    assert read_tree(storage, "dst") == files


def test_store_index_persist_and_rescan():
    rng = np.random.default_rng(2)
    storage = MemStorage()
    storage.create_dir("src")
    make_source(storage, "src", rng)
    store = FSBlockStore(storage, "store")
    vi, _ = api.upsync(storage, "src", store, target_chunk_size=2048,
                       compression_tag=0, workers=1)
    assert storage.exists("store/store.lsi")

    # fresh store object reads the .lsi
    store2 = FSBlockStore(storage, "store")
    idx = store2.get_existing_content(vi.chunk_hashes)
    assert store_algebra.validate_store(idx, vi).ok

    # delete the .lsi: index must rebuild by scanning .lrb block files
    storage.remove_file("store/store.lsi")
    store3 = FSBlockStore(storage, "store")
    idx3 = store3.get_existing_content(vi.chunk_hashes)
    assert store_algebra.validate_store(idx3, vi).ok


def test_validate_missing_content():
    storage = MemStorage()
    storage.create_dir("src")
    storage.write("src/a.bin", b"some data here")
    store = FSBlockStore(storage, "store")
    vi, _ = api.upsync(storage, "src", store, compression_tag=0, workers=1)
    # nuke the block files -> validation must fail
    for sub in storage.list_dir("store/chunks"):
        for name in storage.list_dir(f"store/chunks/{sub}"):
            storage.remove_file(f"store/chunks/{sub}/{name}")
    storage.remove_file("store/store.lsi")
    store2 = FSBlockStore(storage, "store")
    result = api.validate_version(store2, vi)
    assert not result.ok
    assert len(result.missing_chunk_hashes) > 0
