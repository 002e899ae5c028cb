"""BlockStoreStorage as a general read-only Storage view.

Reference: lib/blockstorestorage/longtail_blockstorestorage.c:1492 exposes a
complete Longtail_StorageAPI over (block store + version index); generic
consumers (GetFilesRecursively, CLI ls/cp) run over it unchanged.
"""

import numpy as np
import pytest

from longtail_jax import api
from longtail_jax.formats import constants as C
from longtail_jax.stores.blockstorestorage import BlockStoreStorage
from longtail_jax.stores.fsblockstore import FSBlockStore
from longtail_jax.stores.storage import FSStorage, walk_files


@pytest.fixture
def stored_version(tmp_path):
    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    rng = np.random.default_rng(3)
    (src / "a.bin").write_bytes(rng.integers(0, 256, 70000,
                                             dtype=np.uint8).tobytes())
    (src / "sub" / "b.txt").write_bytes(b"hello block store storage\n" * 100)
    (src / "empty").write_bytes(b"")
    store = FSBlockStore(FSStorage(), str(tmp_path / "store"))
    vi, _ = api.upsync(FSStorage(), str(src), store,
                       target_chunk_size=2048,
                       compression_tag=C.COMPRESSION_TYPE_NONE)
    return src, store, vi


def test_walk_files_over_store_view(stored_version):
    src, store, vi = stored_version
    view = BlockStoreStorage(store, vi)
    got = {p: s for p, s, _ in walk_files(view, "")}
    want = {p: s for p, s, _ in walk_files(FSStorage(), str(src))}
    assert got == want


def test_ranged_reads_match_source(stored_version):
    src, store, vi = stored_version
    view = BlockStoreStorage(store, vi)
    data = (src / "a.bin").read_bytes()
    assert view.read("a.bin") == data
    assert view.read("a.bin", offset=1000, size=5000) == data[1000:6000]
    # cross-chunk tail read
    assert view.read("a.bin", offset=len(data) - 333) == data[-333:]
    assert view.read("sub/b.txt") == (src / "sub" / "b.txt").read_bytes()
    assert view.read("empty") == b""


def test_protocol_surface(stored_version):
    _, store, vi = stored_version
    view = BlockStoreStorage(store, vi)
    assert view.is_dir("")
    assert view.is_dir("sub")
    assert not view.is_dir("a.bin")
    assert view.exists("sub/b.txt")
    assert not view.exists("nope")
    assert view.get_size("empty") == 0
    assert view.get_permissions("a.bin") > 0
    assert sorted(view.list_dir("")) == ["a.bin", "empty", "sub"]
    with pytest.raises(PermissionError):
        view.write("x", b"data")
    with pytest.raises(PermissionError):
        view.remove_file("a.bin")
