"""Parallel folder scan: same entries + order as the sequential walk.

Reference: Longtail_GetFilesRecursively2 fans one ScanFolder job per
directory (src/longtail.c:1656-1790).
"""

import numpy as np

from longtail_jax.core.indexing import get_files_recursively
from longtail_jax.stores.storage import (
    FSStorage,
    MemStorage,
    walk_files,
    walk_files_parallel,
)


def _make_tree(tmp_path, depth=3, fanout=3, files=4):
    rng = np.random.default_rng(11)

    def fill(d, level):
        for i in range(files):
            (d / f"f{i}.bin").write_bytes(
                rng.integers(0, 256, int(rng.integers(0, 5000)),
                             dtype=np.uint8).tobytes())
        if level < depth:
            for i in range(fanout):
                sub = d / f"dir{i}"
                sub.mkdir()
                fill(sub, level + 1)

    root = tmp_path / "tree"
    root.mkdir()
    fill(root, 0)
    (root / "dir0" / "weird €.txt").write_bytes(b"unicode name")
    return root


def test_parallel_matches_sequential_fs(tmp_path):
    root = str(_make_tree(tmp_path))
    st = FSStorage()
    seq = list(walk_files(st, root))
    par = walk_files_parallel(st, root, workers=8)
    assert par == seq
    assert len(seq) > 50


def test_parallel_matches_sequential_mem():
    st = MemStorage()
    st.create_dir("a")
    st.create_dir("a/b")
    st.write("a/x.bin", b"12345")
    st.write("a/b/y.bin", b"x" * 100)
    st.write("top.bin", b"t")
    assert walk_files_parallel(st, "", workers=4) == list(walk_files(st, ""))


def test_path_filter_applies(tmp_path):
    root = str(_make_tree(tmp_path, depth=1))
    st = FSStorage()
    flt = lambda p: not p.startswith("dir1")
    seq = list(walk_files(st, root, flt))
    par = walk_files_parallel(st, root, flt, workers=8)
    assert par == seq
    assert not any(p.startswith("dir1") for p, _, _ in par)


def test_get_files_recursively_workers(tmp_path):
    root = str(_make_tree(tmp_path))
    st = FSStorage()
    a = get_files_recursively(st, root, workers=1)
    b = get_files_recursively(st, root, workers=8)
    assert a.paths == b.paths
    assert (a.sizes == b.sizes).all()
    assert (a.permissions == b.permissions).all()


def test_map_file_fs_and_mem(tmp_path):
    """map_file returns a zero-copy read-only view on both storages."""
    import numpy as np

    from longtail_jax.stores.storage import (
        FSStorage,
        MemStorage,
        map_or_read,
    )

    payload = bytes(range(256)) * 100
    fs = FSStorage(str(tmp_path))
    fs.write("f.bin", payload)
    with fs.map_file("f.bin") as mf:
        assert bytes(mf.view[300:400]) == payload[300:400]
        arr = np.frombuffer(mf.view[0:16], np.uint8)
        assert arr.tolist() == list(range(16))
    ms = MemStorage()
    ms.write("m.bin", payload)
    with ms.map_file("m.bin") as mf:
        assert bytes(mf.view[:10]) == payload[:10]
        assert mf.view.readonly
    # map_or_read falls back to a read()-backed view for foreign storages
    class Minimal:
        def read(self, path, offset=0, size=None):
            return payload
    with map_or_read(Minimal(), "x") as mf:
        assert bytes(mf.view[:4]) == payload[:4]
    # empty file maps to an empty view
    fs.write("empty", b"")
    with fs.map_file("empty") as mf:
        assert len(mf.view) == 0
