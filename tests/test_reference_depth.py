"""Reference test-suite depth: behaviors the reference pins that a green
happy-path suite can miss — case-colliding paths (test/test.cpp:8126),
out-of-order / sparse writes on fresh files (:8213), and a >= 4 GiB
single-asset round-trip (:8349-8369, gated: LT_TESTS_LARGE=1)."""

import hashlib
import os
import tempfile

import numpy as np
import pytest

from longtail_jax import api
from longtail_jax.stores.fsblockstore import FSBlockStore
from longtail_jax.stores.storage import (
    FSStorage,
    MemStorage,
    ensure_parent_dirs,
)

from test_roundtrip import read_tree


def test_case_collision_paths():
    """lowercase.txt and UPPERCASE.txt are distinct assets on the
    (case-sensitive) storage; reconstructing over a target that holds
    the OPPOSITE-case variants replaces them exactly
    (test/test.cpp Longtail_CaseSensitivePaths :8126)."""
    st = MemStorage()
    files = {
        "local1/lowercase.txt": b"This is the first test string which is "
                                b"fairly long and should - reconstructed "
                                b"properly, than you very much",
        "local1/UPPERCASE.txt": b"Short string",
    }
    st.create_dir("src")
    for p, data in files.items():
        ensure_parent_dirs(st, f"src/{p}")
        st.write(f"src/{p}", data)

    store = FSBlockStore(st, "store")
    vi, _ = api.upsync(st, "src", store, target_chunk_size=1024, workers=2)

    # target pre-populated with case-flipped names and other content
    st.create_dir("dst")
    ensure_parent_dirs(st, "dst/local1/LOWERCASE.txt")
    st.write("dst/local1/LOWERCASE.txt", b"other content A")
    st.write("dst/local1/uppercase.txt", b"other content B")

    api.downsync(store, st, "dst", vi, workers=2)
    got = read_tree(st, "dst")
    assert got == files, "case-colliding names not reconstructed exactly"


@pytest.mark.parametrize("make_storage", [
    MemStorage, lambda: FSStorage(tempfile.mkdtemp(prefix="lt_ooo_"))],
    ids=["mem", "fs"])
def test_out_of_order_and_sparse_writes(make_storage):
    """Writing the SECOND half of a fresh file first (at an offset on a
    nonexistent file), then the first half, must produce the full
    content — and the fake (MemStorage) must agree with the real
    filesystem (test/test.cpp Longtail_OutOfOrderWrites :8213)."""
    st = make_storage()
    n = 2048
    second = bytes([255]) * (n // 2)
    first = bytes([127]) * (n // 2)

    st.write("ooo.bin", second, offset=n // 2)   # file does not exist yet
    # positional write preserving the existing tail (offset-0 write is
    # whole-file replace by contract; write_ranges is the scatter path)
    st.write_ranges("ooo.bin", n, [(0, first)])
    got = st.read("ooo.bin")
    assert got == first + second
    assert st.get_size("ooo.bin") == n
    # a 1-byte positional write must NOT truncate what follows
    st.write("ooo.bin", b"\x01", offset=1)
    assert st.get_size("ooo.bin") == n
    assert st.read("ooo.bin")[2:] == (first + second)[2:]
    # offset-0 write IS whole-file replace, on both implementations
    st.write("ooo.bin", b"xy")
    assert st.read("ooo.bin") == b"xy"

    # sparse + out-of-order through the scatter-write API: unwritten
    # gaps read back as zeros, ranges land regardless of order
    ranges = [(1500, b"BB"), (0, b"AA"), (700, b"CC")]
    st.write_ranges("sparse.bin", 2000, ranges)
    data = st.read("sparse.bin")
    assert len(data) == 2000
    assert data[0:2] == b"AA" and data[700:702] == b"CC" \
        and data[1500:1502] == b"BB"
    assert data[2:700] == bytes(698) and data[1502:2000] == bytes(498)


@pytest.mark.skipif(not os.environ.get("LT_TESTS_LARGE"),
                    reason="4 GiB disk/time; set LT_TESTS_LARGE=1")
def test_large_single_asset_roundtrip():
    """A single > 4 GiB asset survives upsync + downsync bit-exact —
    pins 64-bit size/offset handling end to end (the reference pins the
    platform layer at 4 GiB, test/test.cpp:8349-8369; here the whole
    pipeline is exercised)."""
    import shutil

    base = tempfile.mkdtemp(prefix="lt_large_")
    try:
        st = FSStorage(base)
        os.makedirs(os.path.join(base, "src"))
        path = os.path.join(base, "src", "huge.bin")
        size = (4 << 30) + 4097
        # patterned content: 1 MiB tile with the offset mixed in, so
        # any misplaced span changes the digest
        tile = np.arange(1 << 18, dtype=np.uint32)
        want = hashlib.sha256()
        with open(path, "wb") as f:
            off = 0
            while off < size:
                block = ((tile + np.uint32(off >> 20)) ^ np.uint32(0xA5))
                chunk = block.tobytes()[: min(1 << 20, size - off)]
                f.write(chunk)
                want.update(chunk)
                off += len(chunk)

        from longtail_jax.formats import constants as C
        store = FSBlockStore(st, "store")
        vi, _ = api.upsync(st, "src", store, workers=4,
                           compression_tag=C.COMPRESSION_TYPE_NONE)
        assert int(vi.asset_sizes.max()) == size
        api.downsync(store, st, "dst", vi, workers=4)

        got = hashlib.sha256()
        with open(os.path.join(base, "dst", "huge.bin"), "rb") as f:
            while True:
                b = f.read(1 << 22)
                if not b:
                    break
                got.update(b)
        assert got.hexdigest() == want.hexdigest()
    finally:
        shutil.rmtree(base, ignore_errors=True)


def test_memstorage_rename_posix_semantics():
    """MemStorage is the primary e2e fake: rename must move directory
    children, refuse to clobber a non-empty directory, and replace
    files like POSIX rename (VERDICT r4 weak #5)."""
    st = MemStorage()
    st.create_dir("d")
    st.create_dir("d/sub")
    st.write("d/a.txt", b"a")
    st.write("d/sub/b.txt", b"b")

    st.rename("d", "e")
    assert st.read("e/a.txt") == b"a"
    assert st.read("e/sub/b.txt") == b"b"
    assert not st.is_dir("d")

    # file replaces file
    st.write("x", b"1")
    st.write("y", b"2")
    st.rename("x", "y")
    assert st.read("y") == b"1"

    # file may not replace a dir; dir may not replace a non-empty dir
    st.write("f", b"f")
    with pytest.raises(Exception):
        st.rename("f", "e")
    st.create_dir("g")
    with pytest.raises(Exception):
        st.rename("g", "e")
    # dir replaces an empty dir
    st.create_dir("empty")
    st.rename("g", "empty")
    assert st.is_dir("empty") and not st.is_dir("g")
