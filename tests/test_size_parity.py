"""Compressed-size parity vs the reference's vendored zstd (BASELINE.md
"size parity" row: compressed StoredBlock total <= reference's).

The reference compresses blocks with vendored upstream zstd 1.5.6
(lib/zstd/longtail_zstd.c:17-22).  System libzstd stands in for the
vendored copy (same upstream); when it is present, our production path
binds it, so parity is exact.  The from-spec Python encoder (the
always-there fallback, ops/zstd_frame.py) is additionally tracked against
an explicit ratio bound so regressions surface.
"""

import ctypes
import ctypes.util

import numpy as np
import pytest

from longtail_jax.ops import zstd, zstd_frame


def _libzstd():
    path = ctypes.util.find_library("zstd")
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.ZSTD_compressBound.restype = ctypes.c_size_t
        lib.ZSTD_compress.restype = ctypes.c_size_t
        lib.ZSTD_compress.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int]
        lib.ZSTD_isError.restype = ctypes.c_uint
        return lib
    except (OSError, AttributeError):
        return None


def _upstream_compress(lib, data: bytes, level: int) -> bytes:
    cap = lib.ZSTD_compressBound(len(data))
    dst = ctypes.create_string_buffer(cap)
    n = lib.ZSTD_compress(dst, cap, data, len(data), level)
    assert not lib.ZSTD_isError(n)
    return dst.raw[:n]


def _corpus_blocks():
    """Mixed-entropy corpus: compressible structure + text + noise, cut
    into reference-default 8 MiB-ish blocks (scaled down for test time)."""
    rng = np.random.default_rng(1234)
    text = (b"the quick brown fox jumps over the lazy dog; "
            b"pack my box with five dozen liquor jugs. ") * 2000
    struct = np.arange(0, 1 << 16, dtype="<u4").tobytes() * 4
    noise = rng.integers(0, 256, 1 << 18, np.uint8).tobytes()
    zeros = bytes(1 << 17)
    mixed = text + struct + zeros + noise + text[:30000]
    block = 1 << 19
    return [mixed[o:o + block] for o in range(0, len(mixed), block)]


def test_production_zstd_size_parity():
    """Production-path compressed totals <= upstream zstd's at the same
    level (the reference's vendored-codec sizes)."""
    lib = _libzstd()
    if lib is None:
        pytest.skip("system libzstd unavailable on this machine")
    blocks = _corpus_blocks()
    ours = sum(len(zstd.compress(b, 3)) for b in blocks)
    ref = sum(len(_upstream_compress(lib, b, 3)) for b in blocks)
    assert ours <= ref, (ours, ref)
    # and it round-trips
    for b in blocks[:2]:
        assert zstd.decompress(zstd.compress(b, 3), len(b)) == b


def test_fallback_encoder_ratio_tracked():
    """The from-spec Python encoder (lazy match finder + repeat offsets
    + predefined/huffman entropy) must stay within 1.05x of upstream
    zstd level 3 on the mixed corpus (measured 1.000x; the round-3
    greedy encoder's documented gap was 1.35x)."""
    lib = _libzstd()
    if lib is None:
        pytest.skip("system libzstd unavailable (no reference sizes)")
    blocks = _corpus_blocks()[:3]
    ours = sum(len(zstd_frame.compress(b, 3)) for b in blocks)
    ref = sum(len(_upstream_compress(lib, b, 3)) for b in blocks)
    assert ours <= ref * 1.05, (ours, ref, ours / ref)
    for b in blocks[:1]:
        out = zstd_frame.compress(b, 3)
        # upstream must be able to decode our stream (interop), checked
        # via our own from-spec decoder + the system library
        assert zstd_frame.decompress(out, len(b)) == b
        assert zstd.decompress(out, len(b)) == b
