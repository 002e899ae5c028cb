"""zstd codec dispatch: system libzstd fast path (the same
vendor-the-upstream choice the reference makes, lib/zstd vendors zstd
1.5.6) with the from-spec Python implementation (ops/zstd_frame.py) as
oracle and always-available fallback.

Mirrors ops/lz4.py's structure: callers get `compress`/`decompress`; the
implementation is selected once at first use by probing for libzstd.
"""

from __future__ import annotations

from longtail_jax.ops import zstd_frame

import ctypes

_native = None


class _SystemZstd:
    """Upstream libzstd bound via ctypes — the same vendor-the-upstream
    choice the reference makes (lib/zstd vendors zstd 1.5.6); exposed with
    the lt_zstd_* signature the dispatch below expects."""

    def __init__(self, lib: ctypes.CDLL):
        lib.ZSTD_compress.restype = ctypes.c_size_t
        lib.ZSTD_compress.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int]
        lib.ZSTD_decompress.restype = ctypes.c_size_t
        lib.ZSTD_decompress.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_size_t]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        self._lib = lib

    def lt_zstd_compress(self, src, n, dst, cap, level):
        r = self._lib.ZSTD_compress(dst, cap, src, n, level)
        return -1 if self._lib.ZSTD_isError(r) else r

    def lt_zstd_decompress(self, src, n, dst, raw_size):
        r = self._lib.ZSTD_decompress(dst, raw_size, src, n)
        return -1 if self._lib.ZSTD_isError(r) else r


def _load_native():
    """Bind system libzstd once; False caches a failed probe.  AttributeError
    is caught too: a library that loads but lacks the ZSTD_* symbols must
    fall through to the from-spec Python implementation."""
    global _native
    if _native is None:
        try:
            import ctypes.util
            path = ctypes.util.find_library("zstd") or "libzstd.so.1"
            _native = _SystemZstd(ctypes.CDLL(path))
        except (OSError, AttributeError):
            _native = False
    return _native or None


def compress_bound(n: int) -> int:
    # worst case: raw blocks (3-byte headers per 128 KiB) + frame header;
    # the n>>8 + 512 margin also covers upstream ZSTD_compressBound
    return n + max((n // zstd_frame.BLOCK_MAX + 1) * 3 + 16, (n >> 8) + 512)


def compress(data: bytes, level: int = 3) -> bytes:
    import numpy as np

    lib = _load_native()
    if lib is not None:
        bound = compress_bound(len(data))
        # np.empty, not create_string_buffer: the latter memsets its
        # whole allocation — a full extra pass per block on the hot path
        dst = np.empty(bound, np.uint8)
        n = lib.lt_zstd_compress(data, len(data), dst.ctypes.data,
                                 bound, level)
        if n > 0:
            return dst[:n].tobytes()
    return zstd_frame.compress(data, level)


def decompress_into(data, dst) -> int:
    """Decompress a bytes-like ``data`` (bytes / memoryview / ndarray —
    no copy) into a caller-provided writable uint8 ndarray sized to the
    exact raw length; returns that length (downsync hot path — skips
    the memset + copy-out of the bytes API)."""
    import numpy as np

    raw_size = len(dst)
    lib = _load_native()
    if lib is not None:
        if not isinstance(data, bytes):
            arr = np.frombuffer(data, np.uint8)
            sp, sn = arr.ctypes.data, len(arr)
        else:
            sp, sn = data, len(data)
        n = lib.lt_zstd_decompress(sp, sn, dst.ctypes.data, raw_size)
        if n == raw_size:
            return n
        if n >= 0:
            raise zstd_frame.ZstdError(
                f"native zstd produced {n} bytes, expected {raw_size}")
    out = zstd_frame.decompress(bytes(data), raw_size)
    dst[:] = np.frombuffer(out, np.uint8)
    return raw_size


def decompress(data: bytes, raw_size: int) -> bytes:
    import numpy as np

    lib = _load_native()
    if lib is not None:
        dst = np.empty(max(raw_size, 1), np.uint8)
        n = lib.lt_zstd_decompress(data, len(data), dst.ctypes.data,
                                   raw_size)
        if n == raw_size:
            return dst[:raw_size].tobytes()
        if n >= 0:
            raise zstd_frame.ZstdError(
                f"native zstd produced {n} bytes, expected {raw_size}")
    return zstd_frame.decompress(data, raw_size)
