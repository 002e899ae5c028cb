"""Device-assisted zstd: device anchor scan -> entropy stage.

The reference's default codec is zstd (tag parity with
cmd/main.c:2988, tiers lib/zstd/longtail_zstd.c:11-22).
SURVEY §7.4c named the entropy stage (FSE/Huffman) the hard part of a
device zstd; this module takes the production-sound split instead of a
device entropy coder:

- **Match finding on device**: the fast-tier anchor scan
  (parallel/device_match.py) with the window opened to the whole block
  (zstd offsets are not LZ4-limited), i.e. the long-distance-matcher
  role.  This is the O(n log n) search the reference burns scalar
  hash-chain time on.
- **Sequence assembly on host**: native C walk (native/zstd_seq.c)
  memcmp-validates + byte-extends anchors into ZSTD_Sequence triples.
- **Entropy stage on host**: libzstd's ``ZSTD_compressSequences`` — the
  upstream API built exactly for external match finders — emits a
  standard zstd frame (decodable by any zstd, including our from-spec
  ops/zstd_frame decoder).

Every stage degrades gracefully: no native compiler -> Python sequence
walk; no libzstd/compressSequences -> plain host zstd compress.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from longtail_jax.ops import zstd as _zstd

_seq_lib = None
_seq_checked = False


def _native_seq():
    global _seq_lib, _seq_checked
    if not _seq_checked:
        _seq_checked = True
        from longtail_jax import native

        lib = native.load("zstd_seq")
        if lib is not None:
            lib.lt_zstd_sequences.restype = ctypes.c_long
            lib.lt_zstd_sequences.argtypes = [
                ctypes.c_char_p, ctypes.c_long,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
                ctypes.c_void_p, ctypes.c_long]
        _seq_lib = lib
    return _seq_lib


def _py_sequences(src: bytes, apos, aref, max_seq: int) -> np.ndarray:
    """Pure-Python mirror of native/zstd_seq.c."""
    n = len(src)
    out = []
    anchor = 0
    for p, r in zip(apos, aref):
        p, r = int(p), int(r)
        if r < 0 or r >= p or p < anchor or p >= n - 16:
            continue
        while p > anchor and r > 0 and src[p - 1] == src[r - 1]:
            p -= 1
            r -= 1
        lim = n - 8 - p
        ln = 0
        while ln < lim and src[p + ln] == src[r + ln]:
            ln += 1
        if ln < 4:
            continue
        out.append((p - r, p - anchor, ln, 0))
        anchor = p + ln
        if len(out) >= max_seq:
            break
    return np.asarray(out, dtype=np.uint32).reshape(-1, 4)


def sequences_from_anchors(src: bytes, apos, aref,
                           max_seq: int = 1 << 20) -> np.ndarray:
    """(n_seq, 4) u32 rows = ZSTD_Sequence {offset, litLength,
    matchLength, rep}; validated + byte-extended, rep always 0."""
    lib = _native_seq()
    ap = np.ascontiguousarray(apos, dtype=np.int64)
    ar = np.ascontiguousarray(aref, dtype=np.int64)
    if lib is None:
        return _py_sequences(src, ap, ar, max_seq)
    cap = min(max_seq, max(len(ap), 1))
    out = np.empty((cap, 4), dtype=np.uint32)
    k = lib.lt_zstd_sequences(src, len(src), ap.ctypes.data, ar.ctypes.data,
                              len(ap), out.ctypes.data, cap)
    return out[:k]


# -- libzstd advanced API (ZSTD_compressSequences) --------------------------

_ZSTD_c_compressionLevel = 100
_ZSTD_c_windowLog = 101
# zstd.h: ZSTD_c_blockDelimiters = experimentalParam11 = 1008,
# ZSTD_c_validateSequences = experimentalParam12 = 1009.  Validation is
# the safety net: an invalid sequence set must return an error (we fall
# back to the host compressor) instead of undefined behavior.
_ZSTD_c_blockDelimiters = 1008
_ZSTD_c_validateSequences = 1009

_cctx_local = threading.local()
_api = None
_api_checked = False


def _zstd_api():
    global _api, _api_checked
    if not _api_checked:
        _api_checked = True
        try:
            import ctypes.util

            p = ctypes.util.find_library("zstd")
            lib = ctypes.CDLL(p) if p else None
        except OSError:
            lib = None
        if lib is not None and hasattr(lib, "ZSTD_compressSequences"):
            lib.ZSTD_createCCtx.restype = ctypes.c_void_p
            lib.ZSTD_CCtx_setParameter.restype = ctypes.c_size_t
            lib.ZSTD_CCtx_setParameter.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            lib.ZSTD_CCtx_setPledgedSrcSize.restype = ctypes.c_size_t
            lib.ZSTD_CCtx_setPledgedSrcSize.argtypes = [
                ctypes.c_void_p, ctypes.c_ulonglong]
            lib.ZSTD_compressSequences.restype = ctypes.c_size_t
            lib.ZSTD_compressSequences.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_char_p, ctypes.c_size_t]
            lib.ZSTD_isError.restype = ctypes.c_uint
            lib.ZSTD_compressBound.restype = ctypes.c_size_t
            _api = lib
        else:
            _api = None
    return _api


def compress_sequences(src: bytes, seqs: np.ndarray,
                       level: int = 3) -> bytes | None:
    """Entropy-encode ``src`` as one standard zstd frame using
    externally-found sequences.  Returns None when libzstd (>= 1.5)
    is unavailable or rejects the sequence set."""
    lib = _zstd_api()
    if lib is None:
        return None
    cctx = getattr(_cctx_local, "cctx", None)
    if cctx is None:
        cctx = lib.ZSTD_createCCtx()
        _cctx_local.cctx = cctx
    # our anchors may reference the whole 8 MiB block — wider than
    # level 3's default window
    wlog = max(10, (max(len(src), 1024) - 1).bit_length())
    params = [(_ZSTD_c_compressionLevel, level),
              (_ZSTD_c_windowLog, min(wlog, 27)),
              (_ZSTD_c_blockDelimiters, 0),
              (_ZSTD_c_validateSequences, 1)]
    for p, v in params:
        if lib.ZSTD_isError(lib.ZSTD_CCtx_setParameter(cctx, p, v)):
            # a libzstd build that rejects validateSequences would run
            # compressSequences UNVALIDATED (documented UB on a bad
            # sequence set) — bail to the host-compress fallback instead
            return None
    lib.ZSTD_CCtx_setPledgedSrcSize(cctx, len(src))
    seqs = np.ascontiguousarray(seqs, dtype=np.uint32)
    cap = int(lib.ZSTD_compressBound(len(src)))
    # np.empty, not create_string_buffer: the latter memsets its whole
    # allocation (a full extra pass over an 8 MiB block)
    dst = np.empty(cap, np.uint8)
    r = lib.ZSTD_compressSequences(cctx, dst.ctypes.data, cap,
                                   seqs.ctypes.data, len(seqs),
                                   src, len(src))
    if lib.ZSTD_isError(r):
        return None
    return dst[:int(r)].tobytes()


def compress_block(src: bytes, level: int = 3,
                   entropy: str = "device") -> bytes:
    """Full device zstd path: device anchor scan (whole-block window) +
    native sequence walk + entropy stage.

    ``entropy`` selects the stage: "device" (default) routes literals
    through the device Huffman pack and assembles the frame from spec
    (ops/device_entropy.frame_from_sequences — no libzstd needed);
    "libzstd" uses upstream ZSTD_compressSequences.  Either way the
    output is a standard zstd frame.  Falls back to the plain host
    compressor when a stage is unavailable."""
    from longtail_jax.parallel.device_match import (
        _GPOS_BITS,
        fast_block_anchors,
    )

    n = len(src)
    # anchor word positions carry _GPOS_BITS bits (<= 16 MiB blocks): a
    # larger block would silently wrap positions — correctness survives
    # (the host walk memcmp-rejects bad anchors) but the ratio collapses,
    # so oversized blocks take the host compressor instead
    if n < (1 << 16) or n > (4 << _GPOS_BITS) or (
            entropy == "libzstd" and _zstd_api() is None):
        return _zstd.compress(src, level)
    import jax

    # pow2 size classes bound the compiled-program count (arbitrary
    # final-block sizes otherwise compile one program each)
    npad = 1 << 16
    while npad < n:
        npad *= 2
    buf = np.zeros(npad, np.uint8)
    buf[:n] = np.frombuffer(src, np.uint8)
    words = jax.device_put(np.frombuffer(buf.tobytes(), "<u4"))
    (apos, aref), = fast_block_anchors(
        words, npad // 4, max_offset_words=npad // 4,
        suppress_sampled_chains=False)
    keep = apos < n
    seqs = sequences_from_anchors(src, apos[keep], aref[keep])
    if entropy == "device":
        from longtail_jax.ops.device_entropy import frame_from_sequences

        return frame_from_sequences(src, seqs)
    out = compress_sequences(src, seqs, level)
    if out is None:
        return _zstd.compress(src, level)
    return out
