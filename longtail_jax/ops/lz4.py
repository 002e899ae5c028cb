"""LZ4 block-format codec.

The interchange format is the public LZ4 block format (the reference wraps
upstream lz4 with type tag 'lz42', lib/lz4/longtail_lz4.c:10).  Fast path is
our native C implementation (longtail_jax/native/lz4_block.c); this module
also carries an independently written pure-Python codec used as the
conformance oracle and as fallback when no compiler is available.
"""

from __future__ import annotations

import ctypes

from longtail_jax import native

_MINMATCH = 4
_MFLIMIT = 12
_LASTLITERALS = 5
_MAX_DISTANCE = 65535


def compress_bound(n: int) -> int:
    return n + n // 255 + 16


# ---------------------------------------------------------------------------
# pure-Python reference codec (spec oracle / fallback)
# ---------------------------------------------------------------------------

def _py_compress(src: bytes) -> bytes:
    n = len(src)
    out = bytearray()
    anchor = 0
    table: dict[bytes, int] = {}
    ip = 0
    match_limit = n - _MFLIMIT if n >= _MFLIMIT else 0
    skip = 0

    def emit_literals(start: int, end: int, token_match: int) -> None:
        lit = end - start
        if lit >= 15:
            out.append((15 << 4) | token_match)
            rest = lit - 15
            while rest >= 255:
                out.append(255)
                rest -= 255
            out.append(rest)
        else:
            out.append((lit << 4) | token_match)

    if n >= _MINMATCH + _LASTLITERALS:
        while ip < match_limit:
            key = src[ip:ip + 4]
            cand = table.get(key)
            table[key] = ip
            if cand is None or ip - cand > _MAX_DISTANCE:
                ip += 1 + (skip >> 6)
                skip += 1
                continue
            skip = 0
            match = cand
            # extend backwards
            while ip > anchor and match > 0 and src[ip - 1] == src[match - 1]:
                ip -= 1
                match -= 1
            # extend forwards
            fwd_limit = n - _LASTLITERALS
            mlen = _MINMATCH
            while ip + mlen < fwd_limit and src[ip + mlen] == src[match + mlen]:
                mlen += 1
            mlen_code = mlen - _MINMATCH
            token_match = 15 if mlen_code >= 15 else mlen_code
            emit_literals(anchor, ip, token_match)
            out += src[anchor:ip]
            offset = ip - match
            out.append(offset & 0xFF)
            out.append(offset >> 8)
            if mlen_code >= 15:
                rest = mlen_code - 15
                while rest >= 255:
                    out.append(255)
                    rest -= 255
                out.append(rest)
            ip += mlen
            anchor = ip
    emit_literals(anchor, n, 0)
    out += src[anchor:]
    return bytes(out)


def _py_decompress(src: bytes, dst_size: int) -> bytes:
    out = bytearray()
    ip = 0
    n = len(src)
    while ip < n:
        token = src[ip]
        ip += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = src[ip]
                ip += 1
                lit += b
                if b != 255:
                    break
        out += src[ip:ip + lit]
        ip += lit
        if ip >= n:
            break
        offset = src[ip] | (src[ip + 1] << 8)
        ip += 2
        if offset == 0 or offset > len(out):
            raise ValueError("lz4: bad offset")
        mlen = (token & 15) + _MINMATCH
        if (token & 15) == 15:
            while True:
                b = src[ip]
                ip += 1
                mlen += b
                if b != 255:
                    break
        start = len(out) - offset
        for i in range(mlen):  # overlapping copies must be byte-forward
            out.append(out[start + i])
    if len(out) != dst_size:
        raise ValueError(f"lz4: decompressed {len(out)} != expected {dst_size}")
    return bytes(out)


# ---------------------------------------------------------------------------
# native fast path
# ---------------------------------------------------------------------------

_lib = None
_lib_checked = False


def _native():
    global _lib, _lib_checked
    if not _lib_checked:
        _lib_checked = True
        lib = native.load("lz4_block")
        if lib is not None:
            lib.lt_lz4_compress.restype = ctypes.c_long
            lib.lt_lz4_compress.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.c_void_p, ctypes.c_size_t]
            lib.lt_lz4_decompress.restype = ctypes.c_long
            lib.lt_lz4_decompress.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_void_p, ctypes.c_size_t]
        _lib = lib
    return _lib


def compress(src: bytes) -> bytes:
    import numpy as np

    lib = _native()
    if lib is None:
        return _py_compress(src)
    cap = compress_bound(len(src))
    # np.empty, not create_string_buffer: the latter memsets its whole
    # allocation — a full extra pass per block on the codec hot path
    dst = np.empty(cap, np.uint8)
    r = lib.lt_lz4_compress(src, len(src), dst.ctypes.data, cap)
    if r < 0:
        raise ValueError("lz4: compression overflow")
    return dst[:r].tobytes()


def decompress_into(src, dst) -> int:
    """Decompress a bytes-like ``src`` (bytes / memoryview / ndarray —
    no copy) into a caller-provided writable uint8 ndarray sized to the
    exact raw length; returns that length.  Skips the memset + copy-out
    of the bytes API (the downsync decode hot path)."""
    import numpy as np

    lib = _native()
    n = len(dst)
    if lib is None:
        out = _py_decompress(bytes(src), n)
        dst[:] = np.frombuffer(out, np.uint8)
        return n
    if not isinstance(src, bytes):
        src = np.frombuffer(src, np.uint8)
        sp, sn = src.ctypes.data, len(src)
    else:
        sp, sn = src, len(src)
    r = lib.lt_lz4_decompress(sp, sn, dst.ctypes.data, n)
    if r != n:
        raise ValueError(f"lz4: decompressed {r} != expected {n}")
    return n


def decompress(src: bytes, dst_size: int) -> bytes:
    import numpy as np

    lib = _native()
    if lib is None:
        return _py_decompress(src, dst_size)
    dst = np.empty(max(dst_size, 1), np.uint8)
    decompress_into(src, dst[:dst_size])
    return dst[:dst_size].tobytes()


# ---------------------------------------------------------------------------
# match-list assembler (the host half of the device codec,
# parallel/device_lz4.py; native/lz4_assemble.c is the fast path)
# ---------------------------------------------------------------------------

_asm_lib = None
_asm_checked = False


def _native_asm():
    global _asm_lib, _asm_checked
    if not _asm_checked:
        _asm_checked = True
        lib = native.load("lz4_assemble")
        if lib is not None:
            lib.lt_lz4_assemble.restype = ctypes.c_long
            lib.lt_lz4_assemble.argtypes = [
                ctypes.c_char_p, ctypes.c_long,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_long, ctypes.c_char_p, ctypes.c_long]
        _asm_lib = lib
    return _asm_lib


def _py_assemble(src: bytes, starts, refs, lens) -> bytes:
    """Pure-Python mirror of native/lz4_assemble.c."""
    n = len(src)
    out = bytearray()
    anchor = 0
    limit = n - _LASTLITERALS
    mstart_limit = n - _MFLIMIT

    def emit_len(rest: int) -> None:
        rest -= 15
        while rest >= 255:
            out.append(255)
            rest -= 255
        out.append(rest)

    for s, r, ln in zip(starts, refs, lens):
        s, r, ln = int(s), int(r), int(ln)
        if s < anchor:
            d = anchor - s
            s += d
            r += d
            ln -= d
        ln = min(ln, limit - s)
        if ln < _MINMATCH or s >= mstart_limit or r < 0 or r >= s or \
                s - r > _MAX_DISTANCE:
            continue
        lit = s - anchor
        mcode = ln - _MINMATCH
        out.append((min(lit, 15) << 4) | min(mcode, 15))
        if lit >= 15:
            emit_len(lit)
        out += src[anchor:s]
        off = s - r
        out.append(off & 0xFF)
        out.append(off >> 8)
        if mcode >= 15:
            emit_len(mcode)
        anchor = s + ln
    lit = n - anchor
    out.append(min(lit, 15) << 4)
    if lit >= 15:
        emit_len(lit)
    out += src[anchor:]
    return bytes(out)


def assemble_matches(src: bytes, starts, refs, lens) -> bytes:
    """Serialize a position-sorted match list into the LZ4 block format.

    Overlapping / out-of-bounds matches are trimmed or skipped, so any
    list yields a valid stream (worst case all-literals)."""
    import numpy as np

    lib = _native_asm()
    if lib is None:
        return _py_assemble(src, starts, refs, lens)
    st = np.ascontiguousarray(starts, dtype=np.int32)
    rf = np.ascontiguousarray(refs, dtype=np.int32)
    ln = np.ascontiguousarray(lens, dtype=np.int32)
    cap = compress_bound(len(src))
    dst = ctypes.create_string_buffer(cap)
    r = lib.lt_lz4_assemble(
        src, len(src),
        st.ctypes.data, rf.ctypes.data, ln.ctypes.data, len(st), dst, cap)
    if r < 0:
        raise ValueError("lz4 assemble: overflow")
    return dst.raw[:r]


# ---------------------------------------------------------------------------
# anchor assembler (the host half of the batched device codec,
# parallel/device_match.py; native/lz4_anchors.c is the fast path)
# ---------------------------------------------------------------------------

_anch_lib = None
_anch_checked = False


def _native_anchors():
    global _anch_lib, _anch_checked
    if not _anch_checked:
        _anch_checked = True
        lib = native.load("lz4_anchors")
        if lib is not None:
            lib.lt_lz4_assemble_anchors.restype = ctypes.c_long
            lib.lt_lz4_assemble_anchors.argtypes = [
                ctypes.c_char_p, ctypes.c_long,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
                ctypes.c_void_p, ctypes.c_long]
        _anch_lib = lib
    return _anch_lib


def _py_assemble_anchors(src: bytes, apos, aref) -> bytes:
    """Pure-Python mirror of native/lz4_anchors.c: memcmp-validate and
    byte-extend each (pos, ref) hint, emit the LZ4 stream."""
    n = len(src)
    out = bytearray()
    anchor = 0
    mflimit = n - _MFLIMIT
    mlimit = n - _LASTLITERALS

    def emit_len(rest: int) -> None:
        rest -= 15
        while rest >= 255:
            out.append(255)
            rest -= 255
        out.append(rest)

    for p, r in zip(apos, aref):
        p, r = int(p), int(r)
        if r < 0 or r >= p or p - r > _MAX_DISTANCE:
            continue
        off = p - r
        # anchors inside the previous match are covered by it (snapping
        # + re-scanning would be quadratic on dense runs)
        if p < anchor or p >= mflimit:
            continue
        while p > anchor and r > 0 and src[p - 1] == src[r - 1]:
            p -= 1
            r -= 1
        lim = mlimit - p
        ln = 0
        while ln < lim and src[p + ln] == src[r + ln]:
            ln += 1
        if ln < _MINMATCH:
            continue
        lit = p - anchor
        mcode = ln - _MINMATCH
        out.append((min(lit, 15) << 4) | min(mcode, 15))
        if lit >= 15:
            emit_len(lit)
        out += src[anchor:p]
        out.append(off & 0xFF)
        out.append(off >> 8)
        if mcode >= 15:
            emit_len(mcode)
        anchor = p + ln
    lit = n - anchor
    out.append(min(lit, 15) << 4)
    if lit >= 15:
        emit_len(lit)
    out += src[anchor:]
    return bytes(out)


def assemble_anchors_into(src: bytes, apos, aref, dst) -> int:
    """assemble_anchors into a caller-provided writable uint8 ndarray of
    >= compress_bound(len(src)) bytes; returns the compressed length.
    Saves two full-buffer passes per block vs the bytes-returning entry
    (ctypes.create_string_buffer memsets its allocation, and .raw[:r]
    copies again) — on an 8 MiB block that is the difference between
    ~2 and ~5 GB/s of assembly."""
    import numpy as np

    lib = _native_anchors()
    if lib is None:
        out = _py_assemble_anchors(src, apos, aref)
        dst[:len(out)] = np.frombuffer(out, np.uint8)
        return len(out)
    ap = np.ascontiguousarray(apos, dtype=np.int64)
    ar = np.ascontiguousarray(aref, dtype=np.int64)
    r = lib.lt_lz4_assemble_anchors(
        src, len(src), ap.ctypes.data, ar.ctypes.data, len(ap),
        dst.ctypes.data, len(dst))
    if r < 0:
        raise ValueError("lz4 anchors: overflow")
    return int(r)


def assemble_anchors(src: bytes, apos, aref) -> bytes:
    """Serialize position-sorted device (pos, ref) anchor hints into the
    LZ4 block format.  Anchors are validated by memcmp and byte-extended
    in both directions, so any hint list yields a correct stream."""
    import numpy as np

    lib = _native_anchors()
    if lib is None:
        return _py_assemble_anchors(src, apos, aref)
    dst = np.empty(compress_bound(len(src)), np.uint8)
    r = assemble_anchors_into(src, apos, aref, dst)
    return dst[:r].tobytes()
