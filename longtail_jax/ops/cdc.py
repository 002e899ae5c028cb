"""HPCDC content-defined chunking, re-derived for data-parallel hardware.

The reference computes a 48-byte rolling hash sequentially and cuts when
``hash % d == d - 1`` (lib/hpcdcchunker/longtail_hpcdcchunker.c:289-306).
Key observation enabling a parallel design: the rolling hash after consuming
the byte at position ``p`` is a *pure function of the 48-byte window ending at
p*::

    H(p) = XOR_{i=0..47} rotl32(T[data[p-i]], i mod 32)

(The sequential recurrence ``h' = rotl(h,1) ^ rotl(T[out],16) ^ T[in]``
telescopes to exactly this form; the rotation of the outgoing byte's term
reaches ``rotl 48 == rotl 16 (mod 32)`` and cancels.)  Therefore "candidate"
cut positions are an absolute property of the data, independent of previous
cut decisions — phase 1 marks all candidates in parallel, and phase 2 resolves
the sequential min/max constraints with a cheap sparse walk over candidates.
The result is bit-identical to the reference chunker (see the golden-vector
test against test/testdata/chunker.input).

Terminology: a chunk covering bytes [s, e) is cut at the smallest candidate
position p in [s+min, s+max-1] (then e = p+1), else e = min(s+max, L); if
L - s <= min the final chunk takes everything.
"""

from __future__ import annotations

import numpy as np

# The published HPCDC byte-to-hash table (algorithm constant, same role as
# the BLAKE3 IV).  lib/hpcdcchunker/longtail_hpcdcchunker.c:23-88.
HASH_TABLE = np.array([
    0x458be752, 0xc10748cc, 0xfbbcdbb8, 0x6ded5b68,
    0xb10a82b5, 0x20d75648, 0xdfc5665f, 0xa8428801,
    0x7ebf5191, 0x841135c7, 0x65cc53b3, 0x280a597c,
    0x16f60255, 0xc78cbc3e, 0x294415f5, 0xb938d494,
    0xec85c4e6, 0xb7d33edc, 0xe549b544, 0xfdeda5aa,
    0x882bf287, 0x3116737c, 0x05569956, 0xe8cc1f68,
    0x0806ac5e, 0x22a14443, 0x15297e10, 0x50d090e7,
    0x4ba60f6f, 0xefd9f1a7, 0x5c5c885c, 0x82482f93,
    0x9bfd7c64, 0x0b3e7276, 0xf2688e77, 0x8fad8abc,
    0xb0509568, 0xf1ada29f, 0xa53efdfe, 0xcb2b1d00,
    0xf2a9e986, 0x6463432b, 0x95094051, 0x5a223ad2,
    0x9be8401b, 0x61e579cb, 0x1a556a14, 0x5840fdc2,
    0x9261ddf6, 0xcde002bb, 0x52432bb0, 0xbf17373e,
    0x7b7c222f, 0x2955ed16, 0x9f10ca59, 0xe840c4c9,
    0xccabd806, 0x14543f34, 0x1462417a, 0x0d4a1f9c,
    0x087ed925, 0xd7f8f24c, 0x7338c425, 0xcf86c8f5,
    0xb19165cd, 0x9891c393, 0x325384ac, 0x0308459d,
    0x86141d7e, 0xc922116a, 0xe2ffa6b6, 0x53f52aed,
    0x2cd86197, 0xf5b9f498, 0xbf319c8f, 0xe0411fae,
    0x977eb18c, 0xd8770976, 0x9833466a, 0xc674df7f,
    0x8c297d45, 0x8ca48d26, 0xc49ed8e2, 0x7344f874,
    0x556f79c7, 0x6b25eaed, 0xa03e2b42, 0xf68f66a4,
    0x8e8b09a2, 0xf2e0e62a, 0x0d3a9806, 0x9729e493,
    0x8c72b0fc, 0x160b94f6, 0x450e4d3d, 0x7a320e85,
    0xbef8f0e1, 0x21d73653, 0x4e3d977a, 0x1e7b3929,
    0x1cc6c719, 0xbe478d53, 0x8d752809, 0xe6d8c2c6,
    0x275f0892, 0xc8acc273, 0x4cc21580, 0xecc4a617,
    0xf5f7be70, 0xe795248a, 0x375a2fe9, 0x425570b6,
    0x8898dcf8, 0xdc2d97c4, 0x0106114b, 0x364dc22f,
    0x1e0cad1f, 0xbe63803c, 0x5f69fac2, 0x4d5afa6f,
    0x1bc0dfb5, 0xfb273589, 0x0ea47f7b, 0x3c1c2b50,
    0x21b2a932, 0x6b1223fd, 0x2fe706a8, 0xf9bd6ce2,
    0xa268e64e, 0xe987f486, 0x3eacf563, 0x1ca2018c,
    0x65e18228, 0x2207360a, 0x57cf1715, 0x34c37d2b,
    0x1f8f3cde, 0x93b657cf, 0x31a019fd, 0xe69eb729,
    0x8bca7b9b, 0x4c9d5bed, 0x277ebeaf, 0xe0d8f8ae,
    0xd150821c, 0x31381871, 0xafc3f1b0, 0x927db328,
    0xe95effac, 0x305a47bd, 0x426ba35b, 0x1233af3f,
    0x686a5b83, 0x50e072e5, 0xd9d3bb2a, 0x8befc475,
    0x487f0de6, 0xc88dff89, 0xbd664d5e, 0x971b5d18,
    0x63b14847, 0xd7d3c1ce, 0x7f583cf3, 0x72cbcb09,
    0xc0d0a81c, 0x7fa3429b, 0xe9158a1b, 0x225ea19a,
    0xd8ca9ea3, 0xc763b282, 0xbb0c6341, 0x020b8293,
    0xd4cd299d, 0x58cfa7f8, 0x91b4ee53, 0x37e4d140,
    0x95ec764c, 0x30f76b06, 0x5ee68d24, 0x679c8661,
    0xa41979c2, 0xf2b61284, 0x4fac1475, 0x0adb49f9,
    0x19727a23, 0x15a7e374, 0xc43a18d5, 0x3fb1aa73,
    0x342fc615, 0x924c0793, 0xbee2d7f0, 0x8a279de9,
    0x4aa2d70c, 0xe24dd37f, 0xbe862c0b, 0x177c22c2,
    0x5388e5ee, 0xcd8a7510, 0xf901b4fd, 0xdbc13dbc,
    0x6c0bae5b, 0x64efe8c7, 0x48b02079, 0x80331a49,
    0xca3d8ae6, 0xf3546190, 0xfed7108b, 0xc49b941b,
    0x32baf4a9, 0xeb833a4a, 0x88a3f1a5, 0x3a91ce0a,
    0x3cc27da1, 0x7112e684, 0x4a3096b1, 0x3794574c,
    0xa3c8b6f3, 0x1d213941, 0x6e0a2e00, 0x233479f1,
    0x0f4cd82f, 0x6093edd2, 0x5d7d209e, 0x464fe319,
    0xd4dcac9e, 0x0db845cb, 0xfb5e4bc3, 0xe0256ce1,
    0x09fb4ed1, 0x0914be1e, 0xa5bdb2c3, 0xc6eb57bb,
    0x30320350, 0x3f397e91, 0xa67791bc, 0x86bc0e2c,
    0xefa0a7e2, 0xe9ff7543, 0xe733612c, 0xd185897b,
    0x329e5388, 0x91dd236b, 0x2ecb0d93, 0xf4d82a3d,
    0x35b5c03f, 0xe4e606f0, 0x05b21843, 0x37b45964,
    0x5eff22f4, 0x6027f4cc, 0x77178b3c, 0xae507131,
    0x7bf7cabc, 0xf9c18d66, 0x593ade65, 0xd95ddf11,
], dtype=np.uint32)

WINDOW = 48


def discriminator_from_avg(avg: float) -> int:
    """lib/hpcdcchunker/longtail_hpcdcchunker.c:126-129."""
    return int(avg / (-1.42888852e-7 * avg + 1.33237515)) & 0xFFFFFFFF


def _rotl(x, r):
    r = int(r) % 32
    if r == 0:
        return x
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def rolling_hashes(data: np.ndarray) -> np.ndarray:
    """H(p) for every position p (vectorized form of the reference's rolling
    recurrence).  Positions p < WINDOW-1 contain garbage (never consulted:
    the first checked position is >= min >= 48)."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    n = len(data)
    tv = HASH_TABLE[data]  # (n,) uint32
    acc = np.zeros(n, dtype=np.uint32)
    if n < WINDOW:
        return acc
    for i in range(WINDOW):
        acc[WINDOW - 1:] ^= _rotl(tv, i % 32)[WINDOW - 1 - i:n - i]
    return acc


def candidate_positions(data: np.ndarray, avg: int) -> np.ndarray:
    """Sorted absolute positions p where a cut would fire (phase 1)."""
    d = np.uint32(discriminator_from_avg(float(avg)))
    h = rolling_hashes(data)
    mask = (h % d) == (d - np.uint32(1))
    mask[:WINDOW - 1] = False
    return np.flatnonzero(mask)


def resolve_cuts(candidates: np.ndarray, length: int,
                 min_size: int, max_size: int) -> np.ndarray:
    """Phase 2: sequential constraint resolution over sparse candidates.

    Returns chunk end offsets (exclusive); chunk i covers
    [ends[i-1], ends[i]).  Matches Longtail_HPCDCNextChunk semantics.
    """
    # candidate end = p + 1 (the cut consumes byte p)
    cand_ends = np.asarray(candidates, dtype=np.int64) + 1
    ends = []
    s = 0
    n_cand = len(cand_ends)
    ci = 0
    while s < length:
        remaining = length - s
        if remaining <= min_size:
            ends.append(length)
            break
        limit = s + max_size if remaining > max_size else length
        lo = s + min_size + 1
        # first candidate end in [lo, limit]
        ci = np.searchsorted(cand_ends, lo, side="left")
        if ci < n_cand and cand_ends[ci] <= limit:
            e = int(cand_ends[ci])
        else:
            e = limit
        ends.append(e)
        s = e
    return np.asarray(ends, dtype=np.int64)


_native_lib = None


def _native():
    """Bind the native scanner once; False caches a failed probe."""
    global _native_lib
    if _native_lib is None:
        try:
            import ctypes

            from longtail_jax import native
            lib = native.load("cdc_scan")
            if lib is not None:
                lib.lt_cdc_chunk.restype = ctypes.c_long
                lib.lt_cdc_chunk.argtypes = [
                    ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
                    ctypes.c_long, ctypes.c_uint32, ctypes.c_void_p,
                    ctypes.c_long]
            _native_lib = lib if lib is not None else False
        except Exception:
            _native_lib = False
    return _native_lib or None


def chunk_part(data: np.ndarray, min_size: int, avg_size: int,
               max_size: int) -> np.ndarray:
    """Chunk one independently-chunked part; returns end offsets."""
    n = len(data)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    if n <= min_size:
        return np.asarray([n], dtype=np.int64)
    lib = _native()
    if lib is not None and min_size >= WINDOW:
        data = np.ascontiguousarray(data, dtype=np.uint8)
        cap = n // (min_size + 1) + 2
        ends = np.empty(cap, dtype=np.int64)
        d = np.uint32(discriminator_from_avg(float(avg_size)))
        cnt = lib.lt_cdc_chunk(
            data.ctypes.data, n, min_size, max_size, int(d),
            ends.ctypes.data, cap)
        if cnt >= 0:
            return ends[:cnt].copy()
    cands = candidate_positions(data, avg_size)
    return resolve_cuts(cands, n, min_size, max_size)


# ---------------------------------------------------------------------------
# Sequential oracle (TEST-ONLY, never in the product path): an independent
# re-expression of the published HPCDC semantics — 48-byte ring buffer,
# update h' = rotl(h,1) ^ rotl(T[out],16) ^ T[in], cut when h % d == d-1
# within [min, max] — used to validate the two-phase window-function
# algorithm (candidate_positions + resolve_cuts above, which derive the
# same hash as a pure 48-tap XOR of rotated table values) on adversarial
# inputs.  Both formulations are pinned against the reference's golden
# chunker.input boundaries in tests/test_chunker.py.
# ---------------------------------------------------------------------------

def chunk_part_sequential(data: bytes, min_size: int, avg_size: int,
                          max_size: int) -> list[int]:
    """Bit-exact sequential walk (buffer-mode semantics per
    lib/hpcdcchunker/longtail_hpcdcchunker.c:452-523). Returns end offsets."""
    d = discriminator_from_avg(float(avg_size))
    table = [int(x) for x in HASH_TABLE]
    ends = []
    s = 0
    n = len(data)
    while s < n:
        left = n - s
        if left <= min_size:
            ends.append(n)
            break
        h = 0
        for i in range(WINDOW):
            b = data[s + min_size - WINDOW + i]
            r = (WINDOW - i - 1) & 31
            h ^= ((table[b] << r) | (table[b] >> (32 - r))) & 0xFFFFFFFF
        pos = min_size
        data_len = min(left, max_size)
        window = list(data[s + min_size - WINDOW:s + min_size])
        idx = 0
        while pos < data_len:
            incoming = data[s + pos]
            outgoing = window[idx]
            window[idx] = incoming
            idx += 1
            h = ((((h << 1) | (h >> 31)) & 0xFFFFFFFF)
                 ^ (((table[outgoing] << 16) | (table[outgoing] >> 16)) & 0xFFFFFFFF)
                 ^ table[incoming])
            pos += 1
            if (h % d) == (d - 1):
                break
            if idx == WINDOW:
                idx = 0
        ends.append(s + pos)
        s += pos
    return ends
