"""BLAKE2s-64 lane-batched implementation (numpy / jnp via ``xp``).

The reference hashes with blake2s at digest_size 8
(lib/blake2/longtail_blake2.c:43 ``blake2s_init(state, sizeof(uint64_t))``)
and takes the digest little-endian as the 64-bit hash.  Unlike BLAKE3's
tree, BLAKE2s chains sequentially over 64-byte blocks — but a *batch* of
independent messages vectorizes the same way as ops/blake3.py: all lanes
compress their block k simultaneously with masked updates, so the lane
dimension rides the VPU.  hashlib.blake2s is the conformance oracle
(tests/test_hashes.py).
"""

from __future__ import annotations

import numpy as np

IV = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
      0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)

SIGMA = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
    (11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4),
    (7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8),
    (9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13),
    (2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9),
    (12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11),
    (13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10),
    (6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5),
    (10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0),
)

BLOCK_BYTES = 64
DIGEST_BYTES = 8

# param block word 0: digest_length | (key_length << 8) | (fanout << 16)
# | (depth << 24), fanout = depth = 1 (sequential mode)
_PARAM0 = DIGEST_BYTES | (1 << 16) | (1 << 24)


def _rotr(xp, x, n: int):
    return (x >> np.uint32(n)) | (x << np.uint32(32 - n))


def _g(xp, v, a, b, c, d, x, y):
    v[a] = v[a] + v[b] + x
    v[d] = _rotr(xp, v[d] ^ v[a], 16)
    v[c] = v[c] + v[d]
    v[b] = _rotr(xp, v[b] ^ v[c], 12)
    v[a] = v[a] + v[b] + y
    v[d] = _rotr(xp, v[d] ^ v[a], 8)
    v[c] = v[c] + v[d]
    v[b] = _rotr(xp, v[b] ^ v[c], 7)


def _compress(xp, h, m, t, final_mask):
    """One BLAKE2s compression for every lane: h list of 8 lane arrays,
    m list of 16 message-word lane arrays, t byte counter (lane array),
    final_mask lane bool array (f0 = all-ones where final)."""
    u32 = np.uint32
    f0 = xp.where(final_mask, u32(0xFFFFFFFF), u32(0))
    v = [h[i] for i in range(8)] + \
        [xp.zeros_like(h[0]) + u32(IV[i]) for i in range(4)] + \
        [(t & u32(0xFFFFFFFF)) ^ u32(IV[4]),
         xp.zeros_like(h[0]) + u32(IV[5]),  # t_hi = 0 (< 4 GiB inputs)
         f0 ^ u32(IV[6]),
         xp.zeros_like(h[0]) + u32(IV[7])]
    for r in range(10):
        s = SIGMA[r]
        _g(xp, v, 0, 4, 8, 12, m[s[0]], m[s[1]])
        _g(xp, v, 1, 5, 9, 13, m[s[2]], m[s[3]])
        _g(xp, v, 2, 6, 10, 14, m[s[4]], m[s[5]])
        _g(xp, v, 3, 7, 11, 15, m[s[6]], m[s[7]])
        _g(xp, v, 0, 5, 10, 15, m[s[8]], m[s[9]])
        _g(xp, v, 1, 6, 11, 12, m[s[10]], m[s[11]])
        _g(xp, v, 2, 7, 8, 13, m[s[12]], m[s[13]])
        _g(xp, v, 3, 4, 9, 14, m[s[14]], m[s[15]])
    return [h[i] ^ v[i] ^ v[i + 8] for i in range(8)]


def hash_chunks_u32(data_u8, lengths, xp=np):
    """(lanes, padded) u8 + (lanes,) lengths -> (lo, hi) u32 digest words.

    padded must be a multiple of 64.  Zero-length lanes hash the empty
    input (one zero block with t=0, final).  Bytes at/after each lane's
    length must be zero (callers pad with zeros)."""
    u32 = np.uint32
    lanes, padded = data_u8.shape
    d = data_u8.astype(u32).reshape(lanes, padded // 4, 4)
    words = (d[:, :, 0] | (d[:, :, 1] << u32(8))
             | (d[:, :, 2] << u32(16)) | (d[:, :, 3] << u32(24)))
    return hash_chunks_words(words, lengths, xp=xp)


def hash_chunks_words(words, lengths, xp=np):
    """As hash_chunks_u32 over pre-packed little-endian u32 words
    ((lanes, padded//4)); the device pack (pipeline.gather_chunk_words)
    emits words directly."""
    u32 = np.uint32
    lanes, padded4 = words.shape
    padded = padded4 * 4
    assert padded % BLOCK_BYTES == 0 and padded > 0
    n_blocks_max = padded // BLOCK_BYTES

    lengths = xp.asarray(lengths, dtype=u32)

    n_blocks = xp.maximum(
        (lengths + u32(BLOCK_BYTES - 1)) // u32(BLOCK_BYTES), u32(1))

    vzero = lengths * u32(0)
    h = [vzero + u32(IV[i]) for i in range(8)]
    h[0] = h[0] ^ u32(_PARAM0)

    def block_body(k, h):
        h = list(h)
        ku = xp.asarray(k).astype(u32)
        if xp is np:
            m = [words[:, k * 16 + w] for w in range(16)]
        else:
            import jax
            blk = jax.lax.dynamic_slice_in_dim(words, k * 16, 16, axis=1)
            m = [blk[:, w] for w in range(16)]
        is_last = ku == n_blocks - u32(1)
        active = ku < n_blocks
        # t = bytes fed so far including this block (capped at length)
        t = xp.minimum((ku + u32(1)) * u32(BLOCK_BYTES), lengths)
        out = _compress(xp, h, m, t, is_last)
        return tuple(xp.where(active, out[i], h[i]) for i in range(8))

    state = tuple(h)
    if xp is np:
        for k in range(n_blocks_max):
            state = block_body(k, state)
    else:
        import jax
        state = jax.lax.fori_loop(0, n_blocks_max, block_body, state)
    return state[0], state[1]


def hash_chunks(data_u8, lengths, xp=np) -> np.ndarray:
    """Batched hashing returning host (lanes,) uint64 digests."""
    if xp is np:
        lo, hi = hash_chunks_u32(np.asarray(data_u8), lengths, xp=np)
    else:
        import jax

        lo, hi = jax.jit(
            lambda d, l: hash_chunks_u32(d, l, xp=xp))(data_u8, lengths)
    lo = np.asarray(lo).astype(np.uint64)
    hi = np.asarray(hi).astype(np.uint64)
    return lo | (hi << np.uint64(32))
