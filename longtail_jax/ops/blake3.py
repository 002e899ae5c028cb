"""BLAKE3 hashing: scalar oracle + batched array implementation (numpy / jnp).

The reference wraps upstream BLAKE3 and takes the first 8 bytes of the digest
as the 64-bit chunk/content hash (lib/blake3/longtail_blake3.c:81-102).  We
implement BLAKE3 from the public spec for batched hardware: the batched form
processes a whole batch of content chunks as uint32 lanes so the per-block
compression runs across the vector lanes, and the chunk-tree merge runs as
``log2`` masked parent-compression sweeps (BLAKE3's left-leaning binary tree
over 1 KiB leaves is exactly "merge adjacent pairs, odd tail carries up").

The same code runs under numpy (host oracle) and jax.numpy (device), selected by
the ``xp`` namespace argument; both produce identical uint32 lane math.
"""

from __future__ import annotations

import struct

import numpy as np

IV = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
      0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)

# Message word permutation applied between rounds.
PERM = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)

CHUNK_START = 1 << 0
CHUNK_END = 1 << 1
PARENT = 1 << 2
ROOT = 1 << 3

BLOCK_BYTES = 64
LEAF_BYTES = 1024  # BLAKE3 "chunk" (leaf) size; we say "leaf" to avoid
                   # clashing with longtail's CDC chunks.

_MASK32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Scalar oracle (python ints) — used for small host-side inputs (path hashes,
# hash-of-hashes) and as the conformance oracle for the batched versions.
# ---------------------------------------------------------------------------

def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & _MASK32


def _g(v: list, a: int, b: int, c: int, d: int, x: int, y: int) -> None:
    v[a] = (v[a] + v[b] + x) & _MASK32
    v[d] = _rotr(v[d] ^ v[a], 16)
    v[c] = (v[c] + v[d]) & _MASK32
    v[b] = _rotr(v[b] ^ v[c], 12)
    v[a] = (v[a] + v[b] + y) & _MASK32
    v[d] = _rotr(v[d] ^ v[a], 8)
    v[c] = (v[c] + v[d]) & _MASK32
    v[b] = _rotr(v[b] ^ v[c], 7)


def _compress(h, m, t: int, b: int, flags: int) -> list:
    v = list(h[:8]) + list(IV[:4]) + [t & _MASK32, (t >> 32) & _MASK32, b, flags]
    m = list(m)
    for r in range(7):
        _g(v, 0, 4, 8, 12, m[0], m[1])
        _g(v, 1, 5, 9, 13, m[2], m[3])
        _g(v, 2, 6, 10, 14, m[4], m[5])
        _g(v, 3, 7, 11, 15, m[6], m[7])
        _g(v, 0, 5, 10, 15, m[8], m[9])
        _g(v, 1, 6, 11, 12, m[10], m[11])
        _g(v, 2, 7, 8, 13, m[12], m[13])
        _g(v, 3, 4, 9, 14, m[14], m[15])
        if r < 6:
            m = [m[p] for p in PERM]
    return [(v[i] ^ v[i + 8]) & _MASK32 for i in range(8)] + \
           [(v[i + 8] ^ h[i]) & _MASK32 for i in range(8)]


def _block_words(block: bytes) -> tuple:
    return struct.unpack("<16I", block + b"\0" * (BLOCK_BYTES - len(block)))


def _leaf_output(data: bytes, counter: int, is_root: bool) -> list:
    h = list(IV)
    n_blocks = max(1, (len(data) + BLOCK_BYTES - 1) // BLOCK_BYTES)
    out = None
    for i in range(n_blocks):
        blk = data[i * BLOCK_BYTES:(i + 1) * BLOCK_BYTES]
        flags = (CHUNK_START if i == 0 else 0) | \
                (CHUNK_END if i == n_blocks - 1 else 0)
        if is_root and i == n_blocks - 1:
            flags |= ROOT
        out = _compress(h, _block_words(blk), counter, len(blk), flags)
        h = out[:8]
    return out


def _parent_output(left_cv, right_cv, is_root: bool) -> list:
    return _compress(list(IV), list(left_cv) + list(right_cv), 0, BLOCK_BYTES,
                     PARENT | (ROOT if is_root else 0))


def _subtree(data: bytes, counter: int, is_root: bool) -> list:
    n_leaves = max(1, (len(data) + LEAF_BYTES - 1) // LEAF_BYTES)
    if n_leaves == 1:
        return _leaf_output(data, counter, is_root)
    # left subtree takes the largest power of two of leaves < n_leaves
    p = 1
    while p * 2 < n_leaves:
        p *= 2
    left = _subtree(data[:p * LEAF_BYTES], counter, False)[:8]
    right = _subtree(data[p * LEAF_BYTES:], counter + p, False)[:8]
    return _parent_output(left, right, is_root)


def blake3(data: bytes, out_len: int = 32) -> bytes:
    """Full BLAKE3 digest (default 32 bytes; extendable up to 64 here)."""
    out = _subtree(data, 0, True)
    return struct.pack("<16I", *out)[:out_len]


def hash64(data: bytes) -> int:
    """The longtail 64-bit hash: first 8 digest bytes as little-endian uint64
    (lib/blake3/longtail_blake3.c:100)."""
    out = _subtree(data, 0, True)
    return out[0] | (out[1] << 32)


# ---------------------------------------------------------------------------
# Batched lane implementation (numpy or jax.numpy via the xp argument).
#
# Input: a (lanes, padded_len) uint8 matrix plus per-lane byte lengths.
# Output: (lanes,) uint64 digests.  All lanes are hashed independently —
# this is the bulk path for hashing every CDC chunk of a file batch at once.
# ---------------------------------------------------------------------------

def _xp_rotr(xp, x, n: int):
    n = n % 32
    if n == 0:
        return x
    return (x >> np.uint32(n)) | (x << np.uint32(32 - n))


def _xp_g(xp, v, a, b, c, d, x, y):
    v[a] = v[a] + v[b] + x
    v[d] = _xp_rotr(xp, v[d] ^ v[a], 16)
    v[c] = v[c] + v[d]
    v[b] = _xp_rotr(xp, v[b] ^ v[c], 12)
    v[a] = v[a] + v[b] + y
    v[d] = _xp_rotr(xp, v[d] ^ v[a], 8)
    v[c] = v[c] + v[d]
    v[b] = _xp_rotr(xp, v[b] ^ v[c], 7)


def _xp_compress(xp, h, m, t_lo, t_hi, b, flags):
    """Vectorized compression.

    h: list of 8 uint32 arrays (lane-shaped); m: list of 16; t_lo/t_hi/b/flags:
    lane-shaped uint32 arrays or scalars.  Returns (cv8, xor_hi8) where cv8 is
    the chaining value and xor_hi8 the upper output words.
    """
    shape = h[0].shape
    u32 = np.uint32

    def bc(x):
        arr = xp.asarray(x, dtype=u32)
        return arr + xp.zeros(shape, dtype=u32) if arr.shape != shape else arr

    v = [h[i] for i in range(8)] + [bc(IV[i]) for i in range(4)] + \
        [bc(t_lo), bc(t_hi), bc(b), bc(flags)]
    m = list(m)
    for r in range(7):
        _xp_g(xp, v, 0, 4, 8, 12, m[0], m[1])
        _xp_g(xp, v, 1, 5, 9, 13, m[2], m[3])
        _xp_g(xp, v, 2, 6, 10, 14, m[4], m[5])
        _xp_g(xp, v, 3, 7, 11, 15, m[6], m[7])
        _xp_g(xp, v, 0, 5, 10, 15, m[8], m[9])
        _xp_g(xp, v, 1, 6, 11, 12, m[10], m[11])
        _xp_g(xp, v, 2, 7, 8, 13, m[12], m[13])
        _xp_g(xp, v, 3, 4, 9, 14, m[14], m[15])
        if r < 6:
            m = [m[p] for p in PERM]
    cv = [v[i] ^ v[i + 8] for i in range(8)]
    return cv, v


def _bytes_to_words(xp, data_u8):
    """(lanes, n_bytes) uint8 -> (lanes, n_bytes//4) uint32 little-endian."""
    lanes, n = data_u8.shape
    d = data_u8.astype(np.uint32).reshape(lanes, n // 4, 4)
    return (d[:, :, 0] | (d[:, :, 1] << np.uint32(8))
            | (d[:, :, 2] << np.uint32(16)) | (d[:, :, 3] << np.uint32(24)))


def hash_chunks_u32(data_u8, lengths, xp=np):
    """Hash a batch of byte lanes: (lanes, padded) uint8 + (lanes,) lengths
    -> (lo, hi) pair of (lanes,) uint32 arrays forming the 64-bit digest.

    The split return keeps the device path free of 64-bit integers (XLA's
    native lane width is 32 bits; the device pipeline carries hash words as u32
    pairs and the host combines them).  padded must be a multiple of 1024
    (LEAF_BYTES).  Lanes whose length is 0 hash the empty input.  Static
    shapes only: cost is driven by the padded length, so bucket chunk batches
    by size before calling.
    """
    words = _bytes_to_words(xp, data_u8)  # (lanes, padded//4)
    return hash_chunks_words(words, lengths, xp=xp)


def hash_chunks_words(words, lengths, xp=np):
    """As hash_chunks_u32 but over pre-packed little-endian uint32 words
    ((lanes, padded//4)); the device pack (pipeline.gather_chunk_words)
    emits words directly so the byte->word marshalling is skipped."""
    lanes, padded4 = words.shape
    padded = padded4 * 4
    assert padded % LEAF_BYTES == 0 and padded > 0
    max_leaves = padded // LEAF_BYTES
    u32 = np.uint32

    lengths = xp.asarray(lengths, dtype=u32)

    # number of leaves / lane (>=1)
    n_leaves = xp.maximum(
        (lengths + u32(LEAF_BYTES - 1)) // u32(LEAF_BYTES), u32(1))
    single_leaf = n_leaves == u32(1)

    # ---- leaf chaining values ------------------------------------------
    # Flatten (lanes, max_leaves) into one big lane dim and loop the 16
    # blocks of each leaf with masked updates.
    L = lanes * max_leaves
    wordsL = words.reshape(L, padded // 4 // max_leaves)  # (L, 256)
    leaf_idx = xp.arange(max_leaves, dtype=u32)
    leaf_off = (xp.zeros((lanes, 1), dtype=u32) + leaf_idx[None, :])  # (lanes, max_leaves)
    leaf_len = xp.clip(
        lengths[:, None].astype(np.int32) - (leaf_off.astype(np.int32) * LEAF_BYTES),
        0, LEAF_BYTES).astype(u32)                       # bytes in each leaf
    counter = leaf_off                                    # leaf counter = index
    leaf_lenL = leaf_len.reshape(L)
    counterL = counter.reshape(L)
    rootL = (xp.repeat(single_leaf, max_leaves) if xp is np
             else xp.repeat(single_leaf, max_leaves, total_repeat_length=L))

    n_blocks = xp.maximum(
        (leaf_lenL + u32(BLOCK_BYTES - 1)) // u32(BLOCK_BYTES), u32(1))

    blocks_per_leaf = LEAF_BYTES // BLOCK_BYTES  # 16

    def leaf_block_body(k, h):
        h = list(h)
        ku = xp.asarray(k).astype(u32)
        if xp is np:
            m = [wordsL[:, k * 16 + w] for w in range(16)]
        else:
            import jax
            blk = jax.lax.dynamic_slice_in_dim(wordsL, k * 16, 16, axis=1)
            m = [blk[:, w] for w in range(16)]
        blk_len = xp.clip(
            leaf_lenL.astype(np.int32) - ku.astype(np.int32) * BLOCK_BYTES,
            0, BLOCK_BYTES).astype(u32)
        is_first = ku == u32(0)
        is_last = ku == (n_blocks - u32(1))
        active = ku < n_blocks
        flags = xp.where(is_first, u32(CHUNK_START), u32(0)) \
            | xp.where(is_last, u32(CHUNK_END), u32(0)) \
            | xp.where(is_last & rootL, u32(ROOT), u32(0))
        cv, _ = _xp_compress(xp, h, m, u32(0) + counterL, u32(0), blk_len, flags)
        return tuple(xp.where(active, cv[i], h[i]) for i in range(8))

    # derive the carry init from leaf_lenL (itself derived from `lengths`) so
    # it carries the input's varying-axes type under shard_map; a plain
    # xp.full init would make the fori_loop carry type mismatch its output
    vzero = leaf_lenL * u32(0)
    h = tuple(vzero + u32(IV[i]) for i in range(8))
    if xp is np:
        for k in range(blocks_per_leaf):
            h = leaf_block_body(k, h)
    else:
        import jax
        h = jax.lax.fori_loop(0, blocks_per_leaf, leaf_block_body, h)
    return merge_leaf_cvs(xp, [c.reshape(lanes, max_leaves) for c in h],
                          n_leaves)


def merge_leaf_cvs(xp, cvs, n_leaves):
    """BLAKE3 tree merge: 8 (lanes, max_leaves) u32 leaf chaining values
    plus (lanes,) u32 leaf counts -> (lo, hi) digest words per lane.

    Adjacent pairs merge, an odd tail carries up.  A single-leaf lane's
    leaf stage already ran its final block with the ROOT flag, so its
    leaf-0 value is the digest and no merge touches it."""
    u32 = np.uint32
    lanes, width = cvs[0].shape
    count = n_leaves  # per-lane live node count at current level
    while width > 1:
        half = (width + 1) // 2
        left = [c[:, 0:2 * half:2] for c in cvs]    # (lanes, half)
        right_src = [c[:, 1::2] for c in cvs]
        # pad right to half columns if width is odd
        if right_src[0].shape[1] < half:
            pad = half - right_src[0].shape[1]
            right = [xp.concatenate(
                [c, xp.zeros((lanes, pad), dtype=u32)], axis=1)
                for c in right_src]
        else:
            right = right_src
        j = xp.arange(half, dtype=u32)[None, :]
        has_right = (u32(2) * j + u32(1)) < count[:, None]
        is_root_merge = (count[:, None] == u32(2)) & (j == u32(0))
        m = left + right  # 16 message words = left cv || right cv
        flags = u32(PARENT) + xp.where(is_root_merge, u32(ROOT), u32(0))
        h_par = [xp.zeros((lanes, half), dtype=u32) + u32(IV[i])
                 for i in range(8)]
        cv_new, _ = _xp_compress(xp, h_par, m, u32(0), u32(0),
                                 u32(BLOCK_BYTES), flags)
        cvs = [xp.where(has_right, cv_new[i], left[i]) for i in range(8)]
        count = (count + u32(1)) // u32(2)
        width = half
    return cvs[0][:, 0], cvs[1][:, 0]


_jax_hash_fn = None


def _jax_hash_chunks_u32():
    """jit-compiled device entry (cached per call-shape by jax)."""
    global _jax_hash_fn
    if _jax_hash_fn is None:
        import jax
        import jax.numpy as jnp
        _jax_hash_fn = jax.jit(
            lambda d, l: hash_chunks_u32(d, l, xp=jnp))
    return _jax_hash_fn


def hash_chunks(data_u8, lengths, xp=np) -> np.ndarray:
    """Batched hashing returning host-side (lanes,) uint64 digests.

    xp=np runs the numpy oracle; any other namespace routes through the
    jit-compiled jax implementation and pulls the u32 pair back to host.
    """
    if xp is np:
        lo, hi = hash_chunks_u32(np.asarray(data_u8), lengths, xp=np)
        return lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))
    lo, hi = _jax_hash_chunks_u32()(data_u8, lengths)
    lo = np.asarray(lo).astype(np.uint64)
    hi = np.asarray(hi).astype(np.uint64)
    return lo | (hi << np.uint64(32))


# ---------------------------------------------------------------------------
# native host fast path (longtail_jax/native/blake3_hash.c): the from-spec
# C implementation, cross-checked against this module's KAT-verified oracle.
# ---------------------------------------------------------------------------

_native_lib = None


def _native():
    """Bind the native hasher once; False caches a failed probe."""
    global _native_lib
    if _native_lib is None:
        try:
            import ctypes

            from longtail_jax import native
            lib = native.load("blake3_hash")
            if lib is not None:
                lib.lt_blake3_hash64.restype = None
                lib.lt_blake3_hash64.argtypes = [
                    ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p]
                lib.lt_blake3_hash64_batch.restype = None
                lib.lt_blake3_hash64_batch.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_long, ctypes.c_void_p]
            _native_lib = lib if lib is not None else False
        except Exception:
            _native_lib = False
    return _native_lib or None


def hash64_ranges(base_u8: np.ndarray, offsets: np.ndarray,
                  sizes: np.ndarray) -> np.ndarray | None:
    """Hash chunks [offsets[i], offsets[i]+sizes[i]) of base_u8 natively;
    None when the native library is unavailable (caller falls back)."""
    lib = _native()
    if lib is None:
        return None
    base_u8 = np.ascontiguousarray(base_u8, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    sizes = np.ascontiguousarray(sizes, dtype=np.int64)
    out = np.empty(len(sizes), dtype=np.uint64)
    if len(sizes):
        lib.lt_blake3_hash64_batch(
            base_u8.ctypes.data, offsets.ctypes.data, sizes.ctypes.data,
            len(sizes), out.ctypes.data)
    return out
