"""Batched LZ4 block decode on the device — the decode-side experiment.

The reference decompresses blocks with upstream LZ4's scalar loop on the
CPU (hot loop: lib/compressblockstore/longtail_compressblockstore.c:
150-176 via lib/lz4).  A device decode cannot walk the token stream
byte-by-byte (SIMD lanes have no independent control flow), so this
module re-derives decode as data-parallel index algebra:

1. **Host parse** (``parse_sequences``): one cheap O(sequences) walk of
   the token structure — no byte copying — emitting per-sequence
   (literal-source, literal-dest, literal-len, match-dest, offset,
   match-len) arrays.  ~4k sequences for a device-encoded 8 MiB block.
2. **Device resolve** (``make_resolve_fn``): every output byte finds its
   containing segment with one vectorized ``searchsorted`` over the
   interleaved segment starts, giving either a compressed-stream index
   (literal) or an EARLIER output index (match; overlapping matches use
   the modular form ``ref + (j - dst) % offset`` which always lands
   before the match start, so chains strictly decrease).  A
   ``lax.while_loop`` of gathers then chases match pointers until every
   byte bottoms out at a literal, and one final gather materializes the
   output.

Correctness is unconditional (tests pin bit-exactness against the host
decoder); speed is the open question: resolution is one 8M-element
gather per chain-depth round, random-access bound.  The production
downsync decodes on the host (``ops/lz4.decompress_into``); on the card
this path is not measured yet (``bench.py --mode device_decode``
decides whether downsync gets a device decode).
"""

from __future__ import annotations

import functools

import numpy as np

_MINMATCH = 4


def parse_sequences(comp: bytes, raw_size: int):
    """Parse an LZ4 block's token structure (no data movement).

    Returns (lit_src, lit_dst, lit_len, m_dst, m_off, m_len) int32
    arrays, one row per sequence; the final literal-only tail is a row
    with m_len = 0."""
    n = len(comp)
    ip = 0
    dst = 0
    rows = []
    while ip < n:
        token = comp[ip]
        ip += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = comp[ip]
                ip += 1
                lit += b
                if b != 255:
                    break
        lit_src = ip
        ip += lit
        if ip >= n:
            rows.append((lit_src, dst, lit, dst + lit, 0, 0))
            dst += lit
            break
        off = comp[ip] | (comp[ip + 1] << 8)
        ip += 2
        mlen = (token & 15) + _MINMATCH
        if (token & 15) == 15:
            while True:
                b = comp[ip]
                ip += 1
                mlen += b
                if b != 255:
                    break
        rows.append((lit_src, dst, lit, dst + lit, off, mlen))
        dst += lit + mlen
    if dst != raw_size:
        raise ValueError(f"lz4 parse: {dst} != expected {raw_size}")
    out = np.asarray(rows, dtype=np.int32).reshape(-1, 6)
    return (out[:, 0], out[:, 1], out[:, 2], out[:, 3], out[:, 4],
            out[:, 5])


@functools.lru_cache(maxsize=8)
def make_resolve_fn(n_out: int, n_seq: int, max_rounds: int = 64):
    """jit: (comp_u8 (n_comp,), seq arrays padded to n_seq, boundaries)
    -> (out_u8 (n_out,), rounds_used i32).

    Shapes are static; callers pad.  Padding sequences carry
    lit_len = m_len = 0 and dst = n_out (sorted to the end)."""
    import jax
    import jax.numpy as jnp

    def fn(comp, lit_src, lit_dst, lit_len, m_dst, m_off, m_len):
        j = jnp.arange(n_out, dtype=jnp.int32)
        # interleaved segment starts: [lit_dst_0, m_dst_0, lit_dst_1, ..]
        starts = jnp.stack([lit_dst, m_dst], axis=1).reshape(-1)
        k = jnp.searchsorted(starts, j, side="right") - 1
        i = k >> 1
        is_lit = (k & 1) == 0
        ls = lit_src[i]
        ld = lit_dst[i]
        md = m_dst[i]
        off = jnp.maximum(m_off[i], 1)
        # literal bytes resolve into the compressed stream immediately;
        # match bytes point at strictly-earlier output positions
        lit_idx = ls + (j - ld)
        match_idx = md - off + jax.lax.rem(j - md, off)
        idx = jnp.where(is_lit, lit_idx, match_idx)
        flag = ~is_lit                       # True: idx is an OUT index

        def cond(state):
            r, idx, flag = state
            return jnp.any(flag) & (r < max_rounds)

        def body(state):
            # pointer JUMPING, not single-step chase: every flagged byte
            # re-reads through the partially-resolved snapshot, so chain
            # distance doubles per round (depth d resolves in ~log2 d)
            r, idx, flag = state
            safe = jnp.clip(idx, 0, n_out - 1)
            nidx = jnp.where(flag, jnp.take(idx, safe), idx)
            nflag = flag & jnp.take(flag, safe)
            return r + 1, nidx, nflag

        rounds, idx, flag = jax.lax.while_loop(cond, body, (0, idx, flag))
        out = jnp.take(comp, jnp.clip(idx, 0, comp.shape[0] - 1))
        return out, rounds

    return jax.jit(fn)


def decode_block_device(comp: bytes, raw_size: int) -> bytes:
    """Decode ONE LZ4 block on the device; bit-exact vs the host
    decoder (falls back to host past max chain depth — never wrong)."""
    from longtail_jax.ops import lz4 as _lz4

    if raw_size == 0:
        return b""
    seq = parse_sequences(comp, raw_size)
    n_seq = 1 << max(4, (len(seq[0]) - 1).bit_length())
    n_out = 1 << max(8, (raw_size - 1).bit_length())
    ncomp = 1 << max(8, (len(comp) - 1).bit_length())
    pad = np.zeros(n_seq - len(seq[0]), np.int32)
    args = []
    comp_a = np.zeros(ncomp, np.uint8)
    comp_a[:len(comp)] = np.frombuffer(comp, np.uint8)
    for a, fill in zip(seq, (0, raw_size, 0, raw_size, 0, 0)):
        args.append(np.concatenate([a, pad + np.int32(fill)]))
    out, rounds = make_resolve_fn(n_out, n_seq)(comp_a, *args)
    if int(rounds) >= 64:
        return _lz4.decompress(comp, raw_size)   # pathological chain
    return np.asarray(out)[:raw_size].tobytes()
