"""Pallas-Triton kernel: BLAKE3-64 of every chunk of a batch, read straight
from the batch's word rows.

Stage 3 of the device pipeline hashes every chunk of a batch.  Chunks sit
at arbitrary byte offsets inside the batch's word rows and are grouped
into power-of-two size classes (parallel/pipeline.py ``class_plan``).  The
plain form (pipeline ``gather_chunk_words`` + ops/blake3
``hash_chunks_words``) gathers each class into a zero-padded buffer, then
hashes the buffer.  This kernel does the whole batch in one launch:

- each program owns ``TL`` consecutive leaves (1 KiB BLAKE3 chunks) of one
  size class, one leaf per thread, so it always holds whole chunks;
- message words load straight out of the word rows (two words and a
  funnel shift for the chunk's 0..3-byte phase, masked past the chunk's
  size): the padded buffer is never written;
- the state stays in registers across the 16 block compressions;
- the tree merge runs in the program: each level exchanges chaining
  values through a scratch output behind a block barrier;
- a program whose leaves are all past their chunk's end (padding rows sit
  last in every class) does no work.

Reference behavior matched: 64-bit longtail digest = first two output
words (lib/blake3/longtail_blake3.c:81-102).  Conformance: tests against
ops/blake3.hash_chunks_words and the scalar oracle.
"""

from __future__ import annotations

import functools

import numpy as np

from longtail_jax.ops.blake3 import (
    BLOCK_BYTES,
    CHUNK_END,
    CHUNK_START,
    IV,
    LEAF_BYTES,
    PARENT,
    ROOT,
    _xp_compress,
)

_WORDS_PER_LEAF = LEAF_BYTES // 4             # 256
_BLOCKS_PER_LEAF = LEAF_BYTES // BLOCK_BYTES  # 16


def _leaves_per_program(layout: tuple) -> int:
    return max(128, max(cls // LEAF_BYTES for cls, _ in layout))


@functools.lru_cache(maxsize=16)
def _hash_call(layout: tuple, interpret: bool):
    """pallas_call: (words (N,) u32, blob (2 * sum rows,) i32 — each
    class's starts then sizes) -> (digest words (2, n_leaves) u32 at each
    chunk's first leaf, exchange scratch (8, n_leaves) u32)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    TL = _leaves_per_program(layout)
    classes = []                 # (first leaf, first blob slot, rows, lg)
    leaf0 = slot0 = 0
    for cls, rows in layout:
        leaves = cls // LEAF_BYTES
        assert leaves & (leaves - 1) == 0 and (rows * leaves) % TL == 0, \
            (cls, rows)
        classes.append((leaf0, slot0, rows, leaves.bit_length() - 1))
        leaf0 += rows * leaves
        slot0 += 2 * rows
    n_leaves = leaf0
    u32 = np.uint32

    def kernel(w_ref, blob_ref, out_ref, xch_ref):
        pid = pl.program_id(0)
        first = pid * TL
        # this program's class (programs never straddle classes)
        c_leaf0, c_slot0, c_rows, lg = (np.int32(v) for v in classes[0])
        for cl0, cs0, cr, clg in classes[1:]:
            here = first >= cl0
            c_leaf0 = jnp.where(here, np.int32(cl0), c_leaf0)
            c_slot0 = jnp.where(here, np.int32(cs0), c_slot0)
            c_rows = jnp.where(here, np.int32(cr), c_rows)
            lg = jnp.where(here, np.int32(clg), lg)
        lane = first + jnp.arange(TL, dtype=jnp.int32)
        local = lane - c_leaf0
        row = local >> lg
        li = local & ((1 << lg) - 1)            # leaf index within chunk
        size = blob_ref[c_slot0 + c_rows + row]
        leaf_len = jnp.clip(size - li * LEAF_BYTES, 0, LEAF_BYTES)

        @pl.when(jnp.max(leaf_len) > 0)
        def _():
            start = blob_ref[c_slot0 + row]
            n_blocks = jnp.maximum((leaf_len + (BLOCK_BYTES - 1)) >> 6, 1)
            n_leaf = jnp.maximum((size + (LEAF_BYTES - 1)) >> 10, 1)
            w0 = (start >> 2) + li * _WORDS_PER_LEAF
            r8 = ((start & 3) * 8).astype(jnp.uint32)
            zero = jnp.zeros((TL,), jnp.uint32)

            def block(k, h):
                m = []
                for w in range(16):
                    j = k * 16 + w             # word index within the leaf
                    lo = w_ref[w0 + j]
                    hi = w_ref[w0 + j + 1]
                    word = (lo >> r8) | ((hi << (u32(31) - r8)) << u32(1))
                    nb = jnp.clip(leaf_len - 4 * j, 0, 4)
                    part = (u32(1) << (jnp.minimum(nb, 3).astype(
                        jnp.uint32) * u32(8))) - u32(1)
                    mask = jnp.where(nb >= 4, u32(0xFFFFFFFF),
                                     jnp.where(nb > 0, part, u32(0)))
                    m.append(word & mask)
                blk_len = jnp.clip(leaf_len - k * BLOCK_BYTES, 0,
                                   BLOCK_BYTES).astype(jnp.uint32)
                last = n_blocks == k + 1
                flags = (jnp.where(k == 0, u32(CHUNK_START), u32(0))
                         | jnp.where(last, u32(CHUNK_END), u32(0))
                         | jnp.where(last & (n_leaf == 1), u32(ROOT),
                                     u32(0)))
                cv, _ = _xp_compress(jnp, list(h), m, li.astype(jnp.uint32),
                                     u32(0), blk_len, flags)
                active = k < n_blocks
                return tuple(jnp.where(active, cv[i], h[i])
                             for i in range(8))

            h = jax.lax.fori_loop(
                0, _BLOCKS_PER_LEAF, block,
                tuple(zero + u32(IV[i]) for i in range(8)))

            # tree merge: level l pairs node (2j, 2j+1) -> j; node i of a
            # chunk sits at leaf lane i * 2**l, an odd tail carries up
            partner_base = first + jnp.arange(TL, dtype=jnp.int32)

            def level(lvl, h):
                step = jnp.int32(1) << lvl
                for i in range(8):
                    xch_ref[i, pl.ds(first, TL)] = h[i]
                if not interpret:
                    plgpu.debug_barrier()
                partner = jnp.minimum(partner_base + step, first + TL - 1)
                right = [xch_ref[i, partner] for i in range(8)]
                if not interpret:
                    plgpu.debug_barrier()
                cnt = (n_leaf + step - 1) >> lvl        # nodes at lvl
                is_left = (li & (2 * step - 1)) == 0
                has_right = is_left & ((li >> lvl) + 1 < cnt)
                flags = u32(PARENT) + jnp.where(
                    has_right & (cnt == 2), u32(ROOT), u32(0))
                cv, _ = _xp_compress(
                    jnp, [zero + u32(IV[i]) for i in range(8)],
                    list(h) + right, zero, u32(0), u32(BLOCK_BYTES), flags)
                return tuple(jnp.where(has_right, cv[i], h[i])
                             for i in range(8))

            h = jax.lax.fori_loop(0, lg, level, h)
            out_ref[0, pl.ds(first, TL)] = h[0]
            out_ref[1, pl.ds(first, TL)] = h[1]

    return pl.pallas_call(
        kernel,
        grid=(n_leaves // TL,),
        out_shape=[jax.ShapeDtypeStruct((2, n_leaves), jnp.uint32),
                   jax.ShapeDtypeStruct((8, n_leaves), jnp.uint32)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=TL // 32,
                                             num_stages=1),
        interpret=interpret,
        name="blake3_chunks",
    )


def hash_layout(words_flat, blob, layout: tuple, interpret: bool = False):
    """BLAKE3-64 of every chunk named by ``blob`` — per (cls, rows) class
    of ``layout`` in order, ``rows`` byte starts then ``rows`` sizes —
    over the little-endian u32 word stream ``words_flat``, which must hold
    cls/4 + 1 words past every start.  Rows of size 0 are padding: their
    digests are garbage.  Trace under jit.  Returns (lo, hi) u32, one
    word per row of every class in order."""
    import jax.numpy as jnp

    out, _ = _hash_call(layout, interpret)(words_flat, blob.astype(jnp.int32))
    los, his = [], []
    leaf0 = 0
    for cls, rows in layout:
        leaves = cls // LEAF_BYTES
        sl = slice(leaf0, leaf0 + rows * leaves, leaves)
        los.append(out[0, sl])
        his.append(out[1, sl])
        leaf0 += rows * leaves
    return jnp.concatenate(los), jnp.concatenate(his)
