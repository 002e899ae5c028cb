"""Device CDC stage 1: candidate scan + cut resolution.

Two phases in one jitted program per batch:

- **Scan** (plain XLA, ``_scan``): the 256-entry HPCDC table lookup is a
  table gather; the 48-tap rolling-window XOR telescopes into 6
  shift-rotate-XOR doubling steps (S_2k[p] = S_k[p] ^ rotl(S_k[p-k], k));
  candidates are reduced to per-segment summaries — the two smallest
  candidate ends and a count per ``Z``-byte segment — by reshape and
  reduce, so only ~1/Z of the data survives the scan.  The word-row
  relayout stage 3 reads, and the anchor bin-mins the compression tier
  reads, come out of the same program.

- **Walk** (``_walk_xla`` or the Pallas-Triton ``_walk_triton``): the
  sequential min/max constraint walk (Longtail_HPCDCNextChunk semantics,
  lib/hpcdcchunker/longtail_hpcdcchunker.c:289-306) over the segment
  summaries, one step per chunk.  parallel/backend.py picks the form.

- **Exactness**: per-segment (min1, min2, count) resolves "first candidate
  end > q" exactly unless a segment holds 3+ candidates *and* both kept
  ends precede the query — statistically ~1e-5 of batches at the default
  geometry (candidate rate 1/discriminator, Z ~ discriminator/16).  Such
  lanes are flagged and re-chunked exactly on the host (native C scanner,
  ops/cdc.chunk_part); bit-exactness is unconditional.

Matches the reference hot loop it replaces: ChunkAssets
src/longtail.c:2429-2462 + DynamicChunking :1989-2311.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from longtail_jax.formats.constants import CHUNKER_WINDOW_SIZE as WINDOW
from longtail_jax.ops.cdc import HASH_TABLE
from longtail_jax.parallel.device_chunker import ChunkerConfig

_BIG = np.int32(2**31 - 1)


def segment_bytes(cfg: ChunkerConfig) -> int:
    """Segment size Z: power of two ~ discriminator/16 so the expected
    candidate count per segment is ~0.06 (3+ candidates ~ 4e-5)."""
    d = cfg.discriminator
    z = 128
    while z * 32 <= d and z < 4096:
        z *= 2
    return z


@dataclasses.dataclass(frozen=True)
class Stage1Plan:
    """Static geometry for a (cfg, lanes, part_bytes) pipeline instance."""
    cfg: ChunkerConfig
    lanes: int
    part_bytes: int

    @property
    def z(self) -> int:
        return segment_bytes(self.cfg)

    @property
    def c_pad(self) -> int:
        c = self.part_bytes // (self.cfg.min_size + 1) + 1
        return -(-c // 128) * 128


def padded_words_rows(n_u8_rows: int, slack_words: int) -> int:
    """Row count of the (R2, 128) u32 word rows for an (R, 128) u8 batch
    with >= slack_words zero words appended (a multiple of 8 rows)."""
    w2 = n_u8_rows // 4
    extra = -(-slack_words // 128)
    return w2 + ((-(w2 + extra)) % 8) + extra


def words_from_rows(rows_u8, slack_words: int):
    """(R, 128) u8 rows -> (R2, 128) u32 little-endian word rows of the
    same flat byte stream, zero-padded (padded_words_rows)."""
    import jax
    import jax.numpy as jnp

    R = rows_u8.shape[0]
    words = jax.lax.bitcast_convert_type(
        rows_u8.reshape(R, 32, 4), jnp.uint32).reshape(R // 4, 128)
    pad = padded_words_rows(R, slack_words) - words.shape[0]
    return jnp.pad(words, ((0, pad), (0, 0)))


def _rotl(x, r: int):
    r %= 32
    if r == 0:
        return x
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _scan(parts_u8, lengths, cfg: ChunkerConfig, z: int):
    """(B, P) u8 + (B,) lengths -> per-segment summaries, each (B, P//z)
    i32: min1/min2 = the two smallest candidate cut ends in the segment
    (_BIG if absent), cnt = candidates in it, suf = min1 over the part's
    LATER segments."""
    import jax
    import jax.numpy as jnp

    B, P = parts_u8.shape
    table = jnp.asarray(HASH_TABLE, dtype=jnp.uint32)
    tv = table[parts_u8.astype(jnp.int32)]                  # (B, P) u32

    def back(x, k):     # x[p - k], zero-filled (positions < k are masked)
        return jnp.pad(x[:, :P - k], ((0, 0), (k, 0)))

    s = tv
    for k in (1, 2, 4, 8):
        s = s ^ _rotl(back(s, k), k)                        # window 2k
    s32 = s ^ _rotl(back(s, 16), 16)                        # window 32
    h = s ^ _rotl(back(s32, 16), 16)                        # window 48

    d = np.uint32(cfg.discriminator)
    pos = jnp.arange(P, dtype=jnp.int32)[None, :]
    live = ((h % d) == d - np.uint32(1)) & (pos >= WINDOW - 1) \
        & (pos < lengths[:, None])
    ends = jnp.where(live, pos + 1, _BIG).reshape(B, P // z, z)
    m1 = jnp.min(ends, axis=2)
    m2 = jnp.min(jnp.where(ends == m1[:, :, None], _BIG, ends), axis=2)
    cnt = jnp.sum(live.reshape(B, P // z, z), axis=2, dtype=jnp.int32)
    later = jax.lax.cummin(m1, axis=1, reverse=True)
    suf = jnp.concatenate(
        [later[:, 1:], jnp.full((B, 1), _BIG, jnp.int32)], axis=1)
    return m1, m2, cnt, suf


def _step(cfg: ChunkerConfig, z: int, n_seg: int, L, s, m1, m2, cn, suf):
    """One walk step from cut position s given segment t's summaries,
    t = min((s + min) >> log2 z, n_seg - 1): -> (next cut e, ambiguous).
    Shared by both walk forms, elementwise in every argument."""
    import jax.numpy as jnp

    mn = np.int32(cfg.min_size)
    mx = np.int32(cfg.max_size)
    q = s + mn                          # first admissible end is > q
    in_seg = jnp.where(m1 > q, m1, jnp.where(m2 > q, m2, _BIG))
    amb = (cn >= 3) & (m2 <= q) & (m1 <= q)
    e_cand = jnp.minimum(in_seg, suf)
    rem = L - s
    limit = jnp.where(rem > mx, s + mx, L)
    e = jnp.minimum(jnp.where(e_cand > q, e_cand, limit), limit)
    e = jnp.where(rem <= mn, L, e)
    return e, amb


def _segment(cfg: ChunkerConfig, z: int, n_seg: int, s):
    import jax.numpy as jnp

    lgz = z.bit_length() - 1
    return jnp.minimum((s + np.int32(cfg.min_size)) >> lgz, n_seg - 1)


def _walk_xla(m1, m2, cnt, suf, lengths, cfg: ChunkerConfig, z: int,
              c_pad: int):
    """The walk as one lax.while_loop over all lanes at once, one chunk
    per iteration -> (ends (B, c_pad), n (B,), amb (B,)) i32.  Lanes that
    are done hold their position; entries at or past n are garbage."""
    import jax
    import jax.numpy as jnp

    B, n_seg = m1.shape

    def at(a, t):
        return jnp.take_along_axis(a, t[:, None], axis=1)[:, 0]

    def body(state):
        i, s, n, amb, ends = state
        t = _segment(cfg, z, n_seg, s)
        e, a = _step(cfg, z, n_seg, lengths, s, at(m1, t), at(m2, t),
                     at(cnt, t), at(suf, t))
        active = s < lengths
        e = jnp.where(active, e, s)
        ends = jax.lax.dynamic_update_slice(ends, e[None, :], (i, 0))
        return (i + 1, e, n + active.astype(jnp.int32),
                amb | (active & a).astype(jnp.int32), ends)

    def cond(state):
        i, s = state[0], state[1]
        return jnp.any(s < lengths) & (i < c_pad)

    zero = jnp.zeros_like(lengths)
    state = (jnp.int32(0), zero, zero, zero,
             jnp.zeros((c_pad, B), jnp.int32))
    _, _, n, amb, ends = jax.lax.while_loop(cond, body, state)
    return ends.T, n, amb


def _walk_triton(m1, m2, cnt, suf, lengths, cfg: ChunkerConfig, z: int,
                 c_pad: int, interpret: bool = False):
    """The walk as a Pallas-Triton kernel: one program per lane, the
    chunk-by-chunk loop inside the program (a chain of dependent scalar
    loads, so one launch instead of one XLA loop iteration per chunk).
    Same contract as _walk_xla."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    B, n_seg = m1.shape

    def kernel(len_ref, m1_ref, m2_ref, cnt_ref, suf_ref,
               ends_ref, n_ref, amb_ref):
        b = pl.program_id(0)
        L = len_ref[b]

        def body(state):
            i, s, amb = state
            t = _segment(cfg, z, n_seg, s)
            e, a = _step(cfg, z, n_seg, L, s, m1_ref[b, t], m2_ref[b, t],
                         cnt_ref[b, t], suf_ref[b, t])
            ends_ref[b, i] = e
            return i + 1, e, amb | a.astype(jnp.int32)

        def cond(state):
            i, s, _ = state
            return (s < L) & (i < c_pad)

        z32 = jnp.int32(0)
        n, _, amb = jax.lax.while_loop(cond, body, (z32, z32, z32))
        n_ref[b] = n
        amb_ref[b] = amb

    return pl.pallas_call(
        kernel,
        grid=(B,),
        out_shape=[jax.ShapeDtypeStruct((B, c_pad), jnp.int32),
                   jax.ShapeDtypeStruct((B,), jnp.int32),
                   jax.ShapeDtypeStruct((B,), jnp.int32)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="cdc_walk",
    )(lengths, m1, m2, cnt, suf)


def stage1_body(plan: Stage1Plan, impls, with_anchors: bool = False,
                slack_words: int = 0):
    """Traceable stage 1: (rows (B*P//128, 128) u8 — parts flattened
    part-major into 128-byte rows, lengths (B,) i32) -> (sizes (B, c_pad),
    n (B,), amb (B,), bins or None, words2d (R2, 128) u32).

    sizes[b, i] for i < n[b] are the chunk sizes of part b in order;
    entries past n are 0.  amb[b] != 0 means lane b's cuts may be wrong
    (3+ candidates crowded a segment) and the host must re-chunk that
    lane exactly (see repair_lane).  ``words2d`` is the word-row relayout
    of the batch stage 3 reads (``slack_words`` of zero pad); ``bins``
    (with_anchors) are the per-256-byte-bin gram-hash argmins the fast
    compression tier consumes (device_match.bin_mins_from_words)."""
    import jax.numpy as jnp

    cfg, B, P, z = plan.cfg, plan.lanes, plan.part_bytes, plan.z
    c_pad = plan.c_pad
    assert P % z == 0, (P, z)

    def body(rows_u8, lengths):
        lengths = lengths.astype(jnp.int32)
        m1, m2, cnt, suf = _scan(rows_u8.reshape(B, P), lengths, cfg, z)
        if impls.walk == "triton":
            ends, n, amb = _walk_triton(m1, m2, cnt, suf, lengths, cfg, z,
                                        c_pad, interpret=impls.interpret)
        else:
            ends, n, amb = _walk_xla(m1, m2, cnt, suf, lengths, cfg, z,
                                     c_pad)
        idx = jnp.arange(c_pad, dtype=jnp.int32)[None, :]
        starts = jnp.concatenate(
            [jnp.zeros((B, 1), jnp.int32), ends[:, :-1]], axis=1)
        sizes = jnp.where(idx < n[:, None], ends - starts, 0)
        words2d = words_from_rows(rows_u8, slack_words)
        bins = None
        if with_anchors:
            from longtail_jax.parallel.device_match import (
                bin_mins_from_words,
            )

            bins = bin_mins_from_words(words2d.reshape(-1), B * P // 4)
        return sizes, n, amb, bins, words2d

    return body


def sizes_pack_u16(plan: Stage1Plan) -> bool:
    """True when the packed stage-1 fetch stores (size-1) as u16 pairs."""
    return plan.cfg.max_size <= (1 << 16)


def pack_sizes(sizes, n, amb, plan: Stage1Plan):
    """(sizes, n, amb) -> one (B, ...) i32 array for a single D2H fetch:
    sizes as (size-1) u16 pairs when the geometry allows, then n, amb."""
    import jax.numpy as jnp

    if sizes_pack_u16(plan):
        idx = jnp.arange(plan.c_pad, dtype=jnp.int32)[None, :]
        sm1 = jnp.where(idx < n[:, None], sizes - 1, 0)
        sizes = sm1[:, 0::2] | (sm1[:, 1::2] << 16)
    return jnp.concatenate([sizes, n[:, None], amb[:, None]], axis=1)


def unpack_stage1(packed: np.ndarray, plan: Stage1Plan):
    """Decode the packed stage-1 fetch -> (sizes i32 (B, c_pad), n, amb)."""
    c_pad = plan.c_pad
    if sizes_pack_u16(plan):
        pairs = packed[:, : c_pad // 2].astype(np.uint32)
        n = packed[:, c_pad // 2]
        amb = packed[:, c_pad // 2 + 1]
        sizes = np.empty((packed.shape[0], c_pad), np.int32)
        sizes[:, 0::2] = (pairs & 0xFFFF).astype(np.int32)
        sizes[:, 1::2] = (pairs >> 16).astype(np.int32)
        idx = np.arange(c_pad, dtype=np.int32)[None, :]
        sizes = np.where(idx < n[:, None], sizes + 1, 0)
        return sizes, n.copy(), amb
    return (packed[:, :c_pad].copy(), packed[:, c_pad].copy(),
            packed[:, c_pad + 1])


@functools.lru_cache(maxsize=32)
def make_stage1_fn(plan: Stage1Plan, impls, with_anchors: bool = False,
                   slack_words: int = 0):
    """ONE jitted dispatch per batch: (rows, lengths) -> (packed (B, ...)
    i32 — pack_sizes layout, its D2H copy already started — bins or None,
    words2d).  The program runs on the device its committed inputs live
    on (the mesh data plane pins one pipeline per device)."""
    import jax

    body = stage1_body(plan, impls, with_anchors, slack_words)

    @jax.jit
    def program(rows_u8, lengths):
        sizes, n, amb, bins, words2d = body(rows_u8, lengths)
        return pack_sizes(sizes, n, amb, plan), bins, words2d

    def fn(rows_u8, lengths):
        packed, bins, words2d = program(rows_u8, lengths)
        packed.copy_to_host_async()
        return packed, bins, words2d

    fn.program = program
    return fn


def repair_lane(part_bytes_u8: np.ndarray, cfg: ChunkerConfig) -> np.ndarray:
    """Exact host re-chunk of one flagged lane; returns chunk sizes."""
    from longtail_jax.ops.cdc import chunk_part

    ends = chunk_part(part_bytes_u8, cfg.min_size, cfg.avg_size,
                      cfg.max_size)
    return np.diff(np.concatenate([[0], ends])).astype(np.int32)
