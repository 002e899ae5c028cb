"""Jittable single-device CDC chunk+hash step.

Data-parallel re-derivation of the reference chunking hot loop (``ChunkAssets``
src/longtail.c:2343-2550 + ``Longtail_HPCDCNextChunk``
lib/hpcdcchunker/longtail_hpcdcchunker.c:289-306):

- **Phase 1 — candidate scan.** The rolling hash at position ``p`` is a pure
  function of the 48-byte window ending at ``p`` (see ops/cdc.py for the
  telescoping proof), so every position's hash is computed in parallel as a
  48-tap XOR filter over the table-mapped byte stream: pure elementwise
  work, no sequential dependency.
- **Phase 2 — cut resolution.** The min/max-length constraint is sequential
  per part, but each step is O(1): precompute ``nexts[p]`` = smallest
  candidate cut-end at position >= p with a reverse cumulative minimum
  (``lax.cummin``), then walk ``s -> min(nexts[s+min], s+max)`` in a
  ``lax.scan`` of at most ``P // (min+1) + 1`` steps, vectorized over lanes.
- **Phase 3 — chunk hashing.** Resolved chunks gather into padded
  (lanes, max_size) batches feeding the batched BLAKE3 tree hasher
  (ops/blake3.py), masked by true length.

All shapes are static; the whole step jits to one XLA program. Bit-exactness
vs the sequential reference walk is enforced by tests/test_parallel.py.

``index_parts`` is the single-dispatch form (gathers every chunk padded to
max_size — fine for small parts, quadratic-ish waste for big ones). The
production path for large parts is parallel/pipeline.py (stage 1 on
per-segment summaries, stage 3 per power-of-two size class), whose packed
chunks take ~2x the payload instead of max_chunks * max_size.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from longtail_jax.formats.constants import (
    CHUNKER_WINDOW_SIZE as WINDOW,
    chunker_params_from_target,
)
from longtail_jax.ops import blake3 as _blake3
from longtail_jax.ops.cdc import HASH_TABLE, discriminator_from_avg

_LEAF = 1024
_BIG = np.int32(2**31 - 1)


@dataclasses.dataclass(frozen=True)
class ChunkerConfig:
    """Static chunking geometry (hashable: baked into the jit cache key)."""
    min_size: int
    avg_size: int
    max_size: int

    @classmethod
    def from_target(cls, target_chunk_size: int) -> "ChunkerConfig":
        mn, av, mx = chunker_params_from_target(target_chunk_size)
        return cls(mn, av, mx)

    @property
    def discriminator(self) -> int:
        return discriminator_from_avg(float(self.avg_size))

    def max_chunks(self, part_bytes: int) -> int:
        # every chunk but the last spans >= min_size + 1 bytes
        return part_bytes // (self.min_size + 1) + 1

    @property
    def padded_chunk(self) -> int:
        return -(-self.max_size // _LEAF) * _LEAF


def candidate_mask(parts_u8, *, discriminator: int):
    """Phase 1: (B, P) uint8 -> (B, P) bool cut-candidate mask.

    mask[b, p] is True iff the rolling hash of the window ending at p fires
    (cut end = p + 1). Positions < WINDOW-1 are forced False (never consulted
    by resolution anyway since min_size >= WINDOW).
    """
    import jax.numpy as jnp

    u32 = jnp.uint32
    tv = jnp.asarray(HASH_TABLE, dtype=u32)[parts_u8.astype(jnp.int32)]
    P = parts_u8.shape[-1]
    acc = jnp.zeros_like(tv)
    for i in range(WINDOW):
        r = i % 32
        term = tv if r == 0 else (tv << u32(r)) | (tv >> u32(32 - r))
        if i:
            term = jnp.pad(term[..., : P - i], ((0, 0), (i, 0)))
        acc = acc ^ term
    d = u32(discriminator)
    mask = (acc % d) == (d - u32(1))
    pos = jnp.arange(P, dtype=jnp.int32)
    return mask & (pos >= WINDOW - 1)


def next_candidate_ends(mask, lengths):
    """(B, P) mask + (B,) lengths -> (B, P) nexts: nexts[b, q] = smallest
    cut-end p+1 with p >= q and mask[b, p], else _BIG. Candidates at or past
    the part length are suppressed."""
    import jax.numpy as jnp

    import jax

    P = mask.shape[-1]
    pos = jnp.arange(P, dtype=jnp.int32)
    live = mask & (pos[None, :] < lengths.astype(jnp.int32)[:, None])
    ce = jnp.where(live, pos[None, :] + 1, _BIG)
    return jax.lax.cummin(ce, axis=1, reverse=True)


def resolve_ends(nexts, lengths, cfg: ChunkerConfig, max_chunks: int):
    """Phase 2: walk the min/max constraints (resolve_cuts semantics,
    ops/cdc.py) vectorized over lanes. Returns (B, max_chunks) int32
    non-decreasing end offsets; chunk i covers [ends[i-1], ends[i]) and
    zero-width entries are padding."""
    import jax
    import jax.numpy as jnp

    B, P = nexts.shape
    L = lengths.astype(jnp.int32)
    mn = jnp.int32(cfg.min_size)
    mx = jnp.int32(cfg.max_size)

    def step(s, _):
        remaining = L - s
        lo_idx = s + mn  # index q: candidate ends >= s + min + 1
        e_cand = jnp.take_along_axis(
            nexts, jnp.clip(lo_idx, 0, P - 1)[:, None], axis=1)[:, 0]
        limit = jnp.where(remaining > mx, s + mx, L)
        use_cand = (lo_idx < P) & (e_cand <= limit)
        e = jnp.where(use_cand, e_cand, limit)
        e = jnp.where(remaining <= mn, L, e)
        e = jnp.where(s < L, e, s)  # finished lanes stay put
        return e, e

    # init derives from L so it carries L's varying-axes type under shard_map
    _, ends = jax.lax.scan(step, jnp.zeros_like(L), None, length=max_chunks)
    return ends.T  # (B, max_chunks)


def gather_chunks(parts_u8, starts, sizes, padded: int):
    """Phase 3 input prep: gather chunk byte ranges out of their part lanes
    into a (B * max_chunks, padded) batch, zero-padded past each length."""
    import jax.numpy as jnp

    B, P = parts_u8.shape
    idx = starts[..., None] + jnp.arange(padded, dtype=jnp.int32)  # (B,C,pad)
    in_range = idx < (starts + sizes)[..., None]
    flat = jnp.take_along_axis(
        parts_u8[:, None, :], jnp.clip(idx, 0, P - 1).astype(jnp.int32),
        axis=2)
    return jnp.where(in_range, flat, 0).reshape(-1, padded)


def index_parts(parts_u8, lengths, cfg: ChunkerConfig):
    """Full device step: (B, P) uint8 parts + (B,) lengths ->
    (ends (B,C) i32, sizes (B,C) i32, hash_lo (B*C,) u32, hash_hi (B*C,) u32).

    Entries with sizes == 0 are padding (a real chunk is never empty).
    """
    import jax.numpy as jnp

    B, P = parts_u8.shape
    C = cfg.max_chunks(P)
    mask = candidate_mask(parts_u8, discriminator=cfg.discriminator)
    nexts = next_candidate_ends(mask, lengths)
    ends = resolve_ends(nexts, lengths, cfg, C)
    starts = jnp.concatenate(
        [jnp.zeros((B, 1), jnp.int32), ends[:, :-1]], axis=1)
    sizes = ends - starts
    chunks = gather_chunks(parts_u8, starts, sizes, cfg.padded_chunk)
    lo, hi = _blake3.hash_chunks_u32(chunks, sizes.reshape(-1), xp=jnp)
    return ends, sizes, lo, hi


@functools.lru_cache(maxsize=8)
def make_index_parts_fn(cfg: ChunkerConfig):
    """jit-compiled index_parts closed over a static config."""
    import jax
    return jax.jit(lambda p, l: index_parts(p, l, cfg))
