"""Multi-chip sharding: the distributed analog of the reference's thread-pool
fan-out (SURVEY §2.5).

The reference is single-node: Bikeshed threads chunk file parts and the only
cross-process coordination is a filesystem lock. Scaling the same workload
over a device mesh is a data-parallel + collective problem:

- file parts are batched into ``(lanes, part_bytes)`` buffers and the lane
  axis is sharded over the device mesh (``shard_map``) — each chip runs the
  full chunk-scan + cut-resolution + BLAKE3 step on its lanes;
- global dedup (the role NCCL/MPI would play in a port) is a collective:
  every chip ``all_gather``s the per-shard chunk-hash lists, then
  sorts and uniques the combined set — replicated output, so any host can
  assemble the store/version index without further exchange.  Chunking
  and dedup run as two programs (``_chunk_program``, then the collective).

Hashes travel as (lo, hi) u32 pairs (XLA's native lane width); sorting uses
a single 64-bit f-ordering key built from the pair.
"""

from __future__ import annotations

import functools

import numpy as np

from longtail_jax.parallel.device_chunker import ChunkerConfig, index_parts


def _mesh_axis(mesh):
    assert len(mesh.axis_names) == 1, "one data axis expected"
    return mesh.axis_names[0]


@functools.lru_cache(maxsize=4)
def _chunk_program(cfg: ChunkerConfig, mesh):
    """One program: every device chunks + hashes its own lanes
    (index_parts).  (B, P) u8 parts + (B,) lengths -> ends, sizes, lo, hi,
    each (B, C) and sharded by lane.

    It compiles apart from the dedup collectives below: at 2 lanes x 1 MiB
    per device, XLA's GPU compiler took 45 s for the two programs, and did
    not finish one program holding both within 240 s (PERF.md,
    Findings)."""
    import jax
    from jax.sharding import PartitionSpec as P

    axis = _mesh_axis(mesh)

    def local(parts_l, lengths_l):
        ends, sizes, lo, hi = index_parts(parts_l, lengths_l, cfg)
        return ends, sizes, lo.reshape(sizes.shape), hi.reshape(sizes.shape)

    lane = P(axis, None)
    return jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(lane, P(axis)),
        out_specs=(lane, lane, lane, lane)))


def _unique(lo_g, hi_g, valid_g):
    """Sorted unique valid (lo, hi) pairs compacted to the front, zero past
    the count: (uniq_lo, uniq_hi, n_uniq)."""
    import jax.numpy as jnp

    # sort by the (hi, lo) u32 pair — no 64-bit lanes on device — with
    # valid entries before padding among equal keys (lexsort: last key is
    # primary) so "first of each key group" is a valid entry whenever the
    # group has one
    order = jnp.lexsort((~valid_g, lo_g, hi_g))
    lo_s, hi_s, valid_s = lo_g[order], hi_g[order], valid_g[order]
    first = jnp.concatenate(
        [jnp.ones((1,), bool),
         (lo_s[1:] != lo_s[:-1]) | (hi_s[1:] != hi_s[:-1])])
    keep = first & valid_s
    n_uniq = keep.sum().astype(jnp.int32)
    # compact kept entries to the front; non-kept scatter to a dump slot
    dest = jnp.cumsum(keep.astype(jnp.int32)) - 1
    n = lo_s.shape[0]
    idx = jnp.where(keep, dest, n)
    uniq_lo = jnp.zeros((n + 1,), jnp.uint32).at[idx].set(
        jnp.where(keep, lo_s, 0))[:-1]
    uniq_hi = jnp.zeros((n + 1,), jnp.uint32).at[idx].set(
        jnp.where(keep, hi_s, 0))[:-1]
    return uniq_lo, uniq_hi, n_uniq


@functools.lru_cache(maxsize=4)
def make_sharded_index_fn(cfg: ChunkerConfig, mesh):
    """The full distributed step: chunk + hash every lane on its own
    device, then all-gather every chunk slot and globally dedup.

    (parts (B, P) u8 with B divisible by the mesh size, lengths (B,) i32)
    -> (ends (B, C) i32, sizes (B, C) i32, uniq_lo (N,) u32, uniq_hi (N,)
    u32, uniq_count () i32), N = B * C, entries past uniq_count zero.  The
    unique set is replicated on every device."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    axis = _mesh_axis(mesh)
    chunk = _chunk_program(cfg, mesh)

    def local(sizes, lo, hi):
        valid = sizes.reshape(-1) > 0
        # collective: everyone sees every shard's (lo, hi, valid)
        lo_g = jax.lax.all_gather(jnp.where(valid, lo.reshape(-1), 0), axis,
                                  tiled=True)
        hi_g = jax.lax.all_gather(jnp.where(valid, hi.reshape(-1), 0), axis,
                                  tiled=True)
        valid_g = jax.lax.all_gather(valid, axis, tiled=True)
        return _unique(lo_g, hi_g, valid_g)

    # check_vma=False: the uniq outputs are value-replicated (everyone ran
    # the same sort over the same all-gathered set) but that replication is
    # not statically provable to the vma checker.
    lane = P(axis, None)
    dedup = jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(lane, lane, lane),
        out_specs=(P(), P(), P()), check_vma=False))

    def fn(parts, lengths):
        ends, sizes, lo, hi = chunk(parts, lengths)
        return (ends, sizes) + tuple(dedup(sizes, lo, hi))
    return fn


def default_dedup_slots(cfg: ChunkerConfig, lanes_per_dev: int,
                        part_bytes: int) -> int:
    """~4x the expected chunk count per shard, capped at the worst case."""
    worst = lanes_per_dev * cfg.max_chunks(part_bytes)
    expected = lanes_per_dev * (4 * part_bytes // cfg.avg_size + 8)
    return int(min(worst, expected))


@functools.lru_cache(maxsize=4)
def make_sharded_chunk_fn(cfg: ChunkerConfig, mesh, lanes_per_dev: int,
                          part_bytes: int):
    """Production mesh step for chunk_assets: chunk + hash every lane on
    its own device and run the global-dedup collective over *compacted*
    per-shard hash lists.

    Unlike make_sharded_index_fn (which all-gathers every chunk slot,
    padding included), each shard first compacts its valid (lo, hi) pairs
    to the front and only ``default_dedup_slots`` entries K ride the
    all-gather — ~4x the expected chunk count, with an overflow flag when
    pathological data (everything at min chunk size) exceeds it so the
    host can fall back to host-side dedup.

    (parts, lengths) -> (sizes (B, C) i32 [sharded], lo (B, C) u32
    [sharded], hi (B, C) u32 [sharded], uniq_lo/uniq_hi (n_dev * K,) u32
    [replicated], n_uniq () i32, overflow () i32)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    axis = _mesh_axis(mesh)
    n_dev = mesh.devices.size
    K = default_dedup_slots(cfg, lanes_per_dev, part_bytes)
    chunk = _chunk_program(cfg, mesh)

    def local(sizes, lo, hi):
        valid = sizes.reshape(-1) > 0
        # compact valid entries to the front, keep at most K
        dest = jnp.cumsum(valid.astype(jnp.int32)) - 1
        n_valid = jnp.sum(valid.astype(jnp.int32))
        overflow_l = (n_valid > K).astype(jnp.int32)
        keep = valid & (dest < K)
        idx = jnp.where(keep, dest, K)
        clo = jnp.zeros((K + 1,), jnp.uint32).at[idx].set(
            jnp.where(keep, lo.reshape(-1), 0), mode="drop")[:K]
        chi = jnp.zeros((K + 1,), jnp.uint32).at[idx].set(
            jnp.where(keep, hi.reshape(-1), 0), mode="drop")[:K]
        n_local = jnp.minimum(n_valid, K)
        # collective: compacted lists only (the payload between cards is
        # O(chunks), not O(slots))
        lo_g = jax.lax.all_gather(clo, axis, tiled=True)
        hi_g = jax.lax.all_gather(chi, axis, tiled=True)
        n_g = jax.lax.all_gather(n_local.reshape(1), axis, tiled=True)
        ov = jax.lax.psum(overflow_l, axis)
        slot = jnp.arange(n_dev * K, dtype=jnp.int32)
        valid_g = (slot % K) < jnp.repeat(n_g, K,
                                          total_repeat_length=n_dev * K)
        return _unique(lo_g, hi_g, valid_g) + (ov,)

    lane = P(axis, None)
    dedup = jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(lane, lane, lane),
        out_specs=(P(), P(), P(), P()), check_vma=False))

    def fn(parts, lengths):
        _, sizes, lo, hi = chunk(parts, lengths)
        return (sizes, lo, hi) + tuple(dedup(sizes, lo, hi))
    return fn


def host_unique_hashes(lo: np.ndarray, hi: np.ndarray,
                       count: int) -> np.ndarray:
    """Assemble the replicated device output into host uint64 hashes."""
    h = (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | \
        np.asarray(lo).astype(np.uint64)
    return h[: int(count)]
