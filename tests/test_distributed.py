"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")


def test_dryrun_multichip_8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    import __graft_entry__ as g
    g.dryrun_multichip(8)


def test_entry_compiles():
    """entry() is the production device plane, in the forms the seam
    picks for this backend, as one jittable step: (sizes, n_chunks, lane-0
    BLAKE3 lo/hi) — checked vs the host oracle."""
    import __graft_entry__ as g
    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    sizes, n, lo, hi = [np.asarray(x) for x in out]
    assert sizes.shape[0] == n.shape[0]
    assert lo.shape == hi.shape

    from longtail_jax.ops import blake3, cdc
    from longtail_jax.parallel.device_chunker import ChunkerConfig

    cfg = ChunkerConfig.from_target(1024)
    rows_u8, lengths = args
    B, P = n.shape[0], rows_u8.size // n.shape[0]
    flat = rows_u8.reshape(-1)
    data0 = flat[: int(lengths[0])]
    ends0 = cdc.chunk_part(data0, cfg.min_size, cfg.avg_size, cfg.max_size)
    ref_sizes = np.diff(np.concatenate([[0], ends0]))
    np.testing.assert_array_equal(sizes[0, : n[0]], ref_sizes)
    st0 = np.concatenate([[0], ends0[:-1]]).astype(np.int64)
    want = blake3.hash64_ranges(data0, st0, ref_sizes.astype(np.int64))
    got = lo[: len(ref_sizes)].astype(np.uint64) | (
        hi[: len(ref_sizes)].astype(np.uint64) << np.uint64(32))
    np.testing.assert_array_equal(got, want)


def test_sharded_matches_unsharded():
    """ends/sizes from the sharded step == single-device index_parts."""
    from jax.sharding import Mesh
    from longtail_jax.parallel.device_chunker import (
        ChunkerConfig, make_index_parts_fn)
    from longtail_jax.parallel.distributed import make_sharded_index_fn

    n = min(4, len(jax.devices()))
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("d",))
    cfg = ChunkerConfig.from_target(1024)
    rng = np.random.default_rng(5)
    B, P = 2 * n, 1024 * 4
    parts = rng.integers(0, 256, size=(B, P), dtype=np.uint8)
    lengths = np.full((B,), P, dtype=np.int32)
    lengths[1] = 57

    ends_s, sizes_s, _, _, _ = make_sharded_index_fn(cfg, mesh)(parts, lengths)
    ends_1, sizes_1, _, _ = make_index_parts_fn(cfg)(parts, lengths)
    np.testing.assert_array_equal(np.asarray(ends_s), np.asarray(ends_1))
    np.testing.assert_array_equal(np.asarray(sizes_s), np.asarray(sizes_1))


def test_mesh_part_indexer_matches_single_and_pins_devices():
    """MeshPartIndexer: global submission order preserved, results
    bit-identical to the single-device pipeline, and each sub-indexer's
    batches committed to its own mesh device."""
    from longtail_jax.parallel.pipeline import (
        DevicePartIndexer,
        MeshPartIndexer,
    )

    devices = jax.devices()[: min(4, len(jax.devices()))]
    target = 1024
    mesh_ix = MeshPartIndexer(target, devices, lanes=2)
    single = DevicePartIndexer(target, lanes=2)

    rng = np.random.default_rng(13)
    P = mesh_ix.part_bytes
    parts = [(i, rng.integers(0, 256, size=n, dtype=np.uint8))
             for i, n in enumerate(
                 [P, P // 2 + 13, 1, 700, P - 1, P // 3, 4096, P])]

    got = list(mesh_ix.index_stream(iter(parts), prefetch_depth=0))
    want = list(single.index_stream(iter(parts), prefetch_depth=0))
    assert [t for t, _, _ in got] == [t for t, _ in parts]
    for (tg, sg, hg), (tw, sw, hw) in zip(got, want):
        assert tg == tw
        np.testing.assert_array_equal(sg, sw)
        np.testing.assert_array_equal(hg, hw)

    # pinning: a submitted batch's rows land on the sub-indexer's device
    for k, ix in enumerate(mesh_ix.indexers):
        e = ix.submit_host([(0, parts[0][1])])
        assert e[1].devices() == {devices[k]}


def test_mesh_upsync_byte_identical_to_host():
    """api.upsync over a CPU mesh == host upsync, byte for byte (the
    dryrun's core assertion, as a fast unit test)."""
    from jax.sharding import Mesh
    from longtail_jax import api
    from longtail_jax.stores.fsblockstore import FSBlockStore
    from longtail_jax.stores.storage import MemStorage, ensure_parent_dirs

    n = min(4, len(jax.devices()))
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("d",))
    rng = np.random.default_rng(23)
    st = MemStorage()
    st.create_dir("src")
    for path, size in [("a.bin", 1024 * 1024 + 17), ("b/c.bin", 2048),
                       ("empty", 0)]:
        ensure_parent_dirs(st, f"src/{path}")
        st.write(f"src/{path}",
                 rng.integers(0, 256, size, np.uint8).tobytes())

    def run(mesh_arg, tag):
        store = FSBlockStore(st, f"st_{tag}")
        vi, _ = api.upsync(st, "src", store, target_chunk_size=1024,
                           mesh=mesh_arg)
        return vi.to_bytes()

    assert run(mesh, "m") == run(None, "s")
