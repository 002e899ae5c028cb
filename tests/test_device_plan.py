"""Host-side plan of the device pipeline and the stage-1 program's
outputs, on the CPU.

The fixed-class/spill dispatch host logic runs with numpy fakes in place
of the device calls (a chunk whose class is absent from the plan would be
dropped silently otherwise); the stage-1 program's walk forms, anchor
bins and word rows run against their plain references.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from longtail_jax.parallel import pipeline as pl_mod  # noqa: E402
from longtail_jax.parallel.device_chunker import ChunkerConfig  # noqa: E402
from longtail_jax.parallel.pipeline import (  # noqa: E402
    DevicePartIndexer,
    _pow2_padded,
    class_floor,
    class_plan,
    pow2_cap,
)


@pytest.mark.parametrize("target", [1024, 3072, 24576, 32768])
def test_class_plan_covers_every_padded_class(target):
    """Every _pow2_padded output for sizes in [1, max_size] must be a
    planned class — a chunk whose class is absent from the plan would be
    silently dropped by _dispatch_buckets (non-pow2 max_size, e.g.
    target 24576 -> max 49152)."""
    cfg = ChunkerConfig.from_target(target)
    cap = pow2_cap(cfg.padded_chunk)
    floor = class_floor(cfg)
    plan_classes = {c for c, _ in class_plan(cfg, 64 << 20)}
    sizes = np.unique(np.concatenate([
        np.arange(1, min(cfg.max_size, 4096) + 1),
        np.linspace(1, cfg.max_size, 997).astype(np.int64),
        [cfg.max_size, cfg.max_size - 1, cfg.padded_chunk],
    ]))
    sizes = sizes[(sizes >= 1) & (sizes <= cfg.max_size)]
    padded = _pow2_padded(sizes, cap, floor)
    assert set(np.unique(padded)) <= plan_classes, target
    # and classes are powers of two (the BLAKE3 kernel requires it)
    for c in plan_classes:
        leaves = c // 1024
        assert leaves & (leaves - 1) == 0, c


class _FakeRes:
    """Stands in for one device (rows,) hash-word array."""

    def __init__(self, arr):
        self._arr = np.asarray(arr)

    def copy_to_host_async(self):
        pass

    def __array__(self, dtype=None, copy=None):
        return self._arr if dtype is None else self._arr.astype(dtype)


def _fake_stage3(layout, kind="blake3", impls=None):
    """Mirror of make_stage3_fn's blob contract: (words2d, blob) ->
    (lo, hi) with lo = starts and hi = sizes of every slot."""
    def f(words2d, blob):
        blob = np.asarray(blob)
        los, his, o = [], [], 0
        for _, r in layout:
            los.append(blob[o:o + r])
            his.append(blob[o + r:o + 2 * r])
            o += 2 * r
        return _FakeRes(np.concatenate(los)), _FakeRes(np.concatenate(his))
    return f


def _bucket_rows(buckets):
    """Flatten either bucket format to (hash_arr_2xr, rows) pairs."""
    out = []
    for res, meta in buckets:
        arr = np.stack([np.asarray(x) for x in res])
        if isinstance(meta, list):
            for rows, off, r in meta:
                out.append((arr[:, off:off + r], rows))
        else:
            out.append((arr, meta))
    return out


@pytest.mark.parametrize("target", [1024, 24576])
def test_dispatch_buckets_covers_all_chunks(monkeypatch, target):
    """Host dispatch logic: every chunk row lands in exactly one bucket
    (planned slot or spill), with its own (start, size) — run with numpy
    fakes replacing the device calls."""
    monkeypatch.setattr(pl_mod, "make_stage3_fn", _fake_stage3)
    indexer = DevicePartIndexer(target, lanes=1)
    cfg = indexer.cfg
    rng = np.random.default_rng(5)

    # enough chunks of the most common class to force spill dispatches,
    # plus sizes that exercise the non-pow2 cap class (target 24576:
    # 40000 -> class 65536)
    plan = dict(indexer._class_plan)
    common = cfg.avg_size
    n_common = plan[int(_pow2_padded(
        np.array([common]), indexer._cap, indexer._floor)[0])]
    sizes = [common] * (n_common + n_common // 2 + 3)
    sizes += [cfg.max_size, cfg.max_size - 1, cfg.min_size + 1, 1000]
    if cfg.max_size > 40000:
        sizes += [40000, 33000]
    flat_sizes = np.array(sizes, dtype=np.int64)
    n = len(flat_sizes)
    flat_starts = np.cumsum(np.concatenate([[0], flat_sizes[:-1]]))
    padded = _pow2_padded(flat_sizes, indexer._cap, indexer._floor)

    buckets = indexer._dispatch_buckets(
        None, flat_starts, flat_sizes, padded)

    seen = np.zeros(n, dtype=np.int32)
    for arr, rows in _bucket_rows(buckets):
        k = len(rows)
        np.testing.assert_array_equal(arr[0][:k], flat_starts[rows])
        np.testing.assert_array_equal(arr[1][:k], flat_sizes[rows])
        seen[rows] += 1
    np.testing.assert_array_equal(seen, np.ones(n, dtype=np.int32))


def test_retire_assembles_bucket_hashes(monkeypatch):
    """retire() must place every bucket's hashes at the right chunk index
    and yield per-part slices in submission order."""
    monkeypatch.setattr(pl_mod, "make_stage3_fn", _fake_stage3)
    indexer = DevicePartIndexer(1024, lanes=1)

    counts = np.array([3, 2], dtype=np.int64)
    lane_sizes = [np.array([1024, 2048, 512], np.uint32),
                  np.array([600, 1024], np.uint32)]
    flat_sizes = np.concatenate(lane_sizes).astype(np.int64)
    flat_starts = np.cumsum(np.concatenate([[0], flat_sizes[:-1]]))
    padded = _pow2_padded(flat_sizes, indexer._cap, indexer._floor)
    buckets = indexer._dispatch_buckets(
        None, flat_starts, flat_sizes, padded)
    entry = (["a", "b"], lane_sizes, counts, buckets)
    out = list(indexer.retire(entry))
    assert [t for t, _, _ in out] == ["a", "b"]
    got = np.concatenate([h for _, _, h in out])
    want = flat_starts.astype(np.uint64) | (
        flat_sizes.astype(np.uint64) << np.uint64(32))
    np.testing.assert_array_equal(got, want)


def _tiny_plan():
    from longtail_jax.parallel.stage1 import Stage1Plan

    cfg = ChunkerConfig.from_target(1024)
    return Stage1Plan(cfg, lanes=8, part_bytes=16384)


def _tiny_batch(plan, seed, lengths=None):
    B, P = plan.lanes, plan.part_bytes
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 256, (B * P // 128, 128), dtype=np.uint8)
    if lengths is None:
        lengths = np.full((B,), P, dtype=np.int32)
    flat = rows.reshape(-1)
    for b, ln in enumerate(lengths):           # zero past each length
        flat[b * P + ln: (b + 1) * P] = 0
    return rows, np.asarray(lengths, np.int32)


def test_stage1_triton_walk_interpret_matches_xla_walk():
    """The stage-1 program with the card's Triton walk (interpret mode)
    vs the same program with the XLA while_loop walk, and both vs the
    host chunker on every lane they do not flag."""
    from longtail_jax.parallel import backend
    from longtail_jax.parallel.stage1 import (
        make_stage1_fn,
        repair_lane,
        unpack_stage1,
    )

    plan = _tiny_plan()
    B, P = plan.lanes, plan.part_bytes
    rows, lengths = _tiny_batch(plan, 17, [
        P, P - 137, P // 2, plan.cfg.min_size, 1, 700, P, P - 1])
    flat = rows.reshape(-1)
    got = {}
    for impls in (backend.rehearsal(), backend.CPU):
        packed = np.asarray(make_stage1_fn(plan, impls)(rows, lengths)[0])
        got[impls.walk] = unpack_stage1(packed, plan)
    for name in ("sizes", "n", "amb"):
        i = ("sizes", "n", "amb").index(name)
        np.testing.assert_array_equal(got["triton"][i], got["xla"][i])
    sizes, n, amb = got["triton"]
    for b in range(B):
        want = repair_lane(flat[b * P: b * P + lengths[b]], plan.cfg)
        if not amb[b]:
            np.testing.assert_array_equal(sizes[b, : n[b]], want)


def test_gather_chunk_words_matches_numpy():
    """The plain pack vs a numpy gather: chunk bytes at arbitrary
    (unaligned) offsets must land at offset 0, zeroed past size."""
    import jax.numpy as jnp

    from longtail_jax.parallel.pipeline import gather_chunk_words
    from longtail_jax.parallel.stage1 import words_from_rows

    padded, n_bytes = 2048, 64 << 10
    rng = np.random.default_rng(23)
    data = rng.integers(0, 256, n_bytes, dtype=np.uint8)
    words2d = words_from_rows(jnp.asarray(data.reshape(-1, 128)),
                              padded // 4 + 2048)
    starts = np.array([0, 1, 3, 4095, 4096, 4097, 60000, 61337],
                      dtype=np.int32)
    sizes = np.array([2048, 2047, 1, 2048, 512, 1025, 2048, 1000],
                     dtype=np.int32)
    packed = np.asarray(jax.jit(
        lambda w, s, z: gather_chunk_words(w.reshape(-1), s, z, padded))(
            words2d, starts, sizes))
    flat = np.zeros(n_bytes + padded + 8192, np.uint8)
    flat[:n_bytes] = data
    for r in range(len(starts)):
        want = np.zeros(padded, np.uint8)
        want[: sizes[r]] = flat[starts[r]: starts[r] + sizes[r]]
        got = packed[r].astype("<u4").view(np.uint8)
        np.testing.assert_array_equal(got, want, err_msg=f"row {r}")


def test_stage1_bins_match_words_oracle():
    """The stage-1 program's anchor bin-mins equal
    device_match.bin_mins_from_words on the same bytes, and asking for
    them leaves the chunk output unchanged."""
    from longtail_jax.parallel import backend
    from longtail_jax.parallel.device_match import bin_mins_from_words
    from longtail_jax.parallel.stage1 import make_stage1_fn

    plan = _tiny_plan()
    B, P = plan.lanes, plan.part_bytes
    rows, lengths = _tiny_batch(plan, 31)
    packed, bins, _ = make_stage1_fn(plan, backend.CPU, with_anchors=True)(
        rows, lengths)

    import jax.numpy as jnp
    words = jnp.asarray(
        np.ascontiguousarray(rows).view("<u4").reshape(-1))
    want = np.asarray(bin_mins_from_words(words, B * P // 4))
    np.testing.assert_array_equal(np.asarray(bins).reshape(-1), want)
    packed2 = np.asarray(make_stage1_fn(plan, backend.CPU)(rows, lengths)[0])
    np.testing.assert_array_equal(np.asarray(packed), packed2)


def test_stage1_words_output_is_flat_relayout():
    """The stage-1 program's words2d output is exactly the flat
    row-major little-endian u32 relayout of the byte rows, with >= the
    requested slack rows of zeros appended."""
    from longtail_jax.parallel import backend
    from longtail_jax.parallel.stage1 import (
        make_stage1_fn,
        padded_words_rows,
    )

    plan = _tiny_plan()
    rows, lengths = _tiny_batch(plan, 41)
    slack = 4096
    _, _, words2d = make_stage1_fn(plan, backend.CPU, slack_words=slack)(
        rows, lengths)
    words2d = np.asarray(words2d)
    want = rows.reshape(-1).view("<u4").reshape(-1, 128)
    real = want.shape[0]
    assert words2d.shape == (padded_words_rows(rows.shape[0], slack), 128)
    assert words2d.shape[0] >= real + slack // 128
    np.testing.assert_array_equal(words2d[:real], want)
    assert not words2d[real:].any()
