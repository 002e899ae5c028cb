"""The stage-1 cut walk over per-segment summaries: the card's Triton
kernel (interpret mode) vs the XLA while_loop reference vs the host's
sequential resolver (ops/cdc.resolve_cuts) on the same candidates.

Summaries are built here from synthetic candidate lists, so each case
targets one rule: parts shorter than or equal to min_size, forced
max_size cuts, ordinary cuts, and segments crowded with 3+ candidates
(the ambiguity flag, which both walks must raise alike)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from longtail_jax.ops.cdc import resolve_cuts  # noqa: E402
from longtail_jax.parallel.device_chunker import ChunkerConfig  # noqa: E402
from longtail_jax.parallel.stage1 import (  # noqa: E402
    _BIG,
    Stage1Plan,
    _walk_triton,
    _walk_xla,
)

CFG = ChunkerConfig.from_target(1024)      # min 128, max 2048
P = 16384


def _summaries(cands, lengths, z):
    """Per-segment (min1, min2, cnt, suf) of candidate cut ENDS (p + 1)
    below each lane's length, as the scan computes them."""
    B, n_seg = len(cands), P // z
    m1 = np.full((B, n_seg), _BIG, np.int32)
    m2 = np.full((B, n_seg), _BIG, np.int32)
    cnt = np.zeros((B, n_seg), np.int32)
    for b, pos in enumerate(cands):
        for p in sorted(p for p in pos if p < lengths[b]):
            t, e = p // z, p + 1
            cnt[b, t] += 1
            if e < m1[b, t]:
                m1[b, t], m2[b, t] = e, m1[b, t]
            elif e < m2[b, t]:
                m2[b, t] = e
    suf = np.full((B, n_seg), _BIG, np.int32)
    for t in range(n_seg - 2, -1, -1):
        suf[:, t] = np.minimum(suf[:, t + 1], m1[:, t + 1])
    return m1, m2, cnt, suf


def _walks(cands, lengths):
    plan = Stage1Plan(CFG, len(cands), P)
    lengths = np.asarray(lengths, np.int32)
    summ = _summaries(cands, lengths, plan.z)
    out = {}
    for name, form, extra in (("triton", _walk_triton, {"interpret": True}),
                              ("xla", _walk_xla, {})):
        fn = jax.jit(lambda *a, form=form, extra=extra: form(
            *a, CFG, plan.z, plan.c_pad, **extra))
        ends, n, amb = (np.asarray(x) for x in fn(*summ, lengths))
        out[name] = ([ends[b, : n[b]] for b in range(len(cands))], amb)
    return out


def _check(cands, lengths, expect_amb=None):
    out = _walks(cands, lengths)
    (ends_t, amb_t), (ends_x, amb_x) = out["triton"], out["xla"]
    np.testing.assert_array_equal(amb_t, amb_x)
    for b, ln in enumerate(lengths):
        np.testing.assert_array_equal(ends_t[b], ends_x[b])
        if not amb_t[b]:
            want = resolve_cuts(np.asarray(sorted(cands[b]), np.int64), ln,
                                CFG.min_size, CFG.max_size)
            np.testing.assert_array_equal(ends_t[b], want)
    if expect_amb is not None:
        np.testing.assert_array_equal(amb_t != 0, expect_amb)
    return ends_t


def test_walk_short_parts():
    """Empty, one-byte, < min, = min and min + 1 byte parts: one chunk
    each (none for the empty part)."""
    mn = CFG.min_size
    lengths = [0, 1, mn - 1, mn, mn + 1]
    ends = _check([[10, 60, 100]] * len(lengths), lengths)
    assert [len(e) for e in ends] == [0, 1, 1, 1, 1]


def test_walk_forced_max_cuts():
    """No candidates: every cut is forced at max_size."""
    ends = _check([[], []], [P, P - 5])
    np.testing.assert_array_equal(
        ends[0], np.arange(CFG.max_size, P + 1, CFG.max_size))


def test_walk_random_candidates():
    """Sparse random candidates at about the average chunk rate, on full
    and ragged lanes."""
    rng = np.random.default_rng(7)
    cands = [sorted(set(rng.integers(0, P, P // CFG.avg_size).tolist()))
             for _ in range(4)]
    _check(cands, [P, P - 1, P // 2 + 3, 3 * CFG.min_size])


def test_walk_crowded_segments():
    """Segments holding 3+ candidates: the walk flags the lane exactly
    when both kept ends precede the query, and never otherwise."""
    z = Stage1Plan(CFG, 1, P).z
    first = 2 * z - 57                     # first cut end, mid-segment
    q = first + CFG.min_size               # next query: ends > q
    t0 = (q // z) * z                      # q's segment
    assert t0 + 20 < q
    crowded = [first - 1, t0 + 3, t0 + 13, q + 2]   # 2 kept ends <= q
    clear = [first - 1, t0 + 3, q + 2, q + 9]       # 2nd kept end > q
    _check([crowded, clear], [P, P], expect_amb=[True, False])
