"""Card-only exactness: the compiled device stages against the host
oracle ON the card (``LT_TESTS_GPU=1 python -m pytest -m gpu tests/``;
``chip_smoke.py`` runs them too).

The CPU suite runs the plain references and the Triton kernels in
interpret mode; these tests pin what the card really compiles — the
stage-1 program with the Triton walk, the Triton BLAKE3 kernel, the
anchor scan and the entropy pack — the ChunkerLargeFile conformance
philosophy (reference test/test.cpp:3363).  Each skips without a card.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

pytestmark = pytest.mark.gpu


def test_device_pipeline_bit_exact_on_gpu(gpu):
    """Full chunk+hash pipeline on the card vs native CDC + BLAKE3."""
    from longtail_jax.formats.constants import chunker_params_from_target
    from longtail_jax.ops import blake3, cdc
    from longtail_jax.parallel.pipeline import DevicePartIndexer

    target = 32768
    indexer = DevicePartIndexer(target)
    B, P = indexer.lanes, indexer.part_bytes
    rng = np.random.default_rng(3)
    # structured lanes: random, periodic, zeros-with-noise-tail
    lanes = [rng.integers(0, 256, P, np.uint8)]
    tile = rng.integers(0, 256, 4352, np.uint8)
    lanes.append(np.tile(tile, P // 4352 + 1)[:P])
    z = np.zeros(P, np.uint8)
    z[P // 2:] = rng.integers(0, 256, P - P // 2, np.uint8)
    lanes.append(z)
    mn, av, mx = chunker_params_from_target(target)
    parts = [(i, lanes[i % len(lanes)][: P - 13 * i])
             for i in range(B * 2)]
    for (tag, sizes, hashes), (_, data) in zip(
            indexer.index_stream(iter(parts)), parts):
        ends = cdc.chunk_part(data, mn, av, mx)
        ref_sizes = np.diff(np.concatenate([[0], ends]))
        np.testing.assert_array_equal(sizes.astype(np.int64), ref_sizes)
        starts = np.concatenate([[0], ends[:-1]]).astype(np.int64)
        ref = blake3.hash64_ranges(data, starts,
                                   ref_sizes.astype(np.int64))
        np.testing.assert_array_equal(hashes, ref)


def test_walk_kernel_on_gpu_matches_xla_walk(gpu):
    """The compiled Triton walk vs the XLA while_loop walk over the same
    segment summaries, lane lengths from empty to a full part."""
    from longtail_jax.parallel.device_chunker import ChunkerConfig
    from longtail_jax.parallel.stage1 import (
        Stage1Plan,
        _scan,
        _walk_triton,
        _walk_xla,
    )

    cfg = ChunkerConfig.from_target(32768)
    B, P = 4, 32 << 20
    plan = Stage1Plan(cfg, B, P)
    rng = np.random.default_rng(21)
    parts = rng.integers(0, 256, (B, P), dtype=np.uint8)
    lengths = np.array([P, P - 4097, cfg.min_size, 1], np.int32)
    summ = jax.jit(lambda p, l: _scan(p, l, cfg, plan.z))(parts, lengths)

    def walk(form):
        return jax.jit(lambda *a: form(*a, cfg, plan.z, plan.c_pad))(
            *summ, lengths)

    ends_t, n_t, amb_t = walk(_walk_triton)
    ends_x, n_x, amb_x = walk(_walk_xla)
    n = np.asarray(n_x)
    np.testing.assert_array_equal(np.asarray(n_t), n)
    np.testing.assert_array_equal(np.asarray(amb_t), np.asarray(amb_x))
    for b in range(B):
        np.testing.assert_array_equal(np.asarray(ends_t)[b, : n[b]],
                                      np.asarray(ends_x)[b, : n[b]])


def test_anchor_scan_on_gpu_yields_valid_lz4(gpu):
    from longtail_jax.ops import lz4
    from longtail_jax.parallel.device_lz4 import ROW_BYTES, compress_block

    rng = np.random.default_rng(5)
    tile = rng.integers(0, 256, 24 << 10, np.uint8).tobytes()
    src = (tile * 40 + rng.integers(0, 256, 1 << 20, np.uint8).tobytes()
           )[: 4 * ROW_BYTES]
    out = compress_block(src)
    assert lz4.decompress(out, len(src)) == src
    assert len(out) < len(src) // 2


def test_blake3_kernel_on_gpu_known_answers(gpu):
    """The compiled stage-3 BLAKE3 kernel vs the native host hasher,
    over every size class of the default geometry at unaligned starts."""
    from longtail_jax.ops import blake3
    from longtail_jax.ops.blake3_kernel import hash_layout

    rng = np.random.default_rng(9)
    layout = ((8192, 256), (16384, 256), (32768, 256), (65536, 256))
    data = rng.integers(0, 256, 64 << 20, np.uint8)
    starts, sizes = [], []
    for cls, rows in layout:
        sz = rng.integers(cls // 2 + 1, cls + 1, rows).astype(np.int32)
        sz[-7:] = 0                                 # padding rows last
        starts.append(rng.integers(0, len(data) - cls, rows)
                      .astype(np.int32))
        sizes.append(sz)
    blob = np.concatenate([a for p in zip(starts, sizes) for a in p])
    words = np.concatenate([data, np.zeros(1 << 20, np.uint8)]).view("<u4")
    lo, hi = jax.jit(lambda w, b: hash_layout(w, b, layout))(words, blob)
    got = np.asarray(lo).astype(np.uint64) | (
        np.asarray(hi).astype(np.uint64) << np.uint64(32))
    st, sz = np.concatenate(starts), np.concatenate(sizes)
    live = sz > 0
    want = blake3.hash64_ranges(data, st[live].astype(np.int64),
                                sz[live].astype(np.int64))
    np.testing.assert_array_equal(got[live], want)


def test_entropy_pack_on_gpu(gpu):
    """The XLA scatter-add Huffman pack compiled for the card (atomic
    adds in any order) vs the host bitstream writer."""
    from longtail_jax.ops.device_entropy import _pack_streams_device
    from longtail_jax.ops.zstd_frame import _huf_encode_stream, build_huffman

    rng = np.random.default_rng(11)
    streams = [rng.choice(np.arange(256), size=n,
                          p=np.r_[np.full(8, 0.09), np.full(248, 0.28 / 248)]
                          ).astype(np.uint8)
               for n in (131072, 131072 - 257, 70000, 1311)]
    freqs = np.bincount(np.concatenate(streams), minlength=256)
    _, code_val, code_len = build_huffman(freqs.tolist())
    got = _pack_streams_device(streams, code_val, code_len)
    for s, g in zip(streams, got):
        assert g == _huf_encode_stream(s.tobytes(), code_val, code_len)
