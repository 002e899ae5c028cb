"""Bit-exactness of the device (jax) chunk+hash step vs the host oracle.

The device step (longtail_jax/parallel/device_chunker.py) must produce, for
every part lane, exactly the chunk boundaries of ops/cdc.chunk_part (itself
golden-verified against the reference chunker, see test_chunker.py) and
exactly the BLAKE3-64 chunk hashes of ops/blake3.hash64.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from longtail_jax.ops import blake3, cdc  # noqa: E402
from longtail_jax.parallel.device_chunker import (  # noqa: E402
    ChunkerConfig,
    make_index_parts_fn,
)


def _oracle(parts: np.ndarray, lengths: np.ndarray, cfg: ChunkerConfig):
    """Host reference: per-lane chunk ends + 64-bit hashes."""
    all_ends, all_hashes = [], []
    for b in range(parts.shape[0]):
        data = parts[b, : int(lengths[b])]
        if len(data) == 0:
            all_ends.append(np.zeros(0, np.int64))
            all_hashes.append(np.zeros(0, np.uint64))
            continue
        ends = cdc.chunk_part(data, cfg.min_size, cfg.avg_size, cfg.max_size)
        starts = np.concatenate([[0], ends[:-1]])
        hashes = np.array(
            [blake3.hash64(data[s:e].tobytes()) for s, e in zip(starts, ends)],
            dtype=np.uint64)
        all_ends.append(ends)
        all_hashes.append(hashes)
    return all_ends, all_hashes


def _run_device(parts: np.ndarray, lengths: np.ndarray, cfg: ChunkerConfig):
    fn = make_index_parts_fn(cfg)
    ends, sizes, lo, hi = fn(jnp.asarray(parts), jnp.asarray(lengths))
    return (np.asarray(ends), np.asarray(sizes),
            np.asarray(lo), np.asarray(hi))


def _check(parts, lengths, cfg):
    ref_ends, ref_hashes = _oracle(parts, lengths, cfg)
    ends, sizes, lo, hi = _run_device(parts, lengths, cfg)
    B, C = ends.shape
    for b in range(B):
        n = int((sizes[b] > 0).sum())
        got_ends = ends[b, :n].astype(np.int64)
        assert n == len(ref_ends[b]), (
            f"lane {b}: {n} chunks vs oracle {len(ref_ends[b])}")
        np.testing.assert_array_equal(got_ends, ref_ends[b])
        got_hash = (lo.reshape(B, C)[b, :n].astype(np.uint64)
                    | (hi.reshape(B, C)[b, :n].astype(np.uint64) << np.uint64(32)))
        np.testing.assert_array_equal(got_hash, ref_hashes[b])


def test_random_parts_bit_exact():
    rng = np.random.default_rng(7)
    cfg = ChunkerConfig.from_target(2048)
    P = 2048 * 8
    parts = rng.integers(0, 256, size=(4, P), dtype=np.uint8)
    lengths = np.array([P, P - 371, cfg.min_size + 1, 95], dtype=np.int32)
    _check(parts, lengths, cfg)


def test_adversarial_lengths():
    """Lengths at every constraint boundary."""
    rng = np.random.default_rng(13)
    cfg = ChunkerConfig.from_target(1024)
    P = 1024 * 6
    lengths = np.array([
        1,                       # single tiny chunk
        cfg.min_size,            # == min: one chunk
        cfg.min_size + 1,        # just above min
        cfg.max_size,            # == max
        cfg.max_size + 1,        # forces a max-cut + tail
        2 * cfg.max_size,        # exactly two max-cuts possible
        P,                       # full lane
        P - 1,
    ], dtype=np.int32)
    parts = rng.integers(0, 256, size=(len(lengths), P), dtype=np.uint8)
    _check(parts, lengths, cfg)


def test_degenerate_content():
    """Constant / repeating content (no or pathological candidates)."""
    cfg = ChunkerConfig.from_target(1024)
    P = 1024 * 6
    parts = np.stack([
        np.zeros(P, np.uint8),                        # all zero: no cuts
        np.full(P, 0xAB, np.uint8),                   # constant byte
        np.tile(np.arange(256, dtype=np.uint8), P // 256),  # cyclic
        np.tile(np.array([0, 255], np.uint8), P // 2),      # bit-flip pattern
    ])
    lengths = np.full(4, P, dtype=np.int32)
    _check(parts, lengths, cfg)


def test_multiple_targets():
    rng = np.random.default_rng(99)
    for target in (512, 4096):
        cfg = ChunkerConfig.from_target(target)
        P = target * 8
        parts = rng.integers(0, 256, size=(2, P), dtype=np.uint8)
        lengths = np.array([P, P // 2 + 17], dtype=np.int32)
        _check(parts, lengths, cfg)


def test_matches_reference_golden_part():
    """Run the device step over the reference golden chunker input."""
    import pathlib
    data = pathlib.Path(
        __file__).parent.joinpath("testdata", "chunker.input").read_bytes()
    cfg = ChunkerConfig.from_target(8192)
    P = 128 * 1024
    part = np.frombuffer(data[:P], dtype=np.uint8)[None, :]
    _check(part, np.array([P], np.int32), cfg)
