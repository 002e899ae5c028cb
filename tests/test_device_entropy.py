"""Device Huffman entropy stage (ops/device_entropy.py): the device-packed
literal streams must be BYTE-IDENTICAL to the host encoder for exact
histograms, and every produced frame must decode with upstream libzstd
(when present) and the from-spec decoder."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from longtail_jax.ops import zstd_frame  # noqa: E402
from longtail_jax.ops.device_entropy import (  # noqa: E402
    _split_blocks,
    device_histogram,
    encode_literals_device,
    frame_from_sequences,
)


def _lit_cases():
    rng = np.random.default_rng(2)
    text = (b"The five boxing wizards jump quickly; "
            b"sphinx of black quartz judge my vow. " * 400)
    skew = rng.choice(np.arange(256), size=20_000,
                      p=np.r_[np.full(8, 0.1), np.full(248, 0.2 / 248)])
    return [
        ("text", text[:8_000]),
        ("text-4stream", text[:30_000]),
        ("skewed", skew.astype(np.uint8).tobytes()),
        ("short", text[:200]),
        ("sub64", b"abcdefgh" * 7),
        ("rle", b"z" * 500),
        ("noise", rng.integers(0, 256, 5_000, np.uint8).tobytes()),
        ("binary-ish", bytes(np.repeat(rng.integers(0, 16, 2_000,
                                                    np.uint8), 3))),
    ]


@pytest.mark.parametrize("name,lits", _lit_cases(),
                         ids=[c[0] for c in _lit_cases()])
def test_literals_section_matches_host_encoder(name, lits):
    """With exact histograms (inputs <= the sample cap), the device
    section must equal zstd_frame._encode_literals byte-for-byte."""
    got = encode_literals_device(lits)
    want = zstd_frame._encode_literals(lits)
    assert got == want


def test_device_histogram_exact_small():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, 50_000, np.uint8)
    np.testing.assert_array_equal(device_histogram(x),
                                  np.bincount(x, minlength=256))


def test_large_literals_sampled_table_decodes():
    """Past the sample cap the table is sampled (not host-identical) but
    the section must still embed in a decodable frame."""
    rng = np.random.default_rng(1)
    # 200 KiB of skewed text-like literals
    lits = rng.choice(np.frombuffer(b"etaoin shrdlucmfwyp", np.uint8),
                      size=200_000).tobytes()
    frame = zstd_frame.compress(lits, encode_literals=encode_literals_device)
    assert zstd_frame.decompress(frame, len(lits)) == lits
    _assert_upstream_decodes(frame, lits)


def _assert_upstream_decodes(frame: bytes, raw: bytes):
    from longtail_jax.ops import zstd as _z

    if _z._load_native() is not None:
        assert _z.decompress(frame, len(raw)) == raw


@pytest.mark.parametrize("n,pattern", [
    (0, "empty"), (1, "one"), (300, "small"),
    (300_000, "multiblock"),
])
def test_frame_with_device_literals_round_trips(n, pattern):
    rng = np.random.default_rng(7)
    text = (b"pack my box with five dozen liquor jugs -- " * 8000)
    raw = bytes(text[:n]) if pattern != "noise" else \
        rng.integers(0, 256, n, np.uint8).tobytes()
    frame = zstd_frame.compress(raw, encode_literals=encode_literals_device)
    assert zstd_frame.decompress(frame, len(raw)) == raw
    _assert_upstream_decodes(frame, raw)


def test_split_blocks_invariants():
    """Block lengths sum to n; per block, sequence spans + tail cover
    exactly the block; no zero-length matches below zstd's minimum."""
    cases = [
        # (n, sequences as (off, ll, ml, 0))
        (300_000, [(100, 50, 1000, 0), (5000, 130_000, 40_000, 0),
                   (70_000, 1000, 120_000, 0)]),
        (128 * 1024, [(4, 10, 131_000, 0)]),           # match at boundary
        (128 * 1024 + 5, [(4, 131_067, 3, 0)]),        # lit run crosses
        (10, []),
        (128 * 1024 * 3, [(9, 0, 128 * 1024 * 3 - 8, 0)]),
    ]
    for n, seqs in cases:
        rows = np.asarray(seqs, np.uint32).reshape(-1, 4)
        blocks = _split_blocks(rows, n)
        assert sum(b for b, _, _ in blocks) == n
        for blen, ss, tail in blocks:
            assert blen <= zstd_frame.BLOCK_MAX
            span = sum(ll + ml for ll, ml, _ in ss) + tail
            assert span == blen, (blen, ss, tail)
            for ll, ml, off in ss:
                assert ml >= 3 and off >= 1


def test_frame_from_sequences_end_to_end():
    """Device-anchor sequences -> from-spec frame with device literals:
    decodes with the from-spec decoder AND upstream zstd; ratio within
    5% of libzstd level 3."""
    from longtail_jax.ops import zstd as _z
    from longtail_jax.ops.zstd_device import sequences_from_anchors

    rng = np.random.default_rng(9)
    tile = rng.integers(0, 256, 24 << 10, np.uint8).tobytes()
    text = (b"the quick brown fox jumps over the lazy dog; " * 4000)
    raw = (text[:100_000] + bytes(30_000) + tile * 12
           + rng.integers(0, 256, 60_000, np.uint8).tobytes())
    # anchors: tile repeats at stride 24 KiB, text period 45
    pos1 = np.arange(24 << 10, 12 * (24 << 10) - 64, 256, dtype=np.int64) \
        + 130_000
    ref1 = pos1 - (24 << 10)
    pos0 = np.arange(45, 99_000, 128, dtype=np.int64)
    ref0 = pos0 - 45
    apos = np.concatenate([pos0, ref1 * 0 + pos1])
    aref = np.concatenate([ref0, ref1])
    order = np.argsort(apos, kind="stable")
    seqs = sequences_from_anchors(raw, apos[order], aref[order])
    frame = frame_from_sequences(raw, seqs)
    assert zstd_frame.decompress(frame, len(raw)) == raw
    _assert_upstream_decodes(frame, raw)
    if _z._load_native() is not None:
        l3 = len(_z.compress(raw, 3))
        assert len(frame) <= l3 * 1.05, (len(frame), l3)
