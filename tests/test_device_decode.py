"""Device LZ4 decode (parallel/device_decode.py): the parse + interval
expansion + pointer-jump resolution must reproduce the host decoder
bit-exactly on every content shape (long matches, short matches, pure
literals, overlapping RLE, mixed, degenerate)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from longtail_jax.ops import lz4  # noqa: E402
from longtail_jax.parallel.device_decode import (  # noqa: E402
    decode_block_device,
    parse_sequences,
)


def _cases():
    rng = np.random.default_rng(0)
    tile = rng.integers(0, 256, 6 << 10, np.uint8).tobytes()
    text = (b"the quick brown fox jumps over the lazy dog. " * 3000)
    return [
        ("tiled", (tile * 40)[:200_000]),
        ("text", text[:120_000]),
        ("noise", rng.integers(0, 256, 150_000, np.uint8).tobytes()),
        ("zeros", bytes(100_000)),             # overlapping-match RLE
        ("mix", text[:50_000] + bytes(5000) + tile
         + rng.integers(0, 256, 30_000, np.uint8).tobytes()),
        ("tiny", b"abcabcabcabcabcabc"),
        ("empty", b""),
        ("period3", b"abc" * 40_000),          # offset 3 overlap chains
    ]


@pytest.mark.parametrize("name,raw", _cases(), ids=[c[0] for c in _cases()])
def test_device_decode_bit_exact(name, raw):
    comp = lz4.compress(raw)
    assert decode_block_device(comp, len(raw)) == raw


def test_device_decode_anchor_encoded_block():
    """Blocks produced by the device ANCHOR encoder decode on device too
    (encode-on-device -> decode-on-device closes the loop)."""
    rng = np.random.default_rng(3)
    tile = rng.integers(0, 256, 24 << 10, np.uint8).tobytes()
    raw = (tile * 20)[:300_000]
    pos = np.arange(24 << 10, len(raw) - 64, 256, dtype=np.int64)
    ref = pos - (24 << 10)
    comp = lz4.assemble_anchors(raw, pos, ref)
    assert decode_block_device(comp, len(raw)) == raw


def test_parse_sequences_structure():
    raw = b"A" * 100 + bytes(range(64)) * 2
    comp = lz4.compress(raw)
    lit_src, lit_dst, lit_len, m_dst, m_off, m_len = \
        parse_sequences(comp, len(raw))
    # reconstruct sizes from the parse alone
    assert int((lit_len + m_len).sum()) == len(raw)
    assert (m_off[:-1] > 0).all() or len(m_off) == 1
