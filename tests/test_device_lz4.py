"""Device LZ4 codec conformance: batched anchor scan + host assembler
must produce valid LZ4 block streams that decode bit-exactly, on every
data shape that stresses the anchor/extension logic.  On CPU the anchor
kernel is plain XLA (sorts), so this exercises the production graph."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from longtail_jax.ops import lz4  # noqa: E402
from longtail_jax.parallel.device_lz4 import (  # noqa: E402
    ROW_BYTES,
    block_anchors,
    compress_block,
)


def _roundtrip(src: bytes) -> float:
    out = compress_block(src)
    assert lz4.decompress(out, len(src)) == src
    return len(src) / max(len(out), 1)


def test_device_lz4_roundtrips():
    rng = np.random.default_rng(21)
    big = 2 * ROW_BYTES
    cases = {
        "zeros": bytes(big),
        "periodic42": (b"the quick brown fox jumps over the lazy.. "
                       * (big // 42 + 1))[:big],
        "struct": np.arange(0, big // 4, dtype="<u4").tobytes(),
        "noise": rng.integers(0, 256, big, np.uint8).tobytes(),
        "tiled": rng.integers(0, 256, 6 << 10, np.uint8).tobytes() * 24,
        "mixed": (bytes(40000) + rng.integers(0, 256, 40000, np.uint8)
                  .tobytes() + b"ab" * 30000),
        "tail": rng.integers(0, 256, big + 3, np.uint8).tobytes(),
        "sub_row": rng.integers(0, 256, 1000, np.uint8).tobytes() * 3,
    }
    ratios = {}
    for name, src in cases.items():
        ratios[name] = _roundtrip(src)
    # structure must actually compress (LZ4's long-match encoding tops
    # out near 255x; "struct" = arange words has no repeated 8-byte
    # gram, a documented word-gram limitation, so it's not asserted)
    assert ratios["zeros"] > 200, ratios
    assert ratios["periodic42"] > 10, ratios
    assert ratios["tiled"] > 3, ratios
    assert ratios["mixed"] > 2, ratios
    assert ratios["noise"] < 1.01, ratios


def test_device_anchors_yield_real_matches():
    """Anchors are hints, but on clean tiled data they must find the
    tile structure (ratio), and every anchor the device emits that the
    assembler accepts references genuinely identical bytes by
    construction — check the anchor stream itself points at equal
    grams most of the time (hash collisions are allowed but rare)."""
    rng = np.random.default_rng(3)
    tile = rng.integers(0, 256, 3000, np.uint8).tobytes()
    src = (tile * 50)[: 3 * ROW_BYTES]
    pos, ref = block_anchors(src)
    assert len(pos) > 0
    good = sum(src[p:p + 8] == src[r:r + 8]
               for p, r in zip(pos[:256], ref[:256]))
    assert good >= 0.9 * min(len(pos), 256)


def test_device_lz4_vs_host_ratio():
    """The device+assemble path must land within 25% of the host greedy
    LZ4 encoder's ratio on a compressible mixed corpus."""
    rng = np.random.default_rng(9)
    text = (b"pack my box with five dozen liquor jugs! " * 4000)
    structured = np.repeat(
        np.arange(2000, dtype="<u4"), 8).tobytes()
    src = (text + structured + bytes(1 << 16)
           + rng.integers(0, 256, 1 << 16, np.uint8).tobytes())
    src = src[: 4 * ROW_BYTES]
    dev = compress_block(src)
    host = lz4.compress(src)
    assert lz4.decompress(dev, len(src)) == src
    assert len(dev) <= len(host) * 1.25, (len(dev), len(host))
