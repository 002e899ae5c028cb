"""The device Huffman pack (ops/device_entropy.make_hufpack_fn, an XLA
scatter-add) vs the host bitstream writer (zstd_frame._huf_encode_stream):
identical backward Huffman streams, sentinel included, for every stream
of a batch — partial fills, ragged final streams, skewed code lengths."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from longtail_jax.ops.device_entropy import (  # noqa: E402
    _pack_streams_device,
    make_hufpack_fn,
)
from longtail_jax.ops.zstd_frame import (  # noqa: E402
    MAX_HUF_BITS,
    _huf_encode_stream,
    build_huffman,
)


def _codes(streams):
    freqs = np.bincount(np.concatenate(streams), minlength=256)
    built = build_huffman(freqs.tolist())
    assert built is not None
    _, code_val, code_len = built
    return code_val, code_len


def _check(streams):
    code_val, code_len = _codes(streams)
    got = _pack_streams_device(streams, code_val, code_len)
    for s, g in zip(streams, got):
        assert g == _huf_encode_stream(s.tobytes(), code_val, code_len)


@pytest.mark.parametrize("s,n_pad,fill", [
    (1, 1024, 1024), (2, 1024, 977), (3, 2048, 1500), (2, 4096, 4096),
])
def test_pack_matches_host_encoder(s, n_pad, fill):
    rng = np.random.default_rng(fill)
    lits = rng.choice(
        np.arange(256), size=(s, n_pad),
        p=np.r_[np.full(8, 0.09), np.full(248, 0.28 / 248)]
    ).astype(np.uint8)
    lengths = [fill] * (s - 1) + [max(1, fill - 129)]   # ragged final
    _check([lits[i, : lengths[i]] for i in range(s)])


def test_pack_skewed_code_lengths():
    """A near-degenerate distribution exercises 1-bit codes (most codes
    per word) and long codes (most spill) in the same stream."""
    rng = np.random.default_rng(9)
    lits = rng.choice(
        np.arange(256), size=(2, 2048),
        p=np.r_[[0.75], np.full(255, 0.25 / 255)]
    ).astype(np.uint8)
    _check([lits[0], lits[1]])


def test_pack_words_hold_longest_codes():
    """The output row has room for n_pad codes of MAX_HUF_BITS each plus
    the sentinel: a stream of only the rarest symbol loses no bit."""
    n_pad = 1024
    freqs = [int(1.6 ** i) + 1 for i in range(40)]     # deep code tree
    _, code_val, code_len = build_huffman(freqs)
    cl = np.asarray(code_len + [0] * (256 - len(code_len)), np.int32)
    rare = int(np.argmax(cl))
    assert cl[rare] == MAX_HUF_BITS
    lits = np.full((1, n_pad), rare, np.uint8)
    cv = np.asarray(code_val + [0] * (256 - len(code_val)), np.int32)
    words, totals = make_hufpack_fn(n_pad, 1)(
        lits, np.array([n_pad], np.int32), cv, cl)
    assert int(np.asarray(totals)[0]) == n_pad * MAX_HUF_BITS
    assert np.asarray(words).shape[1] * 32 > n_pad * MAX_HUF_BITS + 1
    got = _pack_streams_device([lits[0]], code_val, code_len)[0]
    assert got == _huf_encode_stream(lits[0].tobytes(), code_val, code_len)
