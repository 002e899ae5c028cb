"""From-spec RFC 7932 brotli decoder (ops/brotli_decode.py) vs the
upstream encoder: every stream libbrotli writes must decode bit-exact,
across quality tiers, window sizes, and content shapes — including
multi-meta-block streams, uncompressed meta-blocks, and static-
dictionary/word-transform references (the reference always vendors
brotli, lib/brotli/longtail_brotli.c:24-74, so its stores may carry
btl* blocks; this decoder is the no-libbrotli interop floor)."""

import ctypes

import numpy as np
import pytest

from longtail_jax.ops import brotli
from longtail_jax.ops.brotli_decode import BrotliError, decompress

pytestmark = pytest.mark.skipif(
    not brotli.available(),
    reason="libbrotli needed to generate conformance streams")


def _cases():
    rng = np.random.default_rng(5)
    text = (b"The quick brown fox jumps over the lazy dog. information "
            b"about the world wide web development of software " * 120)
    noise = rng.integers(0, 256, 30_000, np.uint8).tobytes()
    per = rng.integers(0, 256, 997, np.uint8).tobytes()
    return [
        ("text", text),
        ("dictish", b"information about development of the public"),
        ("tiny", b"a"),
        ("empty", b""),
        ("noise", rng.integers(0, 256, 50_000, np.uint8).tobytes()),
        ("rle", b"\x00" * 100_000),
        ("periodic", per * 60),
        # mixed content makes the encoder emit uncompressed meta-blocks
        # between compressed ones; the distance ring and literal context
        # carry across the boundary
        ("mixed", text + noise + text),
        ("words", b" ".join([b"should", b"because", b"people",
                             b"through", b"information"] * 400)),
    ]


@pytest.mark.parametrize("name,raw", _cases(), ids=[c[0] for c in _cases()])
def test_decodes_libbrotli_streams(name, raw):
    for q in (0, 1, 2, 5, 9, 11):
        for tm in (False, True):
            comp = brotli.compress(raw, q, text_mode=tm)
            assert decompress(comp, len(raw)) == raw, (name, q, tm)


def test_window_size_sweep():
    enc = ctypes.CDLL("libbrotlienc.so.1")
    enc.BrotliEncoderCompress.restype = ctypes.c_int
    enc.BrotliEncoderCompress.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_size_t,
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p]
    enc.BrotliEncoderMaxCompressedSize.restype = ctypes.c_size_t
    rng = np.random.default_rng(7)
    raw = (b"The general public information about development " * 2000
           + rng.integers(0, 256, 80_000, np.uint8).tobytes())
    for lgwin in (10, 14, 16, 17, 22, 24):
        bound = enc.BrotliEncoderMaxCompressedSize(len(raw))
        out = ctypes.create_string_buffer(bound)
        n = ctypes.c_size_t(bound)
        assert enc.BrotliEncoderCompress(5, lgwin, 0, len(raw), raw,
                                         ctypes.byref(n), out)
        assert decompress(out.raw[:n.value], len(raw)) == raw, lgwin


def test_large_multi_metablock():
    rng = np.random.default_rng(9)
    text = (b"the project of the development of the information " * 1500)
    raw = (text + rng.integers(0, 256, 60_000, np.uint8).tobytes()) * 12
    comp = brotli.compress(raw, 4)
    assert decompress(comp, len(raw)) == raw


def test_truncated_and_garbage_raise():
    comp = brotli.compress(b"hello world, hello brotli" * 50, 9)
    with pytest.raises(BrotliError):
        decompress(comp[: len(comp) // 2], 1250)
    with pytest.raises(BrotliError):
        decompress(comp, 7)        # wrong expected size


def test_matches_libbrotli_decoder_output():
    """Same bytes out as the upstream decoder, not just a round-trip."""
    raw = (b"mutual information content-addressed storage engine " * 300)
    comp = brotli.compress(raw, 11, text_mode=True)
    assert decompress(comp, len(raw)) == brotli.decompress(comp, len(raw))
