"""Seeded differential mini-fuzz: the from-spec RFC 7932 decoder vs
libbrotli across randomized content mixtures, sizes, qualities and
windows (every stream the upstream encoder can emit must decode
bit-exact), plus corruption robustness (mutated streams must raise or
mismatch — never crash the interpreter or hang)."""

import ctypes

import numpy as np
import pytest

from longtail_jax.ops import brotli
from longtail_jax.ops.brotli_decode import BrotliError, decompress

pytestmark = pytest.mark.skipif(
    not brotli.available(),
    reason="libbrotli needed to generate fuzz streams")

_WORDS = (b"the of and information development public about should "
          b"because government different through").split()


def _gen(rng):
    kind = rng.integers(0, 5)
    n = int(rng.integers(1, 60_000))
    if kind == 0:
        return rng.integers(0, 256, n, np.uint8).tobytes()
    if kind == 1:
        return b" ".join(rng.choice(_WORDS) for _ in range(n // 6 + 1))
    if kind == 2:
        unit = rng.integers(0, 256, int(rng.integers(1, 300)),
                            np.uint8).tobytes()
        return (unit * (n // max(len(unit), 1) + 1))[:n]
    if kind == 3:
        return bytes([int(rng.integers(0, 4))]) * n
    parts = [_gen(rng) for _ in range(3)]
    return b"".join(parts)


def test_differential_fuzz_vs_libbrotli():
    enc = ctypes.CDLL("libbrotlienc.so.1")
    enc.BrotliEncoderCompress.restype = ctypes.c_int
    enc.BrotliEncoderCompress.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_size_t,
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p]
    enc.BrotliEncoderMaxCompressedSize.restype = ctypes.c_size_t
    rng = np.random.default_rng(0x7932)
    for trial in range(40):
        raw = _gen(rng)
        q = int(rng.choice([0, 1, 2, 4, 5, 6, 9, 10, 11]))
        lgwin = int(rng.integers(10, 25))
        mode = int(rng.integers(0, 3))     # generic / text / font
        bound = enc.BrotliEncoderMaxCompressedSize(len(raw)) or 1024
        out = ctypes.create_string_buffer(bound)
        nn = ctypes.c_size_t(bound)
        assert enc.BrotliEncoderCompress(q, lgwin, mode, len(raw), raw,
                                         ctypes.byref(nn), out)
        comp = out.raw[: nn.value]
        assert decompress(comp, len(raw)) == raw, \
            (trial, q, lgwin, mode, len(raw))


def test_corruption_never_crashes():
    raw = b"robustness of the decoder under corruption " * 200
    comp = bytearray(brotli.compress(raw, 9))
    rng = np.random.default_rng(3)
    for _ in range(60):
        mut = bytearray(comp)
        for _ in range(int(rng.integers(1, 4))):
            mut[int(rng.integers(0, len(mut)))] ^= 1 << int(
                rng.integers(0, 8))
        try:
            got = decompress(bytes(mut), len(raw))
            assert isinstance(got, bytes)  # decoded (possibly wrong) ok
        except (BrotliError, IndexError):
            pass                           # clean rejection is fine
