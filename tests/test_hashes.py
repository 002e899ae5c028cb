"""Hash conformance: anchored to the reference C library's known-answer
vectors (test/test.cpp:452-488) plus scalar/batched cross-checks."""

import numpy as np
import pytest

from longtail_jax.ops import blake3 as b3
from longtail_jax.ops.hash_registry import get_hasher
from longtail_jax.formats.constants import (
    HASH_TYPE_BLAKE2, HASH_TYPE_BLAKE3, HASH_TYPE_MEOW, fourcc)

KAT_INPUT = (b"This is the first test string which is fairly long and should "
             b"- reconstructed properly, than you very much\x00")


def test_fourcc():
    assert fourcc("blk3") == (ord("b") << 24) + (ord("l") << 16) + \
        (ord("k") << 8) + ord("3")


def test_blake3_known_answer():
    # test/test.cpp:465-475
    assert get_hasher(HASH_TYPE_BLAKE3).hash_buffer(KAT_INPUT) == 0xd38bbe79f1f03fda


def test_blake2_known_answer():
    # test/test.cpp:452-463
    assert get_hasher(HASH_TYPE_BLAKE2).hash_buffer(KAT_INPUT) == 0xd336e5afa4fa1f4d


def test_blake3_empty_vector():
    # official BLAKE3 empty-input test vector (first 16 bytes)
    assert b3.blake3(b"").hex().startswith("af1349b9f5f9a1a6a0404dea36dcc949")


@pytest.mark.parametrize("sizes", [
    [0, 1, 63, 64, 65, 1023, 1024, 1025],
    [2048, 3072, 4096, 5000, 8192, 10240],
    [16384, 65536, 65535, 65537 - 2, 131072],
])
def test_blake3_batched_matches_scalar(sizes):
    rng = np.random.default_rng(42)
    maxpad = 1024 * max(1, (max(sizes) + 1023) // 1024)
    data = np.zeros((len(sizes), maxpad), dtype=np.uint8)
    for i, s in enumerate(sizes):
        data[i, :s] = rng.integers(0, 256, s, dtype=np.uint8)
    got = b3.hash_chunks(data, np.array(sizes), xp=np)
    want = np.array([b3.hash64(bytes(data[i, :s]))
                     for i, s in enumerate(sizes)], dtype=np.uint64)
    assert np.array_equal(got, want)


def test_blake3_batched_jax():
    import jax.numpy as jnp
    sizes = [0, 100, 1024, 4000, 8192]
    rng = np.random.default_rng(7)
    data = np.zeros((len(sizes), 8192), dtype=np.uint8)
    for i, s in enumerate(sizes):
        data[i, :s] = rng.integers(0, 256, s, dtype=np.uint8)
    got = np.asarray(b3.hash_chunks(jnp.asarray(data), jnp.asarray(sizes), xp=jnp))
    want = b3.hash_chunks(data, np.array(sizes), xp=np)
    assert np.array_equal(got, want)


def test_meow_known_answer():
    """Reference suite KAT (test/test.cpp:476-485): string incl. NUL."""
    from longtail_jax.ops import meow

    s = (b"This is the first test string which is fairly long and should"
         b" - reconstructed properly, than you very much\x00")
    assert meow.hash64(s) == 0x4EDC68DAC105C4EE


def test_meow_structure_cases():
    """Exercise every residual/lane path: sizes straddling 16/32/256-byte
    boundaries all hash without error and are distinct."""
    from longtail_jax.ops import meow

    sizes = [0, 1, 15, 16, 17, 31, 32, 33, 63, 64, 255, 256, 257,
             256 + 32 * 7, 1024]
    seen = set()
    for n in sizes:
        h = meow.hash64(bytes(range(256)) * 5 if n > 1024 else
                        bytes((i * 7 + 3) & 0xFF for i in range(n)))
        seen.add(h)
    assert len(seen) == len(sizes) - (1 if 0 in sizes else 0) or len(seen) > 10


def test_meow_registry_provider():
    import numpy as np

    from longtail_jax.formats.constants import HASH_TYPE_MEOW
    from longtail_jax.ops.hash_registry import get_hasher

    h = get_hasher(HASH_TYPE_MEOW)
    data = np.zeros((2, 64), dtype=np.uint8)
    data[0, :5] = [1, 2, 3, 4, 5]
    out = h.hash_chunks(data, np.array([5, 64]))
    assert out[0] == h.hash_buffer(bytes([1, 2, 3, 4, 5]))
    assert out[1] == h.hash_buffer(bytes(64))


def test_blake2_batched_matches_hashlib():
    """Lane-batched BLAKE2s (numpy and jnp) == hashlib.blake2s digest_size=8
    across block-boundary sizes."""
    import hashlib

    import jax.numpy as jnp
    import numpy as np

    from longtail_jax.ops import blake2

    rng = np.random.default_rng(9)
    sizes = [0, 1, 63, 64, 65, 128, 1000, 2048]
    padded = 2048
    data = np.zeros((len(sizes), padded), np.uint8)
    msgs = []
    for i, n in enumerate(sizes):
        m = rng.integers(0, 256, n, np.uint8).tobytes()
        msgs.append(m)
        data[i, :n] = np.frombuffer(m, np.uint8)
    lengths = np.array(sizes, np.uint32)
    for xp in (np, jnp):
        got = blake2.hash_chunks(data, lengths, xp=xp)
        for i, m in enumerate(msgs):
            want = int.from_bytes(
                hashlib.blake2s(m, digest_size=8).digest(), "little")
            assert got[i] == want, (xp.__name__, sizes[i])


def _ranges_case(rng, layout, n_bytes):
    """Random chunks per size class at unaligned starts (leaf-edge sizes
    first, a padding row of size 0 last) -> (data, blob, starts, sizes)."""
    import numpy as np

    data = rng.integers(0, 256, n_bytes, dtype=np.uint8)
    blob, starts, sizes = [], [], []
    for cls, rows in layout:
        sz = rng.integers(1, cls + 1, rows).astype(np.int32)
        edges = [1, 63, 64, 65, 1023, 1024, 1025, cls - 1, cls]
        sz[: len(edges)] = [min(e, cls) for e in edges]
        sz[-1] = 0
        st = rng.integers(0, n_bytes - cls, rows).astype(np.int32)
        blob += [st, sz]
        starts.append(st)
        sizes.append(sz)
    return (data, np.concatenate(blob), np.concatenate(starts),
            np.concatenate(sizes))


def test_blake3_triton_kernel_matches_batched():
    """The stage-3 Triton BLAKE3 kernel (interpret mode) == the batched
    numpy hasher over the same chunks: single- and multi-leaf classes,
    unaligned starts, leaf and block edges."""
    import jax
    import numpy as np

    from longtail_jax.ops import blake3 as b3
    from longtail_jax.ops.blake3_kernel import hash_layout

    rng = np.random.default_rng(11)
    layout = ((1024, 128), (4096, 64), (16384, 16))
    data, blob, starts, sizes = _ranges_case(rng, layout, 1 << 20)
    words = np.concatenate([data, np.zeros(32768, np.uint8)]).view("<u4")
    lo, hi = jax.jit(lambda w, b: hash_layout(w, b, layout,
                                              interpret=True))(words, blob)
    got = (np.asarray(lo).astype(np.uint64)
           | (np.asarray(hi).astype(np.uint64) << np.uint64(32)))
    off = 0
    for cls, rows in layout:
        st, sz = starts[off: off + rows], sizes[off: off + rows]
        chunks = np.zeros((rows, cls), np.uint8)
        for r in range(rows):
            chunks[r, : sz[r]] = data[st[r]: st[r] + sz[r]]
        nlo, nhi = b3.hash_chunks_words(chunks.view("<u4"), sz, xp=np)
        want = nlo.astype(np.uint64) | (nhi.astype(np.uint64) << np.uint64(32))
        live = sz > 0
        np.testing.assert_array_equal(got[off: off + rows][live], want[live])
        off += rows


def test_blake2_device_stage3_matches_hashlib():
    """The blake2 device stage 3 (plain XLA pack + batched BLAKE2s) ==
    hashlib.blake2s digest_size=8 over chunks at unaligned starts."""
    import hashlib

    import jax
    import numpy as np

    from longtail_jax.parallel import backend
    from longtail_jax.parallel.pipeline import stage3_body

    rng = np.random.default_rng(13)
    layout = ((2048, 64),)
    data, blob, starts, sizes = _ranges_case(rng, layout, 1 << 16)
    words2d = np.concatenate([data, np.zeros(8192, np.uint8)]).view(
        "<u4").reshape(-1, 128)
    lo, hi = jax.jit(stage3_body(layout, "blake2", backend.CPU))(
        words2d, blob)
    got = (np.asarray(lo).astype(np.uint64)
           | (np.asarray(hi).astype(np.uint64) << np.uint64(32)))
    for i in range(len(sizes) - 1):
        want = int.from_bytes(hashlib.blake2s(
            data[starts[i]: starts[i] + sizes[i]].tobytes(),
            digest_size=8).digest(), "little")
        assert int(got[i]) == want, i
