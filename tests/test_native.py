"""Native host fast paths (longtail_jax/native/*.c) vs the Python oracles.

The golden-vector suites already run through the public entry points (which
prefer the native code when built); these tests pin the native/Python
equivalence directly so a divergence is attributed, not just detected.
"""

import os

import numpy as np
import pytest

from longtail_jax.ops import blake3, cdc


def test_no_native_env_forces_fallback():
    """LONGTAIL_NO_NATIVE must defeat the cached-.so fast path, and
    when CI sets it the suite must actually be exercising pure Python."""
    from longtail_jax import native

    if os.environ.get("LONGTAIL_NO_NATIVE"):
        assert cdc._native() is None
        assert blake3._native() is None
        assert native.load("lz4_block") is None
    else:
        os.environ["LONGTAIL_NO_NATIVE"] = "1"
        try:
            assert native.load("lz4_block") is None
        finally:
            del os.environ["LONGTAIL_NO_NATIVE"]


def test_no_native_env_under_the_former_package_name():
    """The switch keeps working under its older, package-prefixed name."""
    from longtail_jax import native

    name = "LONGTAIL_FORMER_NO_NATIVE"
    os.environ[name] = "1"
    try:
        assert native.load("lz4_block") is None
    finally:
        del os.environ[name]


@pytest.mark.skipif(cdc._native() is None, reason="no C compiler")
def test_cdc_native_matches_numpy_two_phase():
    rng = np.random.default_rng(42)
    for n in [49, 128, 129, 777, 4096, 65536, (1 << 18) + 13]:
        data = rng.integers(0, 256, n, dtype=np.uint8)
        native = cdc.chunk_part(data, 128, 512, 2048)
        cands = cdc.candidate_positions(data, 512)
        numpy_ends = cdc.resolve_cuts(cands, n, 128, 2048)
        assert list(native) == list(numpy_ends), n
        seq = cdc.chunk_part_sequential(bytes(data), 128, 512, 2048)
        assert list(native) == seq, n


@pytest.mark.skipif(cdc._native() is None, reason="no C compiler")
def test_cdc_native_low_entropy_and_constant():
    for data in [np.zeros(100000, np.uint8),
                 np.tile(np.arange(7, dtype=np.uint8), 20000)]:
        native = cdc.chunk_part(data, 128, 512, 2048)
        seq = cdc.chunk_part_sequential(bytes(data), 128, 512, 2048)
        assert list(native) == seq


@pytest.mark.skipif(blake3._native() is None, reason="no C compiler")
def test_blake3_native_matches_oracle():
    rng = np.random.default_rng(7)
    sizes = [0, 1, 63, 64, 65, 1023, 1024, 1025, 2048, 2049,
             3 * 1024, 65536, 65537, 100000]
    base = rng.integers(0, 256, sum(sizes), dtype=np.uint8)
    offsets = np.cumsum([0] + sizes[:-1]).astype(np.int64)
    got = blake3.hash64_ranges(base, offsets, np.asarray(sizes, np.int64))
    for o, s, g in zip(offsets, sizes, got):
        assert int(g) == blake3.hash64(base[o:o + s].tobytes()), s


@pytest.mark.skipif(blake3._native() is None, reason="no C compiler")
def test_hash_chunk_batch_uses_native_and_matches():
    from longtail_jax.core.indexing import hash_chunk_batch
    from longtail_jax.ops.hash_registry import get_hasher
    from longtail_jax.formats.constants import HASH_TYPE_BLAKE3

    rng = np.random.default_rng(9)
    data = rng.integers(0, 256, 1 << 18, dtype=np.uint8)
    ends = cdc.chunk_part(data, 128, 512, 2048)
    offsets = np.concatenate([[0], ends[:-1]])
    sizes = np.diff(np.concatenate([[0], ends]))
    hasher = get_hasher(HASH_TYPE_BLAKE3)
    got = hash_chunk_batch(hasher, data, offsets, sizes)
    want = np.array([blake3.hash64(data[o:o + s].tobytes())
                     for o, s in zip(offsets, sizes)], dtype=np.uint64)
    np.testing.assert_array_equal(got, want)
