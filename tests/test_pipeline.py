"""End-to-end device data plane: the streamed, bucketed pipeline must produce
byte-identical version indexes to the host path (which is golden-verified
against the reference chunker + BLAKE3 test vectors)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from longtail_jax.core.indexing import create_version_index  # noqa: E402
from longtail_jax.parallel.pipeline import DevicePartIndexer  # noqa: E402
from longtail_jax.ops import blake3, cdc  # noqa: E402
from longtail_jax.formats.constants import chunker_params_from_target  # noqa: E402
from longtail_jax.stores.storage import MemStorage  # noqa: E402


def _mem_tree(rng, spec):
    st = MemStorage()
    st.create_dir("src")
    for path, size in spec:
        data = rng.integers(0, 256, size=size, dtype=np.uint8).tobytes()
        from longtail_jax.stores.storage import ensure_parent_dirs
        ensure_parent_dirs(st, f"src/{path}")
        st.write(f"src/{path}", data)
    return st


def test_pipeline_matches_host_oracle_streaming():
    """Multi-part parts stream: sizes + hashes identical to host per part."""
    rng = np.random.default_rng(3)
    target = 1024
    indexer = DevicePartIndexer(target, lanes=3)
    mn, av, mx = chunker_params_from_target(target)
    parts = []
    for i, n in enumerate([indexer.part_bytes, indexer.part_bytes // 2 + 13,
                           1, 700, indexer.part_bytes - 1, mx, mn,
                           indexer.part_bytes // 3]):
        parts.append((i, rng.integers(0, 256, size=n, dtype=np.uint8)))

    got = list(indexer.index_stream(iter(parts)))
    assert [t for t, _, _ in got] == [t for t, _ in parts]
    for (tag, sizes, hashes), (_, data) in zip(got, parts):
        ref_ends = cdc.chunk_part(data, mn, av, mx)
        ref_sizes = np.diff(np.concatenate([[0], ref_ends]))
        np.testing.assert_array_equal(sizes.astype(np.int64), ref_sizes)
        starts = np.concatenate([[0], ref_ends[:-1]])
        ref_hashes = np.array(
            [blake3.hash64(data[s:e].tobytes())
             for s, e in zip(starts, ref_ends)], dtype=np.uint64)
        np.testing.assert_array_equal(hashes, ref_hashes)


def test_device_version_index_bit_identical():
    """create_version_index(xp=jnp) == create_version_index(xp=np), byte for
    byte, over a mixed tree (multi-part files, tiny files, empty file)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    target = 1024
    spec = [
        ("big.bin", target * 1024 * 2 + 777),   # 3 parts
        ("exact_part.bin", target * 1024),       # exactly 1 part
        ("small.txt", 300),
        ("tiny", 1),
        ("empty", 0),
        ("sub/dir/nested.dat", target * 512 + 5),
    ]
    st = _mem_tree(rng, spec)

    vi_host = create_version_index(st, "src", target_chunk_size=target, xp=np)
    vi_dev = create_version_index(st, "src", target_chunk_size=target, xp=jnp)
    assert vi_host.to_bytes() == vi_dev.to_bytes()
