"""Zero-parse format roundtrips and layout checks (mirrors reference
index read/write tests, test/test.cpp:489-1255)."""

import numpy as np
import pytest

from longtail_jax.formats.constants import (
    CURRENT_STORE_INDEX_VERSION,
    CURRENT_VERSION_INDEX_VERSION,
    HASH_TYPE_BLAKE3,
)
from longtail_jax.formats.store_index import BlockIndex, StoreIndex, StoredBlock
from longtail_jax.formats.version_index import FormatError, VersionIndex


def make_version_index() -> VersionIndex:
    return VersionIndex(
        hash_identifier=HASH_TYPE_BLAKE3,
        target_chunk_size=32768,
        path_hashes=np.array([1, 2, 3], dtype="<u8"),
        content_hashes=np.array([10, 20, 30], dtype="<u8"),
        asset_sizes=np.array([100, 0, 250], dtype="<u8"),
        asset_chunk_counts=np.array([2, 0, 1], dtype="<u4"),
        asset_chunk_index_starts=np.array([0, 2, 2], dtype="<u4"),
        asset_chunk_indexes=np.array([0, 1, 0], dtype="<u4"),
        chunk_hashes=np.array([111, 222], dtype="<u8"),
        chunk_sizes=np.array([50, 50], dtype="<u4"),
        chunk_tags=np.array([0, 0], dtype="<u4"),
        name_offsets=np.array([0, 6, 11], dtype="<u4"),
        permissions=np.array([0o644, 0o755, 0o644], dtype="<u2"),
        name_data=b"a.txt\0dir/\0dir/b.bin\0",
    )


def test_version_index_roundtrip():
    vi = make_version_index()
    blob = vi.to_bytes()
    vi2 = VersionIndex.from_bytes(blob)
    assert vi2.version == CURRENT_VERSION_INDEX_VERSION
    assert vi2.hash_identifier == vi.hash_identifier
    assert vi2.paths() == ["a.txt", "dir/", "dir/b.bin"]
    assert vi2.is_dir(1) and not vi2.is_dir(0)
    assert np.array_equal(vi2.chunk_hashes, vi.chunk_hashes)
    assert np.array_equal(vi2.asset_chunk_indexes, vi.asset_chunk_indexes)
    assert vi2.to_bytes() == blob


def test_version_index_header_layout():
    # first 24 bytes are six u32 LE: version, hash id, target size, counts
    blob = make_version_index().to_bytes()
    head = np.frombuffer(blob[:24], dtype="<u4")
    assert head[0] == CURRENT_VERSION_INDEX_VERSION == 0x000002
    assert head[1] == HASH_TYPE_BLAKE3
    assert head[2] == 32768
    assert list(head[3:]) == [3, 2, 3]


def test_version_index_bad_version():
    blob = bytearray(make_version_index().to_bytes())
    blob[0] = 0xFF
    with pytest.raises(FormatError):
        VersionIndex.from_bytes(bytes(blob))


def test_version_index_truncated():
    blob = make_version_index().to_bytes()
    with pytest.raises(FormatError):
        VersionIndex.from_bytes(blob[:30])


def test_block_index_roundtrip():
    bi = BlockIndex(
        block_hash=0xdeadbeeffeed5a17, hash_identifier=HASH_TYPE_BLAKE3,
        tag=7, chunk_hashes=np.array([1, 2, 3], dtype="<u8"),
        chunk_sizes=np.array([10, 20, 30], dtype="<u4"))
    blob = bi.to_bytes()
    assert len(blob) == 8 + 4 + 4 + 4 + 3 * 8 + 3 * 4
    bi2 = BlockIndex.from_bytes(blob)
    assert bi2.block_hash == bi.block_hash
    assert bi2.tag == 7
    assert np.array_equal(bi2.chunk_hashes, bi.chunk_hashes)
    assert bi2.block_data_size == 60


def test_stored_block_roundtrip():
    bi = BlockIndex(
        block_hash=42, hash_identifier=HASH_TYPE_BLAKE3, tag=0,
        chunk_hashes=np.array([5, 6], dtype="<u8"),
        chunk_sizes=np.array([3, 4], dtype="<u4"))
    sb = StoredBlock(block_index=bi, block_data=b"abcdefg")
    blob = sb.to_bytes()
    sb2 = StoredBlock.from_bytes(blob)
    assert sb2.block_data == b"abcdefg"
    assert sb2.block_index.block_hash == 42
    assert sb2.chunk_offsets().tolist() == [0, 3]


def test_store_index_roundtrip():
    blocks = [
        BlockIndex(block_hash=100, hash_identifier=HASH_TYPE_BLAKE3, tag=1,
                   chunk_hashes=np.array([1, 2], dtype="<u8"),
                   chunk_sizes=np.array([10, 20], dtype="<u4")),
        BlockIndex(block_hash=200, hash_identifier=HASH_TYPE_BLAKE3, tag=2,
                   chunk_hashes=np.array([3], dtype="<u8"),
                   chunk_sizes=np.array([30], dtype="<u4")),
    ]
    si = StoreIndex.from_blocks(blocks)
    assert si.version == CURRENT_STORE_INDEX_VERSION == 0x01000000
    assert si.block_count == 2 and si.chunk_count == 3
    assert si.block_chunks_offsets.tolist() == [0, 2]
    blob = si.to_bytes()
    si2 = StoreIndex.from_bytes(blob)
    assert np.array_equal(si2.block_hashes, si.block_hashes)
    assert np.array_equal(si2.chunk_sizes, si.chunk_sizes)
    h, s = si2.block_chunks(1)
    assert h.tolist() == [3] and s.tolist() == [30]
    bi = si2.get_block_index(0)
    assert bi.block_hash == 100 and bi.tag == 1


def test_store_index_empty():
    si = StoreIndex.from_blocks([])
    blob = si.to_bytes()
    si2 = StoreIndex.from_bytes(blob)
    assert si2.block_count == 0 and si2.chunk_count == 0


def test_merge_version_index():
    """Longtail_MergeVersionIndex semantics (src/longtail.c:3059-3413):
    overlay wins per path, overlay-only assets appended, chunks deduped
    first-seen in merged order; merge with self is idempotent."""
    import numpy as np

    from longtail_jax.core.indexing import create_version_index
    from longtail_jax.core.merge import merge_version_index
    from longtail_jax.stores.storage import MemStorage

    def make(files):
        st = MemStorage()
        st.create_dir("root")
        for path, data in files.items():
            st.write(f"root/{path}", data)
        return create_version_index(st, "root", target_chunk_size=512)

    base = make({"a.txt": b"alpha" * 200, "b.txt": b"beta" * 300,
                 "c.txt": b"gamma" * 100})
    overlay = make({"b.txt": b"BETA2" * 400, "d.txt": b"delta" * 150})

    merged = merge_version_index(base, overlay)
    by_path = {merged.path(i): i for i in range(merged.asset_count)}
    assert set(by_path) == {"a.txt", "b.txt", "c.txt", "d.txt"}
    # overlay wins for b.txt
    ob = {overlay.path(i): i for i in range(overlay.asset_count)}["b.txt"]
    mb = by_path["b.txt"]
    assert merged.asset_sizes[mb] == overlay.asset_sizes[ob]
    assert merged.content_hashes[mb] == overlay.content_hashes[ob]
    got = merged.chunk_hashes[merged.asset_chunks(mb)]
    want = overlay.chunk_hashes[overlay.asset_chunks(ob)]
    assert np.array_equal(got, want)
    # base wins for a.txt
    ba = {base.path(i): i for i in range(base.asset_count)}["a.txt"]
    ma = by_path["a.txt"]
    assert merged.content_hashes[ma] == base.content_hashes[ba]
    # chunk table is deduplicated
    assert len(np.unique(merged.chunk_hashes)) == merged.chunk_count
    # round-trips through the zero-parse format
    from longtail_jax.formats.version_index import VersionIndex
    again = VersionIndex.from_bytes(merged.to_bytes())
    assert again.paths() == merged.paths()
    assert np.array_equal(again.chunk_hashes, merged.chunk_hashes)
    # self-merge is identity on the interesting invariants
    self_merged = merge_version_index(merged, merged)
    assert self_merged.asset_count == merged.asset_count
    assert np.array_equal(np.sort(self_merged.chunk_hashes),
                          np.sort(merged.chunk_hashes))


def test_merge_version_index_validates():
    import dataclasses

    import pytest

    from longtail_jax.core.indexing import create_version_index
    from longtail_jax.core.merge import merge_version_index
    from longtail_jax.stores.storage import MemStorage

    st = MemStorage()
    st.create_dir("r")
    st.write("r/x", b"data")
    a = create_version_index(st, "r", target_chunk_size=512)
    b = dataclasses.replace(a, target_chunk_size=1024)
    with pytest.raises(ValueError):
        merge_version_index(a, b)
