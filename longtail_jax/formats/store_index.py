"""StoreIndex / BlockIndex / StoredBlock zero-parse formats.

Byte layouts (little-endian) match the reference:

StoreIndex (``Longtail_GetStoreIndexDataSize`` src/longtail.c:8913-8931,
``InitStoreIndexFromData`` :8979-9048)::

    u32 version               (1.0.0 -> 0x010000, src/longtail.c:19)
    u32 hash_identifier
    u32 block_count
    u32 chunk_count
    u64 block_hashes[block_count]
    u64 chunk_hashes[chunk_count]       (concatenated per block)
    u32 block_chunks_offsets[block_count]
    u32 block_chunk_counts[block_count]
    u32 block_tags[block_count]
    u32 chunk_sizes[chunk_count]

BlockIndex (``Longtail_GetBlockIndexDataSize`` :3585-3601)::

    u64 block_hash            (= hash of chunk_hashes bytes, :3744-3747)
    u32 hash_identifier
    u32 chunk_count
    u32 tag
    u64 chunk_hashes[chunk_count]
    u32 chunk_sizes[chunk_count]

StoredBlock on disk (``Longtail_WriteStoredBlockToBuffer`` :4111-4144) is the
BlockIndex data immediately followed by the (possibly compressed) chunk data.
"""

from __future__ import annotations

import dataclasses
import io
import struct

import numpy as np

from longtail_jax.formats.constants import CURRENT_STORE_INDEX_VERSION
from longtail_jax.formats.version_index import FormatError

_STORE_HEADER = struct.Struct("<4I")
_BLOCK_HEADER = struct.Struct("<QIII")


@dataclasses.dataclass
class BlockIndex:
    block_hash: int
    hash_identifier: int
    tag: int
    chunk_hashes: np.ndarray   # u64[chunk_count]
    chunk_sizes: np.ndarray    # u32[chunk_count]

    @property
    def chunk_count(self) -> int:
        return len(self.chunk_hashes)

    @property
    def block_data_size(self) -> int:
        return int(np.asarray(self.chunk_sizes, dtype=np.uint64).sum())

    def to_bytes(self) -> bytes:
        return (_BLOCK_HEADER.pack(self.block_hash, self.hash_identifier,
                                   self.chunk_count, self.tag)
                + np.ascontiguousarray(self.chunk_hashes, dtype="<u8").tobytes()
                + np.ascontiguousarray(self.chunk_sizes, dtype="<u4").tobytes())

    @property
    def data_size(self) -> int:
        """Serialized size of this block index."""
        return _BLOCK_HEADER.size + 12 * self.chunk_count

    @classmethod
    def from_bytes(cls, data: bytes, offset: int = 0) -> "BlockIndex":
        if len(data) - offset < _BLOCK_HEADER.size:
            raise FormatError("block index too small for header")
        block_hash, hash_id, chunk_count, tag = _BLOCK_HEADER.unpack_from(data, offset)
        off = offset + _BLOCK_HEADER.size
        need = chunk_count * 12
        if len(data) - off < need:
            raise FormatError("block index truncated")
        chunk_hashes = np.frombuffer(data, dtype="<u8", count=chunk_count, offset=off)
        off += chunk_count * 8
        chunk_sizes = np.frombuffer(data, dtype="<u4", count=chunk_count, offset=off)
        return cls(block_hash=block_hash, hash_identifier=hash_id, tag=tag,
                   chunk_hashes=chunk_hashes, chunk_sizes=chunk_sizes)


@dataclasses.dataclass
class StoredBlock:
    block_index: BlockIndex
    block_data: bytes  # chunk payloads concatenated (possibly compressed)

    def to_bytes(self) -> bytes:
        return self.block_index.to_bytes() + self.block_data

    @classmethod
    def from_bytes(cls, data: bytes) -> "StoredBlock":
        block_index = BlockIndex.from_bytes(data)
        return cls(block_index=block_index,
                   block_data=bytes(data[block_index.data_size:]))

    def chunk_offsets(self) -> np.ndarray:
        """Byte offset of each chunk inside (uncompressed) block_data."""
        sizes = np.asarray(self.block_index.chunk_sizes, dtype=np.uint64)
        offsets = np.zeros(len(sizes), dtype=np.uint64)
        np.cumsum(sizes[:-1], out=offsets[1:])
        return offsets


@dataclasses.dataclass
class StoreIndex:
    hash_identifier: int
    block_hashes: np.ndarray          # u64[block_count]
    chunk_hashes: np.ndarray          # u64[chunk_count]
    block_chunks_offsets: np.ndarray  # u32[block_count]
    block_chunk_counts: np.ndarray    # u32[block_count]
    block_tags: np.ndarray            # u32[block_count]
    chunk_sizes: np.ndarray           # u32[chunk_count]
    version: int = CURRENT_STORE_INDEX_VERSION

    @property
    def block_count(self) -> int:
        return len(self.block_hashes)

    @property
    def chunk_count(self) -> int:
        return len(self.chunk_hashes)

    def block_chunks(self, block_index: int) -> tuple[np.ndarray, np.ndarray]:
        """(chunk_hashes, chunk_sizes) of one block, in block order."""
        off = int(self.block_chunks_offsets[block_index])
        count = int(self.block_chunk_counts[block_index])
        return (self.chunk_hashes[off:off + count],
                self.chunk_sizes[off:off + count])

    def get_block_index(self, block_index: int) -> BlockIndex:
        # Longtail_MakeBlockIndex (src/longtail.c:9117-9141)
        hashes, sizes = self.block_chunks(block_index)
        return BlockIndex(
            block_hash=int(self.block_hashes[block_index]),
            hash_identifier=self.hash_identifier,
            tag=int(self.block_tags[block_index]),
            chunk_hashes=hashes, chunk_sizes=sizes)

    # -- serialization -----------------------------------------------------

    def to_bytes(self) -> bytes:
        out = io.BytesIO()
        out.write(_STORE_HEADER.pack(self.version, self.hash_identifier,
                                     self.block_count, self.chunk_count))
        for arr, dt in (
            (self.block_hashes, "<u8"),
            (self.chunk_hashes, "<u8"),
            (self.block_chunks_offsets, "<u4"),
            (self.block_chunk_counts, "<u4"),
            (self.block_tags, "<u4"),
            (self.chunk_sizes, "<u4"),
        ):
            out.write(np.ascontiguousarray(arr, dtype=dt).tobytes())
        return out.getvalue()

    @classmethod
    def from_bytes(cls, data: bytes) -> "StoreIndex":
        if len(data) < _STORE_HEADER.size:
            raise FormatError("store index too small for header")
        version, hash_id, block_count, chunk_count = _STORE_HEADER.unpack_from(data, 0)
        if version != CURRENT_STORE_INDEX_VERSION:
            raise FormatError(f"unsupported store index version {version:#x}")
        off = _STORE_HEADER.size

        def take(count: int, dt: str) -> np.ndarray:
            nonlocal off
            itemsize = np.dtype(dt).itemsize
            end = off + count * itemsize
            if end > len(data):
                raise FormatError("store index truncated")
            arr = np.frombuffer(data, dtype=dt, count=count, offset=off)
            off = end
            return arr

        block_hashes = take(block_count, "<u8")
        chunk_hashes = take(chunk_count, "<u8")
        block_chunks_offsets = take(block_count, "<u4")
        block_chunk_counts = take(block_count, "<u4")
        block_tags = take(block_count, "<u4")
        chunk_sizes = take(chunk_count, "<u4")
        return cls(
            version=version, hash_identifier=hash_id,
            block_hashes=block_hashes, chunk_hashes=chunk_hashes,
            block_chunks_offsets=block_chunks_offsets,
            block_chunk_counts=block_chunk_counts,
            block_tags=block_tags, chunk_sizes=chunk_sizes)

    @classmethod
    def from_blocks(cls, block_indexes: list[BlockIndex]) -> "StoreIndex":
        """Longtail_CreateStoreIndexFromBlocks (src/longtail.c:9066-9115)."""
        hash_identifier = 0
        for bi in block_indexes:
            if bi.hash_identifier:
                hash_identifier = bi.hash_identifier
                break
        block_count = len(block_indexes)
        counts = np.array([b.chunk_count for b in block_indexes], dtype="<u4")
        offsets = np.zeros(block_count, dtype="<u4")
        if block_count:
            np.cumsum(counts[:-1], out=offsets[1:])
        chunk_hashes = (np.concatenate([np.asarray(b.chunk_hashes, dtype="<u8")
                                        for b in block_indexes])
                        if block_count else np.zeros(0, dtype="<u8"))
        chunk_sizes = (np.concatenate([np.asarray(b.chunk_sizes, dtype="<u4")
                                       for b in block_indexes])
                       if block_count else np.zeros(0, dtype="<u4"))
        return cls(
            hash_identifier=hash_identifier,
            block_hashes=np.array([b.block_hash for b in block_indexes], dtype="<u8"),
            chunk_hashes=chunk_hashes,
            block_chunks_offsets=offsets,
            block_chunk_counts=counts,
            block_tags=np.array([b.tag for b in block_indexes], dtype="<u4"),
            chunk_sizes=chunk_sizes)

    @classmethod
    def empty(cls, hash_identifier: int = 0) -> "StoreIndex":
        return cls.from_blocks([]) if hash_identifier == 0 else cls(
            hash_identifier=hash_identifier,
            block_hashes=np.zeros(0, dtype="<u8"),
            chunk_hashes=np.zeros(0, dtype="<u8"),
            block_chunks_offsets=np.zeros(0, dtype="<u4"),
            block_chunk_counts=np.zeros(0, dtype="<u4"),
            block_tags=np.zeros(0, dtype="<u4"),
            chunk_sizes=np.zeros(0, dtype="<u4"))
