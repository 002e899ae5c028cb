"""VersionIndex: the zero-parse manifest of one folder version.

Byte layout (little-endian, one contiguous blob) matches the reference
(``Longtail_GetVersionIndexDataSize`` src/longtail.c:2552-2587
and ``InitVersionIndexFromData`` :2613-2706)::

    u32 version            (0x000002, src/longtail.c:18)
    u32 hash_identifier    ('blk3' etc.)
    u32 target_chunk_size
    u32 asset_count
    u32 chunk_count
    u32 asset_chunk_index_count
    u64 path_hashes[asset_count]
    u64 content_hashes[asset_count]
    u64 asset_sizes[asset_count]
    u32 asset_chunk_counts[asset_count]
    u32 asset_chunk_index_starts[asset_count]
    u32 asset_chunk_indexes[asset_chunk_index_count]
    u64 chunk_hashes[chunk_count]
    u32 chunk_sizes[chunk_count]
    u32 chunk_tags[chunk_count]
    u32 name_offsets[asset_count]
    u16 permissions[asset_count]
    u8  name_data[]          (nul-terminated utf-8 paths)
"""

from __future__ import annotations

import dataclasses
import io
import struct

import numpy as np

from longtail_jax.formats.constants import CURRENT_VERSION_INDEX_VERSION

_HEADER = struct.Struct("<6I")


class FormatError(ValueError):
    """Raised when a serialized blob fails validation (reference: EBADF)."""


@dataclasses.dataclass
class VersionIndex:
    hash_identifier: int
    target_chunk_size: int
    # per-asset
    path_hashes: np.ndarray          # u64[asset_count]
    content_hashes: np.ndarray       # u64[asset_count]
    asset_sizes: np.ndarray          # u64[asset_count]
    asset_chunk_counts: np.ndarray   # u32[asset_count]
    asset_chunk_index_starts: np.ndarray  # u32[asset_count]
    asset_chunk_indexes: np.ndarray  # u32[asset_chunk_index_count]
    # per-unique-chunk
    chunk_hashes: np.ndarray         # u64[chunk_count]
    chunk_sizes: np.ndarray          # u32[chunk_count]
    chunk_tags: np.ndarray           # u32[chunk_count]
    # path table
    name_offsets: np.ndarray         # u32[asset_count]
    permissions: np.ndarray          # u16[asset_count]
    name_data: bytes
    version: int = CURRENT_VERSION_INDEX_VERSION

    # -- accessors ---------------------------------------------------------

    @property
    def asset_count(self) -> int:
        return len(self.path_hashes)

    @property
    def chunk_count(self) -> int:
        return len(self.chunk_hashes)

    @property
    def asset_chunk_index_count(self) -> int:
        return len(self.asset_chunk_indexes)

    def path(self, asset_index: int) -> str:
        off = int(self.name_offsets[asset_index])
        end = self.name_data.index(b"\0", off)
        return self.name_data[off:end].decode("utf-8")

    def paths(self) -> list[str]:
        return [self.path(i) for i in range(self.asset_count)]

    def asset_chunks(self, asset_index: int) -> np.ndarray:
        """Indexes into chunk_hashes for one asset, in file order."""
        start = int(self.asset_chunk_index_starts[asset_index])
        count = int(self.asset_chunk_counts[asset_index])
        return self.asset_chunk_indexes[start:start + count]

    def flat_chunk_walk(self, asset_indexes=None):
        """Vectorized per-asset chunk traversal: the array form of looping
        ``asset_chunks()`` per asset (the shape the reference walks in
        CreateAssetPartLookup src/longtail.c:4429 and CreateBlockWriteInfos
        :8571).

        Returns int64 arrays ``(asset_of, chunk_index, file_offset)`` with
        one entry per (asset, chunk) pair in file order; ``file_offset`` is
        the chunk's byte offset within its asset.
        """
        if asset_indexes is None:
            assets = np.arange(self.asset_count, dtype=np.int64)
        else:
            assets = np.asarray(asset_indexes, dtype=np.int64)
        counts = self.asset_chunk_counts[assets].astype(np.int64)
        total = int(counts.sum())
        if total == 0:
            z = np.zeros(0, dtype=np.int64)
            return z, z.copy(), z.copy()
        first = np.cumsum(counts) - counts        # run starts in flat order
        asset_of = np.repeat(assets, counts)
        pos = np.arange(total, dtype=np.int64) - np.repeat(first, counts)
        flat_ci = self.asset_chunk_indexes[
            self.asset_chunk_index_starts[asset_of].astype(np.int64) + pos
        ].astype(np.int64)
        sizes = self.chunk_sizes[flat_ci].astype(np.int64)
        csum = np.cumsum(sizes)
        ex = csum - sizes                         # exclusive global prefix
        # trailing zero-chunk assets have first == total; their repeat
        # contributes nothing, but the index must stay in bounds
        offsets = ex - np.repeat(ex[np.minimum(first, total - 1)], counts)
        return asset_of, flat_ci, offsets

    def is_dir(self, asset_index: int) -> bool:
        return self.path(asset_index).endswith("/")

    # -- serialization -----------------------------------------------------

    def to_bytes(self) -> bytes:
        out = io.BytesIO()
        out.write(_HEADER.pack(self.version, self.hash_identifier,
                               self.target_chunk_size, self.asset_count,
                               self.chunk_count, self.asset_chunk_index_count))
        for arr, dt in (
            (self.path_hashes, "<u8"),
            (self.content_hashes, "<u8"),
            (self.asset_sizes, "<u8"),
            (self.asset_chunk_counts, "<u4"),
            (self.asset_chunk_index_starts, "<u4"),
            (self.asset_chunk_indexes, "<u4"),
            (self.chunk_hashes, "<u8"),
            (self.chunk_sizes, "<u4"),
            (self.chunk_tags, "<u4"),
            (self.name_offsets, "<u4"),
            (self.permissions, "<u2"),
        ):
            out.write(np.ascontiguousarray(arr, dtype=dt).tobytes())
        out.write(self.name_data)
        return out.getvalue()

    @classmethod
    def from_bytes(cls, data: bytes) -> "VersionIndex":
        if len(data) < _HEADER.size:
            raise FormatError("version index too small for header")
        (version, hash_id, target_chunk_size, asset_count, chunk_count,
         aci_count) = _HEADER.unpack_from(data, 0)
        if version != CURRENT_VERSION_INDEX_VERSION:
            raise FormatError(f"unsupported version index version {version:#x}")

        off = _HEADER.size

        def take(count: int, dt: str) -> np.ndarray:
            nonlocal off
            itemsize = np.dtype(dt).itemsize
            end = off + count * itemsize
            if end > len(data):
                raise FormatError("version index truncated")
            arr = np.frombuffer(data, dtype=dt, count=count, offset=off)
            off = end
            return arr

        path_hashes = take(asset_count, "<u8")
        content_hashes = take(asset_count, "<u8")
        asset_sizes = take(asset_count, "<u8")
        asset_chunk_counts = take(asset_count, "<u4")
        asset_chunk_index_starts = take(asset_count, "<u4")
        asset_chunk_indexes = take(aci_count, "<u4")
        chunk_hashes = take(chunk_count, "<u8")
        chunk_sizes = take(chunk_count, "<u4")
        chunk_tags = take(chunk_count, "<u4")
        name_offsets = take(asset_count, "<u4")
        permissions = take(asset_count, "<u2")
        name_data = bytes(data[off:])

        return cls(
            version=version,
            hash_identifier=hash_id,
            target_chunk_size=target_chunk_size,
            path_hashes=path_hashes,
            content_hashes=content_hashes,
            asset_sizes=asset_sizes,
            asset_chunk_counts=asset_chunk_counts,
            asset_chunk_index_starts=asset_chunk_index_starts,
            asset_chunk_indexes=asset_chunk_indexes,
            chunk_hashes=chunk_hashes,
            chunk_sizes=chunk_sizes,
            chunk_tags=chunk_tags,
            name_offsets=name_offsets,
            permissions=permissions,
            name_data=name_data,
        )

    @classmethod
    def empty(cls, hash_identifier: int, target_chunk_size: int) -> "VersionIndex":
        u64 = np.zeros(0, dtype="<u8")
        u32 = np.zeros(0, dtype="<u4")
        u16 = np.zeros(0, dtype="<u2")
        return cls(
            hash_identifier=hash_identifier,
            target_chunk_size=target_chunk_size,
            path_hashes=u64, content_hashes=u64.copy(), asset_sizes=u64.copy(),
            asset_chunk_counts=u32, asset_chunk_index_starts=u32.copy(),
            asset_chunk_indexes=u32.copy(), chunk_hashes=u64.copy(),
            chunk_sizes=u32.copy(), chunk_tags=u32.copy(),
            name_offsets=u32.copy(), permissions=u16, name_data=b"",
        )
