"""Read-only virtual filesystem over (block store + version index)
(lib/blockstorestorage/longtail_blockstorestorage.c): powers CLI ls/cp.

Ranged file reads resolve chunk-by-chunk to block fetches (:324-360); an LRU
wrapper keeps hot blocks in memory for random access.
"""

from __future__ import annotations

import numpy as np

from longtail_jax.formats.version_index import VersionIndex
from longtail_jax.stores.lrublockstore import LRUBlockStore


def list_version_dir(version_index: VersionIndex, prefix: str = ""):
    """Yield (name, size, is_dir, permissions) of direct children of prefix
    (the path-tree view blockstorestorage builds, :46-230)."""
    if prefix and not prefix.endswith("/"):
        prefix = prefix + "/"
    seen = set()
    for i in range(version_index.asset_count):
        path = version_index.path(i)
        if not path.startswith(prefix) or path == prefix:
            continue
        rest = path[len(prefix):].rstrip("/")
        if "/" in rest:
            continue  # not a direct child
        if rest in seen:
            continue
        seen.add(rest)
        yield (rest, int(version_index.asset_sizes[i]), path.endswith("/"),
               int(version_index.permissions[i]))


class BlockStoreStorage:
    """Read-only Storage view; paths are version-index relative.

    Implements the read side of the Storage protocol (the reference exposes
    a complete Longtail_StorageAPI over a store,
    lib/blockstorestorage/longtail_blockstorestorage.c:1492), so generic
    consumers — ``walk_files``, CLI ls/cp — run over it unchanged; mutating
    ops raise PermissionError like the reference's EACCES returns.
    """

    def __init__(self, block_store, version_index: VersionIndex,
                 lru_blocks: int = 32):
        self.version_index = version_index
        self.block_store = LRUBlockStore(block_store, max_count=lru_blocks)
        self._store_index = block_store.get_existing_content(
            version_index.chunk_hashes, 0)
        # chunk hash -> (block hash, offset, size) in uncompressed block data
        self._chunk_map: dict[int, tuple[int, int, int]] = {}
        si = self._store_index
        for b in range(si.block_count):
            hashes, sizes = si.block_chunks(b)
            off = 0
            bh = int(si.block_hashes[b])
            for h, s in zip(hashes, sizes):
                self._chunk_map.setdefault(int(h), (bh, off, int(s)))
                off += int(s)
        self._asset_by_path = {version_index.path(i): i
                               for i in range(version_index.asset_count)}

    @staticmethod
    def _norm(path: str) -> str:
        return path.lstrip("/")

    def exists(self, path: str) -> bool:
        path = self._norm(path)
        return path in self._asset_by_path or (path + "/") in self._asset_by_path

    def is_dir(self, path: str) -> bool:
        path = self._norm(path)
        return path == "" or (path.rstrip("/") + "/") in self._asset_by_path

    def get_size(self, path: str) -> int:
        path = self._norm(path)
        return int(self.version_index.asset_sizes[self._asset_by_path[path]])

    def get_permissions(self, path: str) -> int:
        path = self._norm(path)
        a = self._asset_by_path.get(path)
        if a is None:
            a = self._asset_by_path[path.rstrip("/") + "/"]
        return int(self.version_index.permissions[a])

    def list_dir(self, path: str):
        return [name for name, _, _, _ in
                list_version_dir(self.version_index, self._norm(path))]

    # -- mutating side of the Storage protocol: read-only store ------------
    def _read_only(self, *_a, **_k):
        raise PermissionError("BlockStoreStorage is read-only")

    write = write_ranges = open_append = set_size = _read_only
    create_dir = remove_file = remove_dir = rename = _read_only
    set_permissions = lock_file = unlock_file = _read_only

    def read(self, path: str, offset: int = 0,
             size: int | None = None) -> bytes:
        a = self._asset_by_path[self._norm(path)]
        asset_size = int(self.version_index.asset_sizes[a])
        if size is None:
            size = asset_size - offset
        end = min(offset + size, asset_size)
        out = bytearray()
        pos = 0
        for ci in self.version_index.asset_chunks(a):
            if pos >= end:
                break
            csize = int(self.version_index.chunk_sizes[ci])
            if pos + csize > offset:
                h = int(self.version_index.chunk_hashes[ci])
                bh, boff, bsize = self._chunk_map[h]
                block = self.block_store.get_stored_block(bh)
                lo = max(offset - pos, 0)
                hi = min(end - pos, csize)
                out += block.block_data[boff + lo:boff + hi]
            pos += csize
        return bytes(out)
