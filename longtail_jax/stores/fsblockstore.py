"""Persistent filesystem block store
(lib/fsblockstore/longtail_fsblockstore.c).

Layout matches the reference so stores interoperate on disk:

- blocks at ``chunks/<first-4-hex>/0x<16-hex>.lrb`` (GetBlockName :66-92,
  default extension :1486)
- store index at ``store.lsi``; crash-safe update = write to a unique tmp
  name then atomic rename, guarded by the cross-process ``store.lsi.sync``
  file lock, merged with any concurrently-updated on-disk index
  (SafeWriteStoreIndex :146-241)
- a missing/corrupt ``store.lsi`` is rebuilt by scanning block files
  (ReadContent :445).
"""

from __future__ import annotations

import os
import threading

import numpy as np

from longtail_jax.core import store_algebra
from longtail_jax.core.dedup import get_existing_store_index
from longtail_jax.formats.store_index import StoreIndex, StoredBlock
from longtail_jax.formats.version_index import FormatError
from longtail_jax.stores.blockstore import BlockStoreBase
from longtail_jax.stores.storage import Storage, StorageError, ensure_parent_dirs


def block_path(block_hash: int, extension: str = ".lrb") -> str:
    h = f"{block_hash:016x}"
    return f"chunks/{h[:4]}/0x{h}{extension}"


class FSBlockStore(BlockStoreBase):
    def __init__(self, storage: Storage, store_path: str,
                 extension: str = ".lrb", enable_file_mapping: bool = False):
        super().__init__()
        self.storage = storage
        self.store_path = store_path.rstrip("/")
        self.extension = extension
        self._lock = threading.Lock()
        self._index: StoreIndex | None = None
        # block hashes added since the last .lsi flush
        self._pending: list = []
        self._known_blocks: set[int] = set()

    # -- paths -------------------------------------------------------------

    def _p(self, rel: str) -> str:
        return f"{self.store_path}/{rel}" if self.store_path else rel

    def _block_path(self, block_hash: int) -> str:
        return self._p(block_path(block_hash, self.extension))

    # -- index management --------------------------------------------------

    def _read_disk_index(self) -> StoreIndex | None:
        path = self._p("store.lsi")
        try:
            return StoreIndex.from_bytes(self.storage.read(path))
        except (StorageError, FormatError, FileNotFoundError):
            return None

    def _scan_blocks(self) -> StoreIndex:
        """Rebuild the index by reading every block file's BlockIndex."""
        blocks = []
        chunks_dir = self._p("chunks")
        if self.storage.is_dir(chunks_dir):
            for sub in self.storage.list_dir(chunks_dir):
                subdir = f"{chunks_dir}/{sub}"
                if not self.storage.is_dir(subdir):
                    continue
                for name in self.storage.list_dir(subdir):
                    if not name.endswith(self.extension):
                        continue
                    try:
                        sb = StoredBlock.from_bytes(
                            self.storage.read(f"{subdir}/{name}"))
                        blocks.append(sb.block_index)
                    except (StorageError, FormatError, FileNotFoundError):
                        continue  # skip corrupt blocks, like ScanBlock
        return StoreIndex.from_blocks(blocks)

    def _get_index(self) -> StoreIndex:
        with self._lock:
            if self._index is None:
                idx = self._read_disk_index()
                if idx is None:
                    idx = self._scan_blocks()
                self._index = idx
                self._known_blocks = set(int(h) for h in idx.block_hashes)
            return self._index

    # -- BlockStore API ----------------------------------------------------

    def put_stored_block(self, stored_block: StoredBlock) -> None:
        bh = stored_block.block_index.block_hash
        path = self._block_path(bh)
        with self._lock:
            index_loaded = self._index is not None
            known = bh in self._known_blocks if index_loaded else False
        if not known and not self.storage.exists(path):
            blob = stored_block.to_bytes()
            ensure_parent_dirs(self.storage, path)
            # crash-safe: unique tmp name then rename
            # (SafeWriteStoredBlock, lib/fsblockstore/…:243)
            tmp = path + f".tmp-{os.getpid()}-{threading.get_ident()}"
            self.storage.write(tmp, blob)
            self.storage.rename(tmp, path)
            self.stats.bump("put_stored_block_byte_count", len(blob))
            self.stats.bump("chunks_in_put_count",
                            stored_block.block_index.chunk_count)
        with self._lock:
            if bh not in self._known_blocks:
                self._known_blocks.add(bh)
                self._pending.append(stored_block.block_index)
        self.stats.bump("put_stored_block_count")

    def get_stored_block(self, block_hash: int) -> StoredBlock:
        # mmap the .lrb (lib/fsblockstore/longtail_fsblockstore.c:928):
        # the parse slices straight out of the mapping, no staging copy
        from longtail_jax.stores.storage import map_or_read

        try:
            with map_or_read(self.storage, self._block_path(block_hash)) \
                    as mf:
                blob = mf.view
                self.stats.bump("get_stored_block_count")
                self.stats.bump("get_stored_block_byte_count", len(blob))
                sb = StoredBlock.from_bytes(blob)
                # the index arrays are frombuffer views into the mapping;
                # detach them before the map closes (payload is already a
                # one-copy bytes — half the copies of the read() path)
                bi = sb.block_index
                bi.chunk_hashes = bi.chunk_hashes.copy()
                bi.chunk_sizes = bi.chunk_sizes.copy()
        except (StorageError, FileNotFoundError):
            self.stats.bump("get_stored_block_fail_count")
            raise
        self.stats.bump("chunks_in_get_count", sb.block_index.chunk_count)
        return sb

    def get_existing_content(self, chunk_hashes: np.ndarray,
                             min_block_usage_percent: int = 0) -> StoreIndex:
        self.stats.bump("get_existing_content_count")
        self.flush()
        return get_existing_store_index(
            self._get_index(), chunk_hashes, min_block_usage_percent)

    def prune_blocks(self, keep_block_hashes: np.ndarray) -> int:
        """Longtail_BlockStoreAPI PruneBlocks: drop blocks not in keep set
        (FSBlockStore_PruneBlocks)."""
        self.flush()
        index = self._get_index()
        keep = set(int(h) for h in np.asarray(keep_block_hashes, np.uint64))
        pruned_index = store_algebra.prune_store_index(index, keep)
        removed = 0
        for bh in index.block_hashes:
            if int(bh) not in keep:
                try:
                    self.storage.remove_file(self._block_path(int(bh)))
                    removed += 1
                except (StorageError, FileNotFoundError):
                    pass
        with self._lock:
            self._index = pruned_index
            self._known_blocks = set(int(h) for h in pruned_index.block_hashes)
            self._pending = []
        self._write_index_locked(pruned_index, replace=True)
        return removed

    def flush(self) -> None:
        """Merge pending block indexes into store.lsi under the cross-process
        lock (FSBlockStore_Flush -> SafeWriteStoreIndex)."""
        with self._lock:
            pending = self._pending
            self._pending = []
            if not pending:
                return
            added = StoreIndex.from_blocks(pending)
            base = self._index if self._index is not None else \
                StoreIndex.from_blocks([])
            self._index = store_algebra.merge_store_index(base, added)
            current = self._index
        self._write_index_locked(current, replace=False)
        self.stats.bump("flush_count")

    def reload_index(self) -> None:
        """Drop the cached in-memory index so the next read re-loads
        ``store.lsi`` from disk — required when ANOTHER process has
        merged blocks into the store since this instance cached its view
        (the multi-process sharded upsync/downsync handoff,
        parallel/multihost.py).  Pending local additions flush first."""
        self.flush()
        with self._lock:
            self._index = None

    def _write_index_locked(self, index: StoreIndex, replace: bool) -> None:
        lock_path = self._p("store.lsi.sync")
        ensure_parent_dirs(self.storage, lock_path)
        handle = self.storage.lock_file(lock_path)
        try:
            if not replace:
                disk = self._read_disk_index()
                if disk is not None:
                    # merge with what other processes wrote meanwhile;
                    # local (newer) takes precedence
                    index = store_algebra.merge_store_index(index, disk)
                    with self._lock:
                        self._index = index
                        self._known_blocks = set(
                            int(h) for h in index.block_hashes)
            tmp = self._p(f"store.lsi.tmp-{os.getpid()}-{threading.get_ident()}")
            self.storage.write(tmp, index.to_bytes())
            self.storage.rename(tmp, self._p("store.lsi"))
        finally:
            self.storage.unlock_file(handle)
