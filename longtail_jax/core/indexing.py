"""Folder scan + chunking driver + version-index construction.

Mirrors the semantics of the reference pipeline
(``Longtail_GetFilesRecursively2`` src/longtail.c:1656, ``ChunkAssets`` :2343,
``Longtail_CreateVersionIndex`` :2808) with a batched execution model:

- every file is split into independent parts of ``target_chunk_size * 1024``
  bytes (src/longtail.c:2396-2404), each part chunked with HPCDC bounds
  (min, avg, max) = (target/8, target/2, target*2) clamped to the 48-byte
  window (:1985-1987);
- chunk payloads are hashed in bulk through the batched hasher (lanes of
  padded chunks) instead of one HashBuffer call per chunk;
- per-asset content hash = hash of the asset's chunk-hash array bytes
  (:2518-2537); asset path hash = hash of the utf-8 path (:1269-1279).
"""

from __future__ import annotations

import dataclasses
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from longtail_jax.formats.constants import (
    CHUNKER_WINDOW_SIZE,
    chunker_params_from_target,
)
from longtail_jax.formats.version_index import VersionIndex
from longtail_jax.ops import cdc
from longtail_jax.ops.hash_registry import get_hasher
from longtail_jax.stores.storage import Storage, walk_files
from longtail_jax.utils.progress import null_progress


@dataclasses.dataclass
class FileInfos:
    """Scan result (Longtail_FileInfos, src/longtail.h:1684-1692).
    Directory entries end with '/' and have size 0."""
    paths: list[str]
    sizes: np.ndarray        # u64
    permissions: np.ndarray  # u16

    @property
    def count(self) -> int:
        return len(self.paths)

    @classmethod
    def from_entries(cls, entries: list[tuple[str, int, int]]) -> "FileInfos":
        return cls(
            paths=[e[0] for e in entries],
            sizes=np.array([e[1] for e in entries], dtype=np.uint64),
            permissions=np.array([e[2] for e in entries], dtype=np.uint16),
        )


def get_files_recursively(storage: Storage, root: str, path_filter=None,
                          workers: int = 1) -> FileInfos:
    """Longtail_GetFilesRecursively2 (src/longtail.c:1656): parallel
    per-directory scan jobs when workers > 1; same deterministic order."""
    if workers > 1:
        from longtail_jax.stores.storage import walk_files_parallel
        return FileInfos.from_entries(
            walk_files_parallel(storage, root, path_filter, workers))
    return FileInfos.from_entries(list(walk_files(storage, root, path_filter)))


# ---------------------------------------------------------------------------
# bulk chunk hashing: bucket variable-length chunks into padded lane batches
# ---------------------------------------------------------------------------

_LEAF = 1024


def hash_chunk_batch(hasher, part_data: np.ndarray,
                     offsets: np.ndarray, sizes: np.ndarray,
                     xp=np) -> np.ndarray:
    """Hash chunks [offsets[i], offsets[i]+sizes[i]) of part_data.

    Buckets chunks by padded length (next multiple of 1 KiB) so each bucket is
    a static-shape (lanes, padded) batch — the shape discipline the device
    pipeline needs, also used host-side.
    """
    n = len(sizes)
    out = np.zeros(n, dtype=np.uint64)
    if n == 0:
        return out
    sizes = np.asarray(sizes, dtype=np.int64)
    offsets = np.asarray(offsets, dtype=np.int64)
    if xp is np:
        ranged = getattr(hasher, "hash_ranges", None)
        if ranged is not None:
            res = ranged(part_data, offsets, sizes)
            if res is not None:
                return res
    padded = np.maximum((sizes + _LEAF - 1) // _LEAF, 1) * _LEAF
    # round padded up to the next power-of-two leaf count to bound bucket count
    leaves = padded // _LEAF
    pow2 = np.uint64(1) << np.uint64(np.ceil(np.log2(
        np.maximum(leaves, 1))).astype(np.uint64))
    padded = (pow2 * _LEAF).astype(np.int64)
    for cls_size in np.unique(padded):
        idx = np.flatnonzero(padded == cls_size)
        batch = np.zeros((len(idx), int(cls_size)), dtype=np.uint8)
        for row, i in enumerate(idx):
            o, s = offsets[i], sizes[i]
            batch[row, :s] = part_data[o:o + s]
        out[idx] = np.asarray(hasher.hash_chunks(batch, sizes[idx], xp=xp))
    return out


# ---------------------------------------------------------------------------
# chunking driver
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ChunkedAssets:
    """Per-asset chunk streams, pre-dedup (ChunkAssetsData analog)."""
    chunk_hashes: np.ndarray   # u64[total]
    chunk_sizes: np.ndarray    # u32[total]
    chunk_tags: np.ndarray     # u32[total]
    asset_chunk_counts: np.ndarray  # u32[asset_count]
    asset_chunk_start_index: np.ndarray  # u32[asset_count]
    path_hashes: np.ndarray    # u64[asset_count]
    content_hashes: np.ndarray  # u64[asset_count]


def _part_reader(storage, full_path: str, size: int):
    """Returns read(pos, n) -> uint8 view of the file.

    Files over 1 MiB go through map_file (zero-copy, the reference's mmap
    chunking path src/longtail.c:2130-2216); small files use plain reads
    so thousands of tiny assets don't pin thousands of mappings.  The
    returned arrays keep the mapping alive via their buffer reference."""
    from longtail_jax.stores.storage import map_or_read

    if size >= (1 << 20):
        try:
            mf = map_or_read(storage, full_path)
            return lambda pos, n: np.frombuffer(
                mf.view[pos:pos + n], dtype=np.uint8)
        except Exception:
            pass
    return lambda pos, n: np.frombuffer(
        storage.read(full_path, pos, n), dtype=np.uint8)


def _chunk_one_asset(storage, root: str, path: str, size: int,
                     target_chunk_size: int, hasher, xp):
    """Chunk + hash a single asset, part by part. Returns (hashes, sizes)."""
    min_s, avg_s, max_s = chunker_params_from_target(target_chunk_size)
    max_part = target_chunk_size * 1024
    full_path = f"{root}/{path}" if root else path
    read = _part_reader(storage, full_path, size)
    all_hashes = []
    all_sizes = []
    pos = 0
    while pos < size:
        part_size = min(max_part, size - pos)
        data = read(pos, part_size)
        if part_size <= CHUNKER_WINDOW_SIZE:
            # whole part is one chunk (DynamicChunking small-part path,
            # src/longtail.c:2053-2115)
            ends = np.array([part_size], dtype=np.int64)
        else:
            ends = cdc.chunk_part(data, min_s, avg_s, max_s)
        starts = np.concatenate([[0], ends[:-1]])
        sizes = (ends - starts).astype(np.int64)
        hashes = hash_chunk_batch(hasher, data, starts, sizes, xp=xp)
        all_hashes.append(hashes)
        all_sizes.append(sizes.astype(np.uint32))
        pos += part_size
    if not all_hashes:
        return (np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=np.uint32))
    return (np.concatenate(all_hashes), np.concatenate(all_sizes))


def _chunk_assets_device(storage, root: str, file_infos: FileInfos,
                         target_chunk_size: int, hash_kind: str = "blake3",
                         progress=null_progress, workers: int = 8) -> list:
    """Device data plane: stream large files' parts through the device
    chunk+hash pipeline (parallel/pipeline.py) while small files run on
    the host's native path concurrently — a small file would waste a
    whole fixed-shape device lane, and the host covers it in microseconds.
    Returns the per-asset results list in the same (hashes u64, sizes u32)
    shape as the host path."""
    from longtail_jax.formats.constants import (
        HASH_TYPE_BLAKE2,
        HASH_TYPE_BLAKE3,
    )
    from longtail_jax.parallel.pipeline import DevicePartIndexer

    indexer = DevicePartIndexer(target_chunk_size, hash_kind=hash_kind)
    max_part = indexer.part_bytes
    small_cutoff = max(indexer.cfg.max_size, max_part // 64)
    count = file_infos.count
    results = [
        (np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=np.uint32))
        for _ in range(count)
    ]
    big = [i for i in range(count)
           if int(file_infos.sizes[i]) > small_cutoff]
    small = [i for i in range(count)
             if 0 < int(file_infos.sizes[i]) <= small_cutoff]

    done = 0
    done_lock = threading.Lock()

    def tick():
        nonlocal done
        with done_lock:
            done += 1
            progress(min(done, count), count)

    # host side for small assets, overlapped with the device stream
    hasher = get_hasher(
        {"blake3": HASH_TYPE_BLAKE3, "blake2": HASH_TYPE_BLAKE2}[hash_kind])

    def small_work(i: int):
        results[i] = _chunk_one_asset(
            storage, root, file_infos.paths[i], int(file_infos.sizes[i]),
            target_chunk_size, hasher, np)
        tick()

    pool = ThreadPoolExecutor(max_workers=max(1, workers // 2))
    futures = [pool.submit(small_work, i) for i in small]

    def parts():
        for i in big:
            size = int(file_infos.sizes[i])
            path = file_infos.paths[i]
            full = f"{root}/{path}" if root else path
            read = _part_reader(storage, full, size)
            pos = 0
            while pos < size:
                n = min(max_part, size - pos)
                yield i, read(pos, n)
                pos += n

    acc: dict[int, list] = {}
    for i, sizes, hashes in indexer.index_stream(parts()):
        acc.setdefault(i, []).append((hashes, sizes))
        tick()
    for i, pieces in acc.items():
        results[i] = (np.concatenate([p[0] for p in pieces]),
                      np.concatenate([p[1] for p in pieces]))
    for f in futures:
        f.result()
    pool.shutdown()
    return results


def _chunk_assets_mesh(storage, root: str, file_infos: FileInfos,
                       target_chunk_size: int, mesh,
                       progress=null_progress) -> list:
    """Mesh data plane: one device-pinned instance of the production
    chunk+hash pipeline per mesh device (parallel/pipeline.py
    MeshPartIndexer), batches dealt round-robin — the same stage-1 and
    stage-3 programs as the single-device path, per device,
    with each device's async pipeline overlapping independently
    (SURVEY §2.5: one hot loop for every configuration).

    Single-controller assembly: per-part results return to the host in
    submission order and global dedup is the host-side unique in
    create_version_index; the all-gather dedup collective
    (parallel/distributed.py) covers multi-process deployments, where
    each process runs this driver over its own file shard."""
    from longtail_jax.parallel.pipeline import MeshPartIndexer

    devices = list(mesh.devices.flat)
    indexer = MeshPartIndexer(target_chunk_size, devices, prewarm=True)
    P = indexer.part_bytes
    count = file_infos.count
    results = [
        (np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=np.uint32))
        for _ in range(count)
    ]

    def parts():
        for i in range(count):
            size = int(file_infos.sizes[i])
            path = file_infos.paths[i]
            full = f"{root}/{path}" if root else path
            read = _part_reader(storage, full, size)
            pos = 0
            while pos < size:
                n = min(P, size - pos)
                yield (i, pos), read(pos, n)
                pos += n

    acc: dict[int, list] = {}
    done = 0
    for (i, pos), sizes, hashes in indexer.index_stream(parts()):
        acc.setdefault(i, []).append((pos, hashes, sizes))
        done += 1
        progress(min(done, count), count)
    for i, pieces in acc.items():
        pieces.sort(key=lambda p: p[0])
        results[i] = (np.concatenate([p[1] for p in pieces]),
                      np.concatenate([p[2] for p in pieces]))
    return results


def chunk_assets(storage: Storage, root: str, file_infos: FileInfos,
                 hash_identifier: int, target_chunk_size: int,
                 asset_tags: np.ndarray | None = None,
                 workers: int | None = None, xp=np,
                 mesh=None,
                 progress=null_progress) -> ChunkedAssets:
    from longtail_jax.formats.constants import HASH_TYPE_BLAKE3

    hasher = get_hasher(hash_identifier)
    count = file_infos.count

    path_hashes = np.array(
        [hasher.hash_buffer(p.encode("utf-8")) for p in file_infos.paths],
        dtype=np.uint64) if count else np.zeros(0, dtype=np.uint64)

    from longtail_jax.formats.constants import HASH_TYPE_BLAKE2

    device_kinds = {HASH_TYPE_BLAKE3: "blake3", HASH_TYPE_BLAKE2: "blake2"}
    if mesh is not None and hash_identifier == HASH_TYPE_BLAKE3:
        # multi-chip data plane: lanes sharded over the mesh + dedup
        # collective (parallel/distributed.py)
        results = _chunk_assets_mesh(
            storage, root, file_infos, target_chunk_size, mesh, progress)
    elif xp is not np and hash_identifier in device_kinds:
        # device data plane (chunk scan + resolution + hashing on the device)
        results = _chunk_assets_device(
            storage, root, file_infos, target_chunk_size,
            device_kinds[hash_identifier], progress, workers or 8)
    else:
        results = [None] * count

        def work(i: int):
            results[i] = _chunk_one_asset(
                storage, root, file_infos.paths[i], int(file_infos.sizes[i]),
                target_chunk_size, hasher, xp)
            progress(i + 1, count)

        if workers and workers > 1 and count > 1:
            with ThreadPoolExecutor(max_workers=workers) as pool:
                list(pool.map(work, range(count)))
        else:
            for i in range(count):
                work(i)

    return assemble_chunked_assets(results, file_infos, hasher,
                                   asset_tags, path_hashes)


def assemble_chunked_assets(results, file_infos: FileInfos, hasher,
                            asset_tags=None,
                            path_hashes=None) -> ChunkedAssets:
    """Fold per-asset (hashes, sizes) streams into ChunkedAssets —
    per-asset content hash = hash of the chunk-hash bytes
    (src/longtail.c:2518-2537).  Also the reassembly step after the
    multi-host chunk-result exchange."""
    count = file_infos.count
    if path_hashes is None:
        path_hashes = np.array(
            [hasher.hash_buffer(p.encode("utf-8"))
             for p in file_infos.paths],
            dtype=np.uint64) if count else np.zeros(0, dtype=np.uint64)
    counts = np.array([len(r[0]) for r in results], dtype=np.uint32)
    starts = np.zeros(count, dtype=np.uint32)
    if count:
        np.cumsum(counts[:-1], out=starts[1:])
    total = int(counts.sum())
    chunk_hashes = np.concatenate([r[0] for r in results]) if count \
        else np.zeros(0, dtype=np.uint64)
    chunk_sizes = np.concatenate([r[1] for r in results]) if count \
        else np.zeros(0, dtype=np.uint32)
    if asset_tags is not None:
        chunk_tags = np.repeat(np.asarray(asset_tags, dtype=np.uint32), counts)
    else:
        chunk_tags = np.zeros(total, dtype=np.uint32)

    # content hash = hash of the asset's chunk-hash bytes (src/longtail.c:2531)
    content_hashes = np.array([
        hasher.hash_buffer(
            chunk_hashes[starts[i]:starts[i] + counts[i]]
            .astype("<u8").tobytes())
        for i in range(count)
    ], dtype=np.uint64) if count else np.zeros(0, dtype=np.uint64)

    return ChunkedAssets(
        chunk_hashes=chunk_hashes, chunk_sizes=chunk_sizes,
        chunk_tags=chunk_tags, asset_chunk_counts=counts,
        asset_chunk_start_index=starts, path_hashes=path_hashes,
        content_hashes=content_hashes)


# ---------------------------------------------------------------------------
# version index construction
# ---------------------------------------------------------------------------

def build_name_data(paths: list[str]) -> tuple[np.ndarray, bytes]:
    offsets = np.zeros(len(paths), dtype=np.uint32)
    blob = bytearray()
    for i, p in enumerate(paths):
        offsets[i] = len(blob)
        blob += p.encode("utf-8") + b"\0"
    return offsets, bytes(blob)


def create_version_index(storage: Storage, root: str,
                         file_infos: FileInfos | None = None,
                         hash_identifier: int | None = None,
                         target_chunk_size: int = 32768,
                         asset_tags: np.ndarray | None = None,
                         workers: int | None = None, xp=np,
                         mesh=None, path_filter=None,
                         progress=null_progress) -> VersionIndex:
    """Longtail_CreateVersionIndex (src/longtail.c:2808).

    ``mesh``: a jax.sharding.Mesh — shard the chunk+hash data plane over
    its devices (multi-chip path, parallel/distributed.py)."""
    from longtail_jax.formats.constants import HASH_TYPE_BLAKE3
    if hash_identifier is None:
        hash_identifier = HASH_TYPE_BLAKE3
    if file_infos is None:
        file_infos = get_files_recursively(storage, root, path_filter,
                                           workers=workers or 1)

    ca = chunk_assets(storage, root, file_infos, hash_identifier,
                      target_chunk_size, asset_tags, workers, xp,
                      mesh, progress)
    return build_version_index_from_chunked(
        ca, file_infos, hash_identifier, target_chunk_size)


def build_version_index_from_chunked(ca: ChunkedAssets,
                                     file_infos: FileInfos,
                                     hash_identifier: int,
                                     target_chunk_size: int) -> VersionIndex:
    """Longtail_BuildVersionIndex (src/longtail.c:2709): assemble the
    zero-parse index from already-chunked per-asset streams.  Separate
    from create_version_index so the multi-host driver can feed it the
    globally exchanged chunk results (parallel/multihost.py)."""
    # dedup chunks preserving first-occurrence order (src/longtail.c:2949-2972)
    uniq_hashes, first_idx, inverse = np.unique(
        ca.chunk_hashes, return_index=True, return_inverse=True)
    order = np.argsort(first_idx, kind="stable")
    # remap so unique chunks appear in first-occurrence order
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    asset_chunk_indexes = rank[inverse].astype(np.uint32)
    chunk_hashes = uniq_hashes[order]
    chunk_sizes = ca.chunk_sizes[first_idx[order]] if len(order) \
        else np.zeros(0, dtype=np.uint32)
    chunk_tags = ca.chunk_tags[first_idx[order]] if len(order) \
        else np.zeros(0, dtype=np.uint32)

    name_offsets, name_data = build_name_data(file_infos.paths)

    return VersionIndex(
        hash_identifier=hash_identifier,
        target_chunk_size=target_chunk_size,
        path_hashes=ca.path_hashes,
        content_hashes=ca.content_hashes,
        asset_sizes=file_infos.sizes.astype("<u8"),
        asset_chunk_counts=ca.asset_chunk_counts,
        asset_chunk_index_starts=ca.asset_chunk_start_index,
        asset_chunk_indexes=asset_chunk_indexes,
        chunk_hashes=chunk_hashes.astype("<u8"),
        chunk_sizes=chunk_sizes.astype("<u4"),
        chunk_tags=chunk_tags.astype("<u4"),
        name_offsets=name_offsets,
        permissions=file_infos.permissions.astype("<u2"),
        name_data=name_data,
    )
