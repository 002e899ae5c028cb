"""Multi-host (DCN) upsync: per-process file shards + a chunk-result
exchange collective.

The reference is single-node; its only cross-process story is the
``store.lsi.sync`` file lock (lib/fsblockstore/longtail_fsblockstore.c:
1443).  Scaling indexing over N hosts is embarrassingly parallel up to
the global dedup: every process scans the same deterministic file list,
chunks its own shard of files through its local data plane (host, one
chip, or a per-process mesh), then the per-asset chunk streams are
exchanged with a padded all-gather over DCN
(jax.experimental.multihost_utils) so every process holds the full
ChunkedAssets — the replicated-dedup-output design SURVEY §2.5 calls
for.  From there the missing-content plan is deterministic and
identical everywhere, so blocks shard by index: each process assembles
and uploads its own slice (block assembly reads source bytes, so the
source tree must be readable from every process — the shared-
filesystem deployment the reference's fsblockstore already assumes),
the store index merges under the reference-compatible ``.lsi`` lock
protocol, and process 0 writes the ``.lvi``.

Entry points:
- ``initialize(...)``: thin jax.distributed.initialize wrapper.
- ``upsync_sharded(...)``: the N-process upsync driver; with a single
  process it degrades to exactly ``api.upsync``.

The 2-process CPU dryrun (``__graft_entry__.dryrun_multichip`` /
tests/test_multihost.py) runs this end to end and asserts the merged
store + ``.lvi`` are byte-identical to a single-process run.
"""

from __future__ import annotations

import numpy as np

from longtail_jax.formats import constants as C
from longtail_jax.utils.progress import null_progress


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """jax.distributed.initialize passthrough (no-op if already up)."""
    import jax

    jax.distributed.initialize(coordinator_address, num_processes,
                               process_id)


def process_info() -> tuple[int, int]:
    import jax

    return jax.process_index(), jax.process_count()


def shard_assets(file_infos, process_id: int, num_processes: int):
    """Deterministic size-balanced shard: chunkable assets sorted by
    size (descending, index tiebreak) and dealt round-robin."""
    sizes = file_infos.sizes.astype(np.int64)
    # explicit dtype: np.array([]) of an empty comprehension is float64,
    # and bitwise-& with a bool array raises on a dirs-only/empty tree
    is_file = np.fromiter((not p.endswith("/") for p in file_infos.paths),
                          dtype=bool, count=len(file_infos.paths))
    chunked = np.flatnonzero(is_file & (sizes > 0))
    order = chunked[np.lexsort((chunked, -sizes[chunked]))]
    return order[process_id::num_processes]


def _allgather_padded(arr: np.ndarray):
    """All-gather a variable-length 1-D array across processes: gather
    lengths, pad to the max, gather, return the list of per-process
    arrays (trimmed)."""
    import jax
    from jax.experimental import multihost_utils as mh

    n = np.asarray(arr).shape[0]
    lens = np.asarray(mh.process_allgather(np.array([n], np.int64)))
    lens = lens.reshape(-1)
    m = int(lens.max()) if lens.size else 0
    pad = np.zeros(m, dtype=arr.dtype)
    pad[:n] = arr
    gathered = np.asarray(mh.process_allgather(pad))
    gathered = gathered.reshape(jax.process_count(), m)
    return [gathered[p, : int(lens[p])] for p in range(len(lens))]


def exchange_chunk_results(my_assets, results, count: int):
    """Exchange per-asset (hashes u64, sizes u32) chunk streams so every
    process holds the full ``results`` list for all ``count`` assets.

    ``my_assets``: asset indexes this process chunked; ``results``: the
    full-length list with entries filled only at my_assets.  u64 hashes
    travel as u32 pairs (DCN-friendly lane width)."""
    import jax

    if jax.process_count() == 1:
        return results
    my_assets = np.asarray(my_assets, dtype=np.int64)
    counts = np.array([len(results[int(a)][0]) for a in my_assets],
                      dtype=np.int64)
    flat_h = np.concatenate(
        [results[int(a)][0] for a in my_assets]) if len(my_assets) \
        else np.zeros(0, np.uint64)
    flat_s = np.concatenate(
        [results[int(a)][1] for a in my_assets]) if len(my_assets) \
        else np.zeros(0, np.uint32)
    lo = (flat_h & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (flat_h >> np.uint64(32)).astype(np.uint32)

    g_assets = _allgather_padded(my_assets)
    g_counts = _allgather_padded(counts)
    g_lo = _allgather_padded(lo)
    g_hi = _allgather_padded(hi)
    g_sz = _allgather_padded(flat_s)

    out = [(np.zeros(0, np.uint64), np.zeros(0, np.uint32))
           for _ in range(count)]
    for p in range(len(g_assets)):
        off = 0
        for a, c in zip(g_assets[p], g_counts[p]):
            c = int(c)
            h = g_lo[p][off:off + c].astype(np.uint64) | (
                g_hi[p][off:off + c].astype(np.uint64) << np.uint64(32))
            out[int(a)] = (h, g_sz[p][off:off + c].copy())
            off += c
    return out


def barrier(name: str = "sync") -> None:
    import jax
    from jax.experimental import multihost_utils as mh

    if jax.process_count() > 1:
        mh.sync_global_devices(name)


def upsync_sharded(source_storage, source_root: str, block_store,
                   target_chunk_size: int = C.DEFAULT_TARGET_CHUNK_SIZE,
                   target_block_size: int = C.DEFAULT_TARGET_BLOCK_SIZE,
                   max_chunks_per_block: int = C.DEFAULT_MAX_CHUNKS_PER_BLOCK,
                   hash_identifier: int = C.HASH_TYPE_BLAKE3,
                   compression_tag: int = C.COMPRESSION_TYPE_LZ4_DEFAULT,
                   workers: int = 8, xp=np, progress=null_progress):
    """The N-process upsync: returns (version_index, version_store_index)
    on every process (identical); blocks are written by their owning
    process only."""
    import jax

    from longtail_jax.core import store_algebra
    from longtail_jax.core.dedup import create_missing_content
    from longtail_jax.core.indexing import (
        FileInfos,
        assemble_chunked_assets,
        build_version_index_from_chunked,
        chunk_assets,
        get_files_recursively,
    )
    from longtail_jax.core.write import write_content
    from longtail_jax.ops.hash_registry import get_hasher

    pid, nproc = process_info()
    file_infos = get_files_recursively(source_storage, source_root,
                                       workers=workers)
    mine = shard_assets(file_infos, pid, nproc)

    # chunk my shard through the local data plane
    sub = FileInfos(
        paths=[file_infos.paths[int(a)] for a in mine],
        sizes=file_infos.sizes[mine] if len(mine) else
        np.zeros(0, np.uint64),
        permissions=file_infos.permissions[mine] if len(mine) else
        np.zeros(0, np.uint16))
    ca_sub = chunk_assets(source_storage, source_root, sub,
                          hash_identifier, target_chunk_size,
                          workers=workers, xp=xp)
    results = [(np.zeros(0, np.uint64), np.zeros(0, np.uint32))
               for _ in range(file_infos.count)]
    for j, a in enumerate(mine):
        s = ca_sub.asset_chunk_start_index[j]
        c = ca_sub.asset_chunk_counts[j]
        results[int(a)] = (ca_sub.chunk_hashes[s:s + c],
                           ca_sub.chunk_sizes[s:s + c])

    # the DCN collective: everyone ends up with every asset's chunks
    results = exchange_chunk_results(mine, results, file_infos.count)

    hasher = get_hasher(hash_identifier)
    asset_tags = np.full(file_infos.count, compression_tag, np.uint32)
    ca = assemble_chunked_assets(results, file_infos, hasher, asset_tags)
    version_index = build_version_index_from_chunked(
        ca, file_infos, hash_identifier, target_chunk_size)

    # deterministic plan, identical on every process; blocks shard by
    # index and each process uploads its own slice.  The barrier after
    # the snapshot is load-bearing: without it a fast process starts
    # writing .lrb files that a slow process's get_existing_content
    # (rebuild-by-scan on a fresh store) would pick up, giving the two
    # processes DIFFERENT missing-content plans — and index-sharding
    # different plans leaves some blocks written by nobody.
    existing = block_store.get_existing_content(version_index.chunk_hashes)
    missing = create_missing_content(
        existing, version_index, target_block_size, max_chunks_per_block)
    barrier("upsync-plan-snapshot")
    my_blocks = range(pid, missing.block_count, nproc)
    write_content(source_storage, block_store, missing, version_index,
                  source_root, workers=workers,
                  block_indexes=my_blocks, progress=progress)
    block_store.flush()
    barrier("upsync-content")
    return version_index, store_algebra.merge_store_index(missing, existing)


def downsync_sharded(block_store, target_storage, target_root: str,
                     version_index,
                     min_block_usage_percent: int = 0,
                     retain_permissions: bool = True,
                     workers: int = 8, progress=null_progress) -> None:
    """N-process reconstruction into a SHARED target filesystem: every
    process computes the same deterministic plan (store coverage for the
    version's chunks), blocks are dealt round-robin by index, each
    process fetch->decode->scatters only its own slice, and permissions
    are retained once after the barrier.  The distributed serve-side
    story the reference (single-node) has no analog for; SURVEY §2.5.

    The target must be reachable from every process (the same shared-
    filesystem deployment upsync_sharded assumes).  Pre-sizing and
    directory creation are idempotent, so processes need no coordination
    beyond the plan-snapshot barrier and the completion barrier."""
    from longtail_jax.core.change import change_version

    pid, nproc = process_info()
    # other processes may have merged blocks into the store since this
    # process cached its index view (e.g. a sharded upsync just before)
    reload = getattr(block_store, "reload_index", None)
    if reload is not None:
        reload()
    store_index = block_store.get_existing_content(
        version_index.chunk_hashes, min_block_usage_percent)
    # the plan must be identical everywhere: snapshot before any process
    # mutates the target (a racing rebuild-by-scan could otherwise see
    # different store states)
    barrier("downsync-plan-snapshot")
    mine = range(pid, store_index.block_count, nproc)
    change_version(block_store, target_storage, version_index,
                   store_index, target_root,
                   retain_permissions_flag=False,
                   workers=workers, block_indexes=mine,
                   progress=progress)
    barrier("downsync-content")
    if pid == 0 and retain_permissions:
        from longtail_jax.core.change import retain_permissions as _rp

        _rp(target_storage, version_index, target_root)
    barrier("downsync-done")


def _dryrun_main() -> None:
    """One process of the 2-process CPU dryrun (spawned by
    __graft_entry__.dryrun_multichip / tests/test_multihost.py).
    Parameters ride environment variables; process 0 writes the .lvi."""
    import os

    import jax

    # two dryrun workers on one host must not both open the one card
    jax.config.update("jax_platforms", "cpu")

    from longtail_jax.stores.compressblockstore import CompressBlockStore
    from longtail_jax.stores.fsblockstore import FSBlockStore
    from longtail_jax.stores.storage import FSStorage

    initialize(os.environ["LT_MH_COORD"],
               int(os.environ["LT_MH_NPROC"]),
               int(os.environ["LT_MH_PID"]))
    st = FSStorage()
    store = CompressBlockStore(
        FSBlockStore(FSStorage(), os.environ["LT_MH_STORE"]))
    vi, vsi = upsync_sharded(
        st, os.environ["LT_MH_SRC"], store,
        target_chunk_size=int(os.environ.get("LT_MH_TCS", "1024")),
        workers=4)
    if process_info()[0] == 0:
        with open(os.environ["LT_MH_LVI"], "wb") as f:
            f.write(vi.to_bytes())
    barrier("dryrun-upsync-done")
    # the serve direction, sharded over the same two processes: blocks
    # dealt round-robin, scatters into one shared target
    out = os.environ.get("LT_MH_OUT")
    if out:
        downsync_sharded(store, st, out, vi, workers=4)
    barrier("dryrun-done")


if __name__ == "__main__":
    _dryrun_main()
