"""Block-centric version reconstruction (Longtail_ChangeVersion2,
src/longtail.c:8720-8911).

The v2 design fetches every needed block exactly once and scatters its chunks
into all target files at their final offsets (CreateBlockWriteInfos :8571,
WriteContentBlock2Job :8347) — no per-asset re-fetch, no LRU cache needed.
Zero-size assets and directories are materialized separately
(WriteNonBlockAssetsJob :8292); removed assets are deleted children-first
(CleanUpRemoveAssets :7758); permissions are retained last
(RetainPermissions :7931).

``write_version`` (full unpack, Longtail_WriteVersion :6471) is the same
machinery against an empty target.
"""

from __future__ import annotations

import errno
import threading

import numpy as np

from longtail_jax.core.diff import VersionDiff, create_version_diff, \
    get_required_chunk_hashes
from longtail_jax.formats.store_index import StoreIndex
from longtail_jax.formats.version_index import VersionIndex
from longtail_jax.stores.storage import Storage, StorageError, ensure_parent_dirs
from longtail_jax.utils.cancel import check
from longtail_jax.utils.monitor import get_monitor
from longtail_jax.utils.progress import null_progress



def _build_block_write_infos(version_index: VersionIndex,
                             store_index: StoreIndex,
                             asset_indexes) -> dict[int, tuple]:
    """block store-position -> scatter arrays (CreateBlockWriteInfos :8571).

    Vectorized: sorted-hash membership instead of dict loops.  Returns
    {block_pos: (assets, file_offsets, block_offsets, sizes)} int64 arrays,
    each block's writes in asset/file order.
    """
    # store side: chunk hash -> (block position, offset in block data);
    # first block wins (the reference's insert-if-absent, walk in block
    # order over each block's chunk run at block_chunks_offsets)
    s_counts = store_index.block_chunk_counts.astype(np.int64)
    walk_first = np.cumsum(s_counts) - s_counts
    total_s = int(s_counts.sum())
    pos_in_block = (np.arange(total_s, dtype=np.int64)
                    - np.repeat(walk_first, s_counts))
    src_pos = (np.repeat(
        store_index.block_chunks_offsets.astype(np.int64), s_counts)
        + pos_in_block)
    s_hashes = store_index.chunk_hashes[src_pos]
    s_sizes = store_index.chunk_sizes[src_pos].astype(np.int64)
    block_of = np.repeat(
        np.arange(store_index.block_count, dtype=np.int64), s_counts)
    s_ex = np.cumsum(s_sizes) - s_sizes
    s_block_off = s_ex - np.repeat(s_ex[walk_first], s_counts)
    suh, sfirst = np.unique(s_hashes, return_index=True)

    # version side: flat (asset, chunk) walk restricted to asset_indexes
    asset_of, flat_ci, file_off = version_index.flat_chunk_walk(asset_indexes)
    if len(flat_ci) == 0:
        return {}
    h = version_index.chunk_hashes[flat_ci]
    sizes = version_index.chunk_sizes[flat_ci].astype(np.int64)
    if len(suh) == 0:
        raise KeyError(
            f"chunk {int(h[0]):#x} needed by "
            f"{version_index.path(int(asset_of[0]))} not found in any "
            "store block")
    idx = np.searchsorted(suh, h)
    idx_c = np.minimum(idx, len(suh) - 1)
    missing = (idx >= len(suh)) | (suh[idx_c] != h)
    if missing.any():
        m = int(np.flatnonzero(missing)[0])
        raise KeyError(
            f"chunk {int(h[m]):#x} needed by "
            f"{version_index.path(int(asset_of[m]))} not found in any "
            "store block")
    src = sfirst[idx_c]
    b = block_of[src]
    boff = s_block_off[src]

    order = np.argsort(b, kind="stable")  # group by block, keep file order
    b_s, a_s = b[order], asset_of[order]
    fo_s, bo_s, sz_s = file_off[order], boff[order], sizes[order]
    blocks, starts = np.unique(b_s, return_index=True)
    bounds = np.append(starts, len(b_s))
    return {
        int(blocks[i]): (a_s[bounds[i]:bounds[i + 1]],
                         fo_s[bounds[i]:bounds[i + 1]],
                         bo_s[bounds[i]:bounds[i + 1]],
                         sz_s[bounds[i]:bounds[i + 1]])
        for i in range(len(blocks))
    }


def _full_path(root: str, path: str) -> str:
    return f"{root}/{path}" if root else path


def clean_up_removed_assets(storage: Storage, source: VersionIndex,
                            diff: VersionDiff, root: str) -> None:
    """Delete removed assets, children before parents (:7758)."""
    for i in diff.source_removed_asset_indexes:
        path = source.path(int(i))
        full = _full_path(root, path.rstrip("/"))
        try:
            if path.endswith("/"):
                storage.remove_dir(full)
            else:
                storage.remove_file(full)
        except (StorageError, FileNotFoundError, OSError) as e:
            if getattr(e, "errno", None) not in (errno.ENOENT, errno.ENOTEMPTY):
                raise


def retain_permissions(storage: Storage, target: VersionIndex, root: str,
                       asset_indexes=None) -> None:
    indexes = range(target.asset_count) if asset_indexes is None else \
        (int(i) for i in asset_indexes)
    for i in indexes:
        path = target.path(int(i))
        full = _full_path(root, path.rstrip("/"))
        try:
            storage.set_permissions(full, int(target.permissions[int(i)]))
        except (StorageError, FileNotFoundError, OSError):
            pass


def change_version(block_store, version_storage: Storage,
                   target_version_index: VersionIndex,
                   store_index: StoreIndex, root: str,
                   source_version_index: VersionIndex | None = None,
                   diff: VersionDiff | None = None,
                   retain_permissions_flag: bool = True,
                   workers: int = 8, cancel_token=None,
                   block_indexes=None,
                   progress=null_progress) -> None:
    """Longtail_ChangeVersion2 (src/longtail.c:8720).

    ``block_indexes``: restrict the block scatter jobs to these store-
    index block positions (the multi-process sharded downsync deals
    blocks round-robin, parallel/multihost.downsync_sharded); directory/
    zero-size-asset creation and file pre-sizing stay on every process
    (idempotent), cleanup and permission retention are the caller's
    responsibility to run once."""
    target = target_version_index
    if source_version_index is not None and diff is None:
        diff = create_version_diff(source_version_index, target)

    if diff is not None and source_version_index is not None:
        clean_up_removed_assets(version_storage, source_version_index,
                                diff, root)
        write_assets = np.concatenate([
            diff.target_added_asset_indexes,
            diff.target_content_modified_asset_indexes]).astype(np.int64)
    else:
        write_assets = np.arange(target.asset_count, dtype=np.int64)

    mon0 = get_monitor()
    if mon0:
        mon0.version_begin(target.asset_count, target.chunk_count)

    block_store.preflight_get(store_index.block_hashes)

    # non-block assets: directories and zero-size files (:8292); order is
    # short-to-long path so parents exist first
    ordered = sorted((int(a) for a in write_assets),
                     key=lambda a: len(target.path(a)))
    chunked_assets = []
    for a in ordered:
        check(cancel_token)
        path = target.path(a)
        full = _full_path(root, path.rstrip("/"))
        if path.endswith("/"):
            if not version_storage.is_dir(full):
                ensure_parent_dirs(version_storage, full + "/x")
                try:
                    version_storage.create_dir(full)
                except StorageError as e:
                    if e.errno != errno.EEXIST:
                        raise
        elif int(target.asset_sizes[a]) == 0:
            ensure_parent_dirs(version_storage, full)
            version_storage.write(full, b"")
        else:
            chunked_assets.append(a)

    # pre-create/truncate every chunked target file to its final size so
    # concurrent block scatters never race on sizing
    for a in chunked_assets:
        full = _full_path(root, target.path(a))
        ensure_parent_dirs(version_storage, full)
        version_storage.write_ranges(full, int(target.asset_sizes[a]), [])

    per_block = _build_block_write_infos(target, store_index, chunked_assets)
    if block_indexes is not None:
        keep = set(int(b) for b in block_indexes)
        per_block = {b: v for b, v in per_block.items() if b in keep}
    total = len(per_block)

    raw_fetch = getattr(block_store, "get_stored_block_raw", None) or \
        block_store.get_stored_block
    decomp = getattr(block_store, "decompress_stored_block", None) or \
        (lambda blk: blk)

    def fetch_block(b: int):
        check(cancel_token)
        bh = int(store_index.block_hashes[b])
        mon = get_monitor()
        if mon:
            mon.block_load(b, bh, 0)
        return raw_fetch(bh)

    def scatter_block(item, data: bytes) -> None:
        check(cancel_token)
        b, (assets, file_offs, block_offs, sizes) = item
        mon = get_monitor()
        if mon:
            mon.block_compose(b, int(store_index.block_hashes[b]))
        view = memoryview(data)       # zero-copy range slices
        # group consecutive runs per asset (writes arrive in file order)
        uniq, starts = np.unique(assets, return_index=True)
        bounds = np.append(np.sort(starts), len(assets))
        for s, e in zip(bounds[:-1], bounds[1:]):
            a = int(assets[s])
            ranges = [(int(file_offs[i]),
                       view[int(block_offs[i]):int(block_offs[i])
                            + int(sizes[i])])
                      for i in range(s, e)]
            full = _full_path(root, target.path(a))
            if mon:
                mon.asset_write(a, int(file_offs[s]),
                                sum(len(r[1]) for r in ranges))
            version_storage.write_ranges(
                full, int(target.asset_sizes[a]), ranges)

    items = list(per_block.items())
    if workers > 1 and total > 1:
        # overlapped pipeline on the two-channel job graph: raw block
        # fetches on channel 1 (I/O), decompress + scatter on channel 0
        # (CPU), one dependency chain per block with a sliding window so
        # at most `window` blocks are in flight — the reference's
        # channel-1 block readers + in-flight cap, the lever behind its
        # 0.4.1 peak-memory numbers (src/longtail.c:5169, :4997;
        # CHANGELOG.md:73-76).
        from longtail_jax.parallel.jobgraph import JobGraph

        window = max(8, workers + workers // 2)
        graph = JobGraph(workers={0: workers, 1: max(2, workers // 2)})
        done = 0
        done_lock = threading.Lock()

        def tick():
            nonlocal done
            with done_lock:
                done += 1
                progress(done, total)

        scatter_ids: list[int] = []
        for j, item in enumerate(items):
            b = item[0]
            deps_f = [scatter_ids[j - window]] if j >= window else []
            f = graph.add(lambda b=b: fetch_block(b), deps=deps_f,
                          channel=1)

            def decode(f=f, b=b):
                blk = decomp(graph.result(f))
                graph.drop_result(f)
                mon = get_monitor()
                if mon:
                    mon.block_load_complete(
                        b, int(store_index.block_hashes[b]))
                return blk.block_data

            d = graph.add(decode, deps=[f])

            def scatter(item=item, d=d):
                scatter_block(item, graph.result(d))
                graph.drop_result(d)
                tick()

            scatter_ids.append(graph.add(scatter, deps=[d]))
        graph.run()
    else:
        for i, item in enumerate(items):
            blk = decomp(fetch_block(item[0]))
            mon = get_monitor()
            if mon:
                mon.block_load_complete(
                    item[0], int(store_index.block_hashes[item[0]]))
            scatter_block(item, blk.block_data)
            progress(i + 1, total)

    if retain_permissions_flag:
        retain_permissions(version_storage, target, root)
    if mon0:
        mon0.version_end()


def write_version(block_store, version_storage: Storage,
                  store_index: StoreIndex,
                  version_index: VersionIndex, root: str,
                  retain_permissions_flag: bool = True,
                  workers: int = 8, cancel_token=None,
                  progress=null_progress) -> None:
    """Full unpack of a version into an empty folder
    (Longtail_WriteVersion, src/longtail.c:6471)."""
    change_version(block_store, version_storage, version_index, store_index,
                   root, retain_permissions_flag=retain_permissions_flag,
                   workers=workers, cancel_token=cancel_token,
                   progress=progress)
