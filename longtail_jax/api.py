"""High-level pipelines: the library-level equivalents of the reference CLI
commands (UpSync cmd/main.c:940, DownSync :1236, ValidateVersionIndex :1594).
"""

from __future__ import annotations

import numpy as np

from longtail_jax.core import store_algebra
from longtail_jax.core.change import change_version
from longtail_jax.core.dedup import create_missing_content
from longtail_jax.core.diff import create_version_diff, get_required_chunk_hashes
from longtail_jax.core.merge import merge_version_index
from longtail_jax.core.indexing import create_version_index, \
    get_files_recursively
from longtail_jax.core.write import write_content
from longtail_jax.formats import constants as C
from longtail_jax.formats.store_index import StoreIndex
from longtail_jax.formats.version_index import VersionIndex
from longtail_jax.stores.storage import Storage
from longtail_jax.utils import memtracer
from longtail_jax.utils.progress import null_progress


def upsync(source_storage: Storage, source_root: str, block_store,
           target_chunk_size: int = C.DEFAULT_TARGET_CHUNK_SIZE,
           target_block_size: int = C.DEFAULT_TARGET_BLOCK_SIZE,
           max_chunks_per_block: int = C.DEFAULT_MAX_CHUNKS_PER_BLOCK,
           min_block_usage_percent: int = 0,
           hash_identifier: int = C.HASH_TYPE_BLAKE3,
           compression_tag: int = C.COMPRESSION_TYPE_LZ4_DEFAULT,
           workers: int = 8, path_filter=None, xp=np, mesh=None,
           progress=null_progress) -> tuple[VersionIndex, StoreIndex]:
    """Index a folder and upload its missing blocks.

    ``mesh``: a jax.sharding.Mesh — shard the chunk+hash data plane over
    its devices with the global-dedup collective (SURVEY §2.5).

    Returns (version_index, version_store_index): the manifest plus a store
    index covering exactly this version's chunks (existing + newly written),
    suitable for --version-local-store-index workflows.
    """
    file_infos = get_files_recursively(source_storage, source_root,
                                       path_filter, workers=workers)
    asset_tags = np.full(file_infos.count, compression_tag, dtype=np.uint32)
    with memtracer.context("ChunkAssets"):
        version_index = create_version_index(
            source_storage, source_root, file_infos, hash_identifier,
            target_chunk_size, asset_tags=asset_tags, workers=workers, xp=xp,
            mesh=mesh, progress=progress)

    existing = block_store.get_existing_content(
        version_index.chunk_hashes, min_block_usage_percent)
    missing = create_missing_content(
        existing, version_index, target_block_size, max_chunks_per_block)
    with memtracer.context("WriteContent"):
        write_content(source_storage, block_store, missing, version_index,
                      source_root, workers=workers, progress=progress)
    block_store.flush()
    version_store_index = store_algebra.merge_store_index(missing, existing)
    return version_index, version_store_index


def downsync(block_store, target_storage: Storage, target_root: str,
             source_version_index: VersionIndex,
             current_version_index: VersionIndex | None = None,
             retain_permissions: bool = True, scan_target: bool = True,
             min_block_usage_percent: int = C.DEFAULT_MIN_BLOCK_USAGE_PERCENT,
             workers: int = 8, cancel_token=None, xp=np,
             progress=null_progress) -> None:
    """Materialize source_version_index at target_root, fetching only
    missing blocks (DownSync, cmd/main.c:1236)."""
    if current_version_index is None and scan_target and \
            target_storage.is_dir(target_root):
        current_version_index = create_version_index(
            target_storage, target_root,
            hash_identifier=source_version_index.hash_identifier,
            target_chunk_size=source_version_index.target_chunk_size,
            workers=workers, xp=xp)

    if current_version_index is not None:
        diff = create_version_diff(current_version_index, source_version_index)
        if not diff.any_changes:
            return
        required = get_required_chunk_hashes(source_version_index, diff)
    else:
        diff = None
        required = source_version_index.chunk_hashes

    store_index = block_store.get_existing_content(
        required, min_block_usage_percent)
    if len(required) and store_index.block_count == 0 and \
            min_block_usage_percent > 0:
        # usage cutoff starved us of coverage; retry without it
        store_index = block_store.get_existing_content(required, 0)

    with memtracer.context("ChangeVersion"):
        change_version(block_store, target_storage, source_version_index,
                       store_index, target_root,
                       source_version_index=current_version_index, diff=diff,
                       retain_permissions_flag=retain_permissions,
                       workers=workers, cancel_token=cancel_token,
                       progress=progress)


def validate_version(block_store, version_index: VersionIndex):
    """ValidateVersionIndex (cmd/main.c:1594): the store must cover every
    chunk the version references."""
    store_index = block_store.get_existing_content(
        version_index.chunk_hashes, 0)
    return store_algebra.validate_store(store_index, version_index)
