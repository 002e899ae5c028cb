"""Version-index merge (Longtail_MergeVersionIndex, src/longtail.c:3059-3413).

Overlay semantics: the merged index holds every base asset in base order,
followed by overlay-only assets in overlay order; when a path exists in
both, the overlay's version of the asset wins (chunks, size, permissions,
content hash).  The merged chunk table is the unique chunks of the winning
assets, first-seen in merged-asset walk order.
"""

from __future__ import annotations

import numpy as np

from longtail_jax.formats.version_index import VersionIndex


def merge_version_index(base: VersionIndex,
                        overlay: VersionIndex) -> VersionIndex:
    if base.target_chunk_size != overlay.target_chunk_size:
        raise ValueError("target_chunk_size mismatch")
    if base.hash_identifier != overlay.hash_identifier:
        raise ValueError("hash_identifier mismatch")

    o_lut = {int(h): i for i, h in enumerate(overlay.path_hashes)}
    b_set = set(int(h) for h in base.path_hashes)

    # merged asset list: (source, source_asset_index) in merged order
    src = []          # 0 = base, 1 = overlay
    src_idx = []
    for i, h in enumerate(base.path_hashes):
        j = o_lut.get(int(h))
        if j is not None:
            src.append(1)
            src_idx.append(j)
        else:
            src.append(0)
            src_idx.append(i)
    for j, h in enumerate(overlay.path_hashes):
        if int(h) not in b_set:
            src.append(1)
            src_idx.append(j)
    src = np.asarray(src, dtype=np.int64)
    src_idx = np.asarray(src_idx, dtype=np.int64)
    n_assets = len(src)

    # per-side flat chunk walks, tagged with merged position, then
    # interleaved back into merged-asset order
    sides = (base, overlay)
    walk_pos = []
    walk_hash = []
    walk_size = []
    walk_tag = []
    for s, vi in enumerate(sides):
        sel = np.flatnonzero(src == s)
        if len(sel) == 0:
            continue
        asset_of, flat_ci, _ = vi.flat_chunk_walk(src_idx[sel])
        counts = vi.asset_chunk_counts[src_idx[sel]].astype(np.int64)
        walk_pos.append(np.repeat(sel, counts))
        walk_hash.append(vi.chunk_hashes[flat_ci])
        walk_size.append(vi.chunk_sizes[flat_ci])
        walk_tag.append(vi.chunk_tags[flat_ci])
    if walk_pos:
        pos = np.concatenate(walk_pos)
        order = np.argsort(pos, kind="stable")
        hashes = np.concatenate(walk_hash)[order]
        sizes = np.concatenate(walk_size)[order]
        tags = np.concatenate(walk_tag)[order]
        pos = pos[order]
    else:
        pos = np.zeros(0, np.int64)
        hashes = np.zeros(0, np.uint64)
        sizes = np.zeros(0, np.uint32)
        tags = np.zeros(0, np.uint32)

    # chunk dedup, first-seen order preserved
    uh, first, inverse = np.unique(hashes, return_index=True,
                                   return_inverse=True)
    rank = np.empty(len(uh), dtype=np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(len(uh))
    asset_chunk_indexes = rank[inverse].astype(np.uint32)
    first_seen = np.sort(first)
    chunk_hashes = hashes[first_seen]
    chunk_sizes = sizes[first_seen]
    chunk_tags = tags[first_seen]

    counts = np.bincount(pos, minlength=n_assets).astype(np.uint32)
    starts = (np.cumsum(counts, dtype=np.int64)
              - counts.astype(np.int64)).astype(np.uint32)

    # per-asset metadata from the winning side
    path_hashes = np.empty(n_assets, np.uint64)
    content_hashes = np.empty(n_assets, np.uint64)
    asset_sizes = np.empty(n_assets, np.uint64)
    permissions = np.empty(n_assets, np.uint16)
    name_offsets = np.empty(n_assets, np.uint32)
    name_data = bytearray()
    for m in range(n_assets):
        vi = sides[src[m]]
        a = int(src_idx[m])
        path_hashes[m] = vi.path_hashes[a]
        content_hashes[m] = vi.content_hashes[a]
        asset_sizes[m] = vi.asset_sizes[a]
        permissions[m] = vi.permissions[a]
        name_offsets[m] = len(name_data)
        off = int(vi.name_offsets[a])
        end = vi.name_data.index(b"\0", off)
        name_data += vi.name_data[off:end + 1]

    return VersionIndex(
        hash_identifier=base.hash_identifier,
        target_chunk_size=base.target_chunk_size,
        path_hashes=path_hashes,
        content_hashes=content_hashes,
        asset_sizes=asset_sizes,
        asset_chunk_counts=counts,
        asset_chunk_index_starts=starts,
        asset_chunk_indexes=asset_chunk_indexes,
        chunk_hashes=chunk_hashes,
        chunk_sizes=chunk_sizes,
        chunk_tags=chunk_tags,
        name_offsets=name_offsets,
        permissions=permissions,
        name_data=bytes(name_data),
    )
