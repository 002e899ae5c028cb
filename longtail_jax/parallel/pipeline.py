"""Batched device chunk+hash pipeline — the device data plane.

The reference's chunking hot loop is one Bikeshed job per file part
(``ChunkAssets`` src/longtail.c:2429-2462); ours batches file parts into
fixed-shape row buffers and streams them through the device in a
three-stage async pipeline:

- **Stage 1 (device)**: candidate scan + cut-resolution walk
  (parallel/stage1.py) over a whole lane batch in one dispatch.  Only
  chunk *sizes* come back to host — a ~1000:1 data reduction vs the byte
  stream.
- **Stage 2 (host plan)**: host groups the resolved chunks by
  power-of-two padded size class (static-shape discipline), repairing any
  ambiguity-flagged lane exactly via the native host chunker.
- **Stage 3 (device)**: one dispatch per batch packs every chunk's bytes
  out of the resident batch and hashes them, class by class
  (``make_stage3_fn``).

parallel/backend.py chooses each stage's implementation for the backend.
Shape discipline: every device program sees a handful of static shapes —
one stage-1 geometry, one fused stage-3 class plan, and one (padded,
rows) pair per class for rare spill dispatches — so a cold start compiles
a few programs; ``DevicePartIndexer(prewarm=True)`` compiles them
concurrently at construction.  Device buffers use the canonical
``(n_bytes // 128, 128)`` u8 row layout.

Because jax dispatch is async, stage 1 of batch N+1 overlaps host
planning of batch N and the hash dispatch of batch N-1; file I/O is
overlapped by a prefetch thread.

Bit-exactness: stages 1-3 produce exactly the chunk boundaries and
BLAKE3-64 hashes of the host oracle (tests/test_pipeline.py), with
flagged lanes re-chunked on host (stage1 docstring).
"""

from __future__ import annotations

import functools
import queue
import threading
from collections import deque
from typing import Iterable, Iterator, Tuple

import numpy as np

from longtail_jax.parallel import backend
from longtail_jax.parallel.device_chunker import ChunkerConfig
from longtail_jax.parallel.stage1 import (
    Stage1Plan,
    make_stage1_fn,
    padded_words_rows,
    repair_lane,
    unpack_stage1,
)

_LEAF = 1024


def gather_chunk_words(words_flat, starts, sizes, padded: int):
    """The plain pack: (N,) u32 little-endian word stream + (rows,) byte
    starts/sizes -> (rows, padded//4) u32 chunk words starting at offset
    0, zero at and past each size.  A word-aligned window gather, then a
    funnel shift drops the 0..3-byte phase.  ``words_flat`` must hold
    padded/4 + 1 words past every start.  Trace under jit."""
    import jax.numpy as jnp

    nw = words_flat.shape[0]
    w0 = starts // 4
    offs = jnp.arange(padded // 4 + 1, dtype=jnp.int32)
    idx = jnp.clip(w0[:, None] + offs[None, :], 0, nw - 1)
    win = jnp.take(words_flat, idx, axis=0)       # (rows, P4 + 1)
    sh = ((starts % 4) * 8).astype(jnp.uint32)[:, None]
    lo = win[:, :-1] >> sh
    # two-step left shift keeps counts < 32 when sh == 0
    hi = (win[:, 1:] << (jnp.uint32(31) - sh)) << jnp.uint32(1)
    byte0 = (jnp.arange(padded // 4, dtype=jnp.int32) * 4)[None, :]
    nb = jnp.clip(sizes[:, None] - byte0, 0, 4)
    nbp = jnp.minimum(nb, 3).astype(jnp.uint32)
    pmask = (jnp.uint32(1) << (nbp * 8)) - jnp.uint32(1)
    m = jnp.where(nb >= 4, jnp.uint32(0xFFFFFFFF),
                  jnp.where(nb > 0, pmask, jnp.uint32(0)))
    return (lo | hi) & m


def _xla_class_hasher(padded: int, kind: str):
    """Traceable plain pack + hash of one size class: (words_flat,
    starts, sizes) -> (lo, hi) u32.  Rows of size 0 are padding."""
    import jax.numpy as jnp

    if kind == "blake3":
        from longtail_jax.ops.blake3 import hash_chunks_words
    elif kind == "blake2":
        from longtail_jax.ops.blake2 import hash_chunks_words
    else:
        raise ValueError(f"no device hasher for {kind!r}")

    def fn(words_flat, starts, sizes):
        words = gather_chunk_words(words_flat, starts, sizes, padded)
        return hash_chunks_words(words, sizes, xp=jnp)
    return fn


def stage3_body(layout: tuple, kind: str, impls):
    """Traceable stage 3: (words2d (N2, 128) u32, blob) -> (lo, hi)
    (sum rows,) u32 digest words.  ``layout`` is ((cls, rows), ...); the
    blob is the concatenation of each class's starts then sizes (byte
    offsets into the word rows), padding rows of size 0 last in each
    class (their digests are garbage)."""
    import jax.numpy as jnp

    if kind == "blake3" and impls.hash == "triton":
        from longtail_jax.ops.blake3_kernel import hash_layout

        def triton_body(words2d, blob):
            return hash_layout(words2d.reshape(-1), blob, layout,
                               interpret=impls.interpret)
        return triton_body

    hashers = [(r, _xla_class_hasher(cls, kind)) for cls, r in layout]

    def xla_body(words2d, blob):
        los, his = [], []
        o = 0
        for r, hasher in hashers:
            lo, hi = hasher(words2d.reshape(-1), blob[o:o + r],
                            blob[o + r:o + 2 * r])
            o += 2 * r
            los.append(lo)
            his.append(hi)
        return jnp.concatenate(los), jnp.concatenate(his)
    return xla_body


def _row_mult(cls: int) -> int:
    """Row-count divisibility for a size class: rows * leaves must be a
    multiple of 1024 (whole BLAKE3 kernel programs, with room to spare)."""
    leaves = cls // _LEAF
    return max(256, 1024 // max(leaves, 1))


def pow2_cap(padded_chunk: int) -> int:
    """Largest size class: next power-of-two multiple of 1 KiB >=
    padded_chunk.  Every class must be a power-of-two leaf count (the
    BLAKE3 kernel requires it), so when max_size is not a power of two
    (e.g. target 24576 -> max 49152) the cap class rounds UP — a clamp to
    padded_chunk itself would produce a class class_plan never plans and
    _dispatch_buckets would silently drop those chunks."""
    leaves = -(-padded_chunk // _LEAF)
    p = 1
    while p < leaves:
        p *= 2
    return p * _LEAF


def class_floor(cfg: ChunkerConfig) -> int:
    """Smallest size class: the power-of-two >= 2 * min_size (capped).
    Chunks below it pad up into the floor class — the sub-min classes
    hold a small fraction of the bytes, and folding them cuts the
    compiled-program count and the per-batch class count by ~40%."""
    f = _LEAF
    target = min(2 * cfg.min_size, pow2_cap(cfg.padded_chunk))
    while f < target:
        f *= 2
    return f


def class_plan(cfg: ChunkerConfig, batch_bytes: int) -> tuple:
    """Fixed per-batch bucket geometry: ((cls, rows), ...) for every
    power-of-two size class from class_floor up.  Every class gets rows
    for 1.4x the batch's TOTAL expected chunk count (capped by the hard
    per-class maximum batch_bytes / (cls/2)): real corpora concentrate
    chunks in whatever class their structure favors (a text-heavy batch
    cuts ~3/4 of its chunks at the floor class), so share-based
    provisioning spilled on every batch.  The fused stage-3 program keeps
    each class's packed chunks as jit-internal intermediates, so padding
    rows cost device memory only while their class executes.  Overflow
    beyond 1.4x total still spills to same-shape extra dispatches
    (correctness fallback)."""
    e_total = max(1, batch_bytes // cfg.avg_size)
    cap = pow2_cap(cfg.padded_chunk)
    floor = class_floor(cfg)

    plan = []
    c = floor
    while c <= cap:
        # hard max chunks whose padded class is c: sizes > c/2 (for the
        # floor class: sizes > min_size, its smallest possible member)
        hard = batch_bytes // max(c // 2, cfg.min_size)
        m = _row_mult(c)
        rows = min(int(1.4 * e_total), max(hard, 1))
        rows = max(m, -(-rows // m) * m)
        plan.append((c, rows))
        c *= 2
    return tuple(plan)


@functools.lru_cache(maxsize=16)
def make_stage3_fn(layout: tuple, kind: str, impls):
    """ONE jitted dispatch for a batch's stage 3 (stage3_body): a batch
    costs one blob upload, one dispatch and one fetch.  (lo and hi stay
    two outputs: stacking them into one array makes XLA's CPU backend
    emit a program that never finishes.)"""
    import jax

    return jax.jit(stage3_body(layout, kind, impls))


def _pow2_padded(sizes: np.ndarray, cap: int, floor: int = _LEAF
                 ) -> np.ndarray:
    """Next power-of-two multiple of 1 KiB >= size, clamped to
    [floor, cap] (both must be planned classes)."""
    leaves = np.maximum(-(-sizes // _LEAF), 1)
    pow2 = np.uint64(1) << np.uint64(
        np.ceil(np.log2(leaves)).astype(np.int64))
    return np.clip(pow2.astype(np.int64) * _LEAF, floor, cap)


def _prefetch(it: Iterable, depth: int) -> Iterator:
    """Pull from `it` on a background thread so file I/O overlaps device
    compute (the analog of the reference's channel-1 block-reader jobs)."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    _END = object()

    def worker():
        try:
            for x in it:
                q.put(x)
            q.put(_END)
        except BaseException as e:  # propagate into the consumer
            q.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        x = q.get()
        if x is _END:
            return
        if isinstance(x, BaseException):
            raise x
        yield x


class DevicePartIndexer:
    """Streams file parts through the device chunk+hash pipeline.

    Parameters: ``target_chunk_size`` fixes the chunking geometry and the
    part size (``target_chunk_size * 1024``, src/longtail.c:2396-2404);
    ``batch_bytes`` sizes the lane batch (static shape -> one compile set).
    ``prewarm`` compiles every device program concurrently up front.
    parallel/backend.current() picks each stage's implementation.
    """

    def __init__(self, target_chunk_size: int,
                 batch_bytes: int = 64 << 20, lanes: int | None = None,
                 prewarm: bool = False, hash_kind: str = "blake3",
                 device=None, compress: bool = False):
        self.hash_kind = hash_kind
        self.device = device       # pin all work to one mesh device
        self.compress = compress   # stage-1 also emits anchor bin-mins
        self.impls = backend.current()
        self.cfg = ChunkerConfig.from_target(target_chunk_size)
        self.part_bytes = target_chunk_size * 1024
        self.lanes = lanes or max(1, batch_bytes // self.part_bytes)
        if lanes is None and self.impls.max_lanes:
            self.lanes = min(self.lanes, self.impls.max_lanes)
        self.plan = Stage1Plan(self.cfg, self.lanes, self.part_bytes)
        # in-flight batches per pipeline stage: deep enough that the one
        # synchronous fetch per batch overlaps other batches' dispatches
        self.queue_depth = 3
        self._cap = pow2_cap(self.cfg.padded_chunk)
        self._floor = class_floor(self.cfg)
        self._slack = self._cap // 4 + 2048
        self._class_plan = class_plan(self.cfg, self.lanes * self.part_bytes)
        self._stage1 = make_stage1_fn(self.plan, self.impls,
                                      with_anchors=compress,
                                      slack_words=self._slack)
        if prewarm:
            self.prewarm()

    # -- compile warmup ---------------------------------------------------

    def prewarm(self) -> None:
        """Compile every device program this pipeline can dispatch, in
        parallel (cold-start compile latency hiding; the persistent jax
        compilation cache makes later runs instant)."""
        import concurrent.futures as cf

        import jax
        import jax.numpy as jnp

        B, P = self.lanes, self.part_bytes
        R = B * P // 128

        def zeros(shape, dtype):     # on this pipeline's device
            return jax.device_put(jnp.zeros(shape, dtype), self.device)

        def warm_stage1():
            rows = zeros((R, 128), jnp.uint8)
            lens = np.zeros((B,), np.int32)
            jax.block_until_ready(self._stage1(rows, lens)[0])

        def warm_stage3():
            n2 = padded_words_rows(R, self._slack)
            n = sum(2 * r for _, r in self._class_plan)
            jax.block_until_ready(
                make_stage3_fn(self._class_plan, self.hash_kind,
                               self.impls)(
                    zeros((n2, 128), jnp.uint32), zeros((n,), jnp.int32)))

        def warm_anchor_bins():
            from longtail_jax.parallel.device_match import (
                make_bins_anchor_packed_fn,
            )

            n_bins = B * P // 256
            jax.block_until_ready(make_bins_anchor_packed_fn(
                n_bins, (8 << 20) // 256)(zeros((n_bins,), jnp.uint32)))

        jobs = [warm_stage1, warm_stage3]
        if self.compress:
            jobs.append(warm_anchor_bins)
        with cf.ThreadPoolExecutor(max_workers=len(jobs)) as ex:
            list(ex.map(lambda f: f(), jobs))

    # -- stage 1 ----------------------------------------------------------

    def submit(self, tags, dev_rows, lengths, host_rows=None):
        """Stage 1 on an already-device-resident (B*P//128, 128) uint8 row
        batch: dispatch the resolve step (async; the result's D2H copy is
        started immediately) and return the stage-1 entry.  host_rows
        (same bytes on host) enables cheap lane repair.  With
        compress=True the scan kernel also emits the anchor bin-mins,
        carried device-resident in the entry; the word-row relayout for
        stage 3 is computed in the scan dispatch either way."""
        packed, bins, words2d = self._stage1(dev_rows, lengths)  # async
        return (tags, dev_rows, lengths, packed, host_rows, bins, words2d)

    def submit_host(self, batch):
        """Stage 1 from host parts: pack (tag, bytes) pairs into the row
        batch, stage to device, dispatch resolve."""
        import jax

        B, P = self.lanes, self.part_bytes
        tags = [t for t, _ in batch]
        buf = np.zeros((B * P // 128, 128), dtype=np.uint8)
        flat = buf.reshape(-1)
        lengths = np.zeros((B,), dtype=np.int32)
        for i, (_, part) in enumerate(batch):
            part = np.asarray(part, dtype=np.uint8)
            if len(part) > P:
                raise ValueError(
                    f"part of {len(part)} bytes > part_bytes {P}")
            flat[i * P: i * P + len(part)] = part
            lengths[i] = len(part)
        return self.submit(tags, jax.device_put(buf, self.device),
                           lengths, host_rows=buf)

    # -- stage 2 + 3 ------------------------------------------------------

    def plan_hash(self, entry, keep_words: bool = False):
        """Stage 2: sync stage-1 sizes, repair any ambiguity-flagged lane,
        group chunks into power-of-two size buckets, dispatch one
        pack+BLAKE3 call per bucket group (async).

        keep_words=True appends the device-resident word-row batch and
        the stage-1 anchor bin-mins to the returned entry (entries [4]
        and [5]) so a stage-4 consumer (the device block codec,
        parallel/device_match.py) can run on the SAME device-resident data
        without a re-upload or a re-read."""
        tags, dev_rows, lengths, packed_dev, host_rows, bins, words2d = \
            entry
        P = self.part_bytes
        n_lanes = len(tags)
        packed = np.asarray(packed_dev)  # sync point (D2H already running)
        sizes, counts, amb = unpack_stage1(packed, self.plan)
        for b in range(n_lanes):
            if amb[b]:
                if host_rows is not None:
                    lane = host_rows.reshape(-1)[b * P: b * P + lengths[b]]
                else:
                    rp = P // 128
                    lane = np.asarray(
                        dev_rows[b * rp: (b + 1) * rp]).reshape(-1)
                    lane = lane[: lengths[b]]
                fixed = repair_lane(lane, self.cfg)
                counts[b] = len(fixed)
                sizes[b, : len(fixed)] = fixed
                sizes[b, len(fixed):] = 0

        lane_sizes = []
        all_starts, all_sizes = [], []
        for b in range(n_lanes):
            sz = sizes[b, : counts[b]].astype(np.int64)
            lane_sizes.append(sz.astype(np.uint32))
            st = np.zeros(len(sz), dtype=np.int64)
            np.cumsum(sz[:-1], out=st[1:])
            all_starts.append(st + b * P)
            all_sizes.append(sz)
        if all_starts:
            flat_starts = np.concatenate(all_starts)
            flat_sizes = np.concatenate(all_sizes)
        else:
            flat_starts = np.zeros(0, np.int64)
            flat_sizes = np.zeros(0, np.int64)
        padded = _pow2_padded(flat_sizes, self._cap, self._floor) \
            if len(flat_sizes) else flat_sizes
        buckets = self._dispatch_buckets(
            words2d, flat_starts, flat_sizes, padded)
        if keep_words:
            return (tags, lane_sizes, counts[:n_lanes], buckets, words2d,
                    bins)
        return (tags, lane_sizes, counts[:n_lanes], buckets)

    def _dispatch_buckets(self, words2d, flat_starts, flat_sizes, padded):
        """Fixed class plan, one H2D blob upload, ONE fused stage-3
        dispatch (per-class pack + hash + concat in a single program),
        ONE concatenated D2H hash fetch per batch."""
        import jax

        plan = self._class_plan
        blob_parts = []
        mapping = []   # chunk-row indices per planned slot
        spills = []    # (cls, r, rows) overflow slots, dispatched apart
        for cls, r in plan:
            rows_all = np.flatnonzero(padded == cls)
            head, rest = rows_all[:r], rows_all[r:]
            bs = np.zeros(r, dtype=np.int32)
            bz = np.zeros(r, dtype=np.int32)
            bs[: len(head)] = flat_starts[head]
            bz[: len(head)] = flat_sizes[head]
            blob_parts += [bs, bz]
            mapping.append(head)
            for off in range(0, len(rest), r):
                spills.append((cls, r, rest[off: off + r]))
        blob = jax.device_put(np.concatenate(blob_parts), self.device)
        # the blob layout is ALWAYS the class plan — one compiled stage-3
        # program, so no batch's chunk-size distribution can trigger a
        # cold mid-run compile (spill slots go separately below)
        allres = make_stage3_fn(plan, self.hash_kind, self.impls)(
            words2d, blob)
        for x in allres:
            x.copy_to_host_async()
        slots = []     # (rows_idx, offset into the concat) per slot
        off = 0
        for (cls, r), rows in zip(plan, mapping):
            slots.append((rows, off, r))
            off += r
        buckets = [(allres, slots)]
        # spill slots: rare (every class is provisioned for 1.4x the
        # batch's TOTAL expected chunks), so they pay their own upload +
        # dispatch + fetch rather than perturbing the fixed fast path
        for cls, r, rows in spills:
            sb = np.zeros(2 * r, dtype=np.int32)
            sb[: len(rows)] = flat_starts[rows]
            sb[r: r + len(rows)] = flat_sizes[rows]
            res = make_stage3_fn(((cls, r),), self.hash_kind, self.impls)(
                words2d, jax.device_put(sb, self.device))
            for x in res:
                x.copy_to_host_async()
            buckets.append((res, rows))
        return buckets

    def submit_compress(self, entry, block_bytes: int = 8 << 20,
                        max_offset_words: int = 16383):
        """Stage 4: anchor extraction for the batch (requires
        plan_hash(keep_words=True)).  With compress=True the stage-1
        scan already emitted the per-bin gram-hash argmins in the same
        byte pass, so only the small bin-level sorts run here; otherwise
        the fast-tier scan re-reads the resident word rows.  Returns the
        single-fetch packed result — collect with collect_compress()."""
        from longtail_jax.parallel.device_match import (
            make_bins_anchor_packed_fn,
            make_fast_anchor_packed_fn,
        )

        bins = entry[5]
        if bins is not None:
            n_bins = int(np.prod(bins.shape))
            fn = make_bins_anchor_packed_fn(
                n_bins, block_bytes // 256,
                max_offset_words=max_offset_words)
            packed = fn(bins)
        else:
            words2d = entry[4]
            n_words = int(np.prod(words2d.shape))
            fn = make_fast_anchor_packed_fn(
                n_words, block_bytes // 4,
                max_offset_words=max_offset_words)
            packed = fn(words2d)   # (B, 2*cap + 1): pos | ref | count
        packed.copy_to_host_async()
        return packed

    @staticmethod
    def collect_compress(handle):
        """Sync stage-4 results (ONE device fetch): per-block
        position-sorted byte-offset (pos, ref) anchor lists, ready for
        ops/lz4.assemble_anchors (or the zstd sequence encoder)."""
        arr = np.asarray(handle)
        cap = (arr.shape[1] - 1) // 2
        out = []
        for b in range(arr.shape[0]):
            c = int(arr[b, -1])
            out.append((arr[b, :c].astype(np.int64) * 4,
                        arr[b, cap:cap + c].astype(np.int64) * 4))
        return out

    def retire(self, entry):
        """Stage 3 drain: sync the bucket hash results and yield
        (tag, sizes u32, hashes u64) per part in submission order."""
        tags, lane_sizes, counts, buckets = entry[:4]
        total = int(counts.sum())
        hashes = np.empty(total, dtype=np.uint64)
        for res, meta in buckets:
            res = np.stack([np.asarray(x) for x in res])   # (2, rows)
            if isinstance(meta, list):
                # the fused dispatch: (lo, hi) over every slot + slot map
                for rows, off, r in meta:
                    lo = res[0, off:off + r].astype(np.uint64)
                    hi = res[1, off:off + r].astype(np.uint64)
                    hashes[rows] = (lo | (hi << np.uint64(32)))[: len(rows)]
            else:
                lo = res[0].astype(np.uint64)
                hi = res[1].astype(np.uint64)
                hashes[meta] = (lo | (hi << np.uint64(32)))[: len(meta)]
        off = 0
        for tag, sz, cnt in zip(tags, lane_sizes, counts):
            yield tag, sz, hashes[off: off + int(cnt)]
            off += int(cnt)

    # -- streaming driver -------------------------------------------------

    def index_stream(self, tagged_parts: Iterable[Tuple[object, np.ndarray]],
                     prefetch_depth: int | None = None,
                     ) -> Iterator[Tuple[object, np.ndarray, np.ndarray]]:
        """Consume (tag, part_bytes) pairs; yield (tag, sizes u32, hashes u64)
        per part in submission order. Parts must be <= part_bytes long."""
        B = self.lanes
        depth = prefetch_depth if prefetch_depth is not None else 2 * B
        src = _prefetch(tagged_parts, depth) if depth else iter(tagged_parts)

        stage1: deque = deque()
        stage2: deque = deque()
        batch: list = []
        d = self.queue_depth
        for item in src:
            batch.append(item)
            if len(batch) == B:
                stage1.append(self.submit_host(batch))
                batch = []
                if len(stage1) >= d:
                    stage2.append(self.plan_hash(stage1.popleft()))
                if len(stage2) >= d:
                    yield from self.retire(stage2.popleft())
        if batch:
            stage1.append(self.submit_host(batch))
        while stage1:
            stage2.append(self.plan_hash(stage1.popleft()))
        while stage2:
            yield from self.retire(stage2.popleft())


class MeshPartIndexer:
    """The device data plane on a device mesh: one device-pinned
    DevicePartIndexer per mesh device, batches dealt round-robin, results
    retired in global submission order.

    This runs the SAME stage-1 and stage-3 programs as the single-device
    path on every device (SURVEY §2.5: one hot loop for every
    configuration, src/longtail.c:2429-2462).  Each device's pipeline
    overlaps independently; a
    single-device mesh therefore matches the non-mesh pipeline's
    throughput by construction.  Global dedup stays a host-side
    concatenate+unique in the single-controller driver (the all-gather
    collective in parallel/distributed.py covers the multi-process
    case)."""

    def __init__(self, target_chunk_size: int, devices,
                 batch_bytes_per_dev: int = 64 << 20,
                 lanes: int | None = None, prewarm: bool = False,
                 hash_kind: str = "blake3"):
        self.indexers = [
            DevicePartIndexer(target_chunk_size,
                              batch_bytes=batch_bytes_per_dev,
                              lanes=lanes, hash_kind=hash_kind,
                              device=d)
            for d in devices
        ]
        if prewarm:
            # each device compiles its own executables: warm them all at
            # once
            import concurrent.futures as cf

            with cf.ThreadPoolExecutor(len(self.indexers)) as ex:
                list(ex.map(lambda ix: ix.prewarm(), self.indexers))
        self.part_bytes = self.indexers[0].part_bytes
        self.cfg = self.indexers[0].cfg

    def index_stream(self, tagged_parts, prefetch_depth: int | None = None):
        """Same contract as DevicePartIndexer.index_stream, fanned out
        over every mesh device."""
        n = len(self.indexers)
        B = self.indexers[0].lanes
        depth = prefetch_depth if prefetch_depth is not None else 2 * B * n
        src = _prefetch(tagged_parts, depth) if depth else iter(tagged_parts)

        stage1: deque = deque()   # (device_idx, entry), FIFO = global order
        stage2: deque = deque()
        batch: list = []
        bi = 0
        d = self.indexers[0].queue_depth * n
        for item in src:
            batch.append(item)
            if len(batch) == B:
                i = bi % n
                stage1.append((i, self.indexers[i].submit_host(batch)))
                bi += 1
                batch = []
                if len(stage1) >= d:
                    i, e = stage1.popleft()
                    stage2.append((i, self.indexers[i].plan_hash(e)))
                if len(stage2) >= d:
                    i, e = stage2.popleft()
                    yield from self.indexers[i].retire(e)
        if batch:
            i = bi % n
            stage1.append((i, self.indexers[i].submit_host(batch)))
        while stage1:
            i, e = stage1.popleft()
            stage2.append((i, self.indexers[i].plan_hash(e)))
        while stage2:
            i, e = stage2.popleft()
            yield from self.indexers[i].retire(e)
