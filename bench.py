#!/usr/bin/env python
"""Benchmark harness: prints ONE JSON line to stdout.

Measures the device data plane on the card — content-defined chunking
(candidate scan + cut walk) plus per-chunk BLAKE3-64 hashing, optionally
with the device block-codec anchor scan — as pipeline throughput in GB/s
over a synthetic structured workload, via
longtail_jax.parallel.pipeline.DevicePartIndexer; other modes measure the
device LZ4 and entropy stages alone and the host paths end to end.

This is the re-design of the reference's chunking hot loop (one Bikeshed
thread job per file part, ``ChunkAssets`` src/longtail.c:2429-2462 +
``DynamicChunking`` :1989-2311).  Every result names the device it ran on
(platform, device kind, count, card name and power limit); the run fails
without a GPU.

Human-readable progress goes to stderr; stdout carries only the JSON line.

Usage: python bench.py [--gib N] [--mode chunk_hash|compress|stages|...]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def device_info() -> dict:
    """The device every number of this run comes from; exits without a
    GPU rather than measuring the CPU under a device metric's name."""
    import jax

    from longtail_jax.utils import compile_cache

    compile_cache.enable()
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"bench.py measures the card: JAX's platform is "
                 f"{devs[0].platform!r}, not 'gpu'")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    name, limit = (x.strip() for x in card.rsplit(",", 1))
    log(f"device: {devs[0].platform} / {devs[0].device_kind} x {len(devs)}"
        f" ({card})")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "card": name, "power_limit": limit}


def make_corpus(total_bytes: int, seed: int = 7) -> np.ndarray:
    """Synthetic structured corpus (longtail_jax/utils/corpus.py): 64 MiB
    structured segments, every 8th a duplicate of an earlier one."""
    from longtail_jax.utils.corpus import segments

    seg = 64 << 20
    n_seg = -(-total_bytes // seg)
    return np.concatenate(list(segments(n_seg, seed, seg)))[:total_bytes]


def bench_data_plane(total_bytes: int, target_chunk_size: int,
                     with_compress: bool, verify: bool = True,
                     batch_mib: int = 256) -> dict:
    """Device data-plane throughput over one device-resident structured
    part batch, submitted again per iteration: chunk (CDC scan + walk) +
    BLAKE3 hash, and optionally + the device block-codec anchor scan with
    host LZ4 assembly (the full chunk+hash+compress metric of
    BASELINE.md).  File reading and the host->device copy are not in this
    number (the downsync and real modes run the whole path).  Host
    planning, all result fetches, and (with_compress) the host-side LZ4
    stream assembly against the batch's host copy are included.

    verify=True pins correctness on the record: one deterministic batch's
    chunk sizes AND hashes are compared against the host oracle (native
    CDC + BLAKE3), and assembled blocks are decompressed and compared to
    the mirror bit-for-bit.  A wrong cut, hash, or match fails the bench.
    """
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    import jax
    import jax.numpy as jnp

    from longtail_jax.ops import lz4
    from longtail_jax.parallel.pipeline import DevicePartIndexer

    from longtail_jax.utils.corpus import segments

    t0 = time.perf_counter()
    indexer = DevicePartIndexer(target_chunk_size, prewarm=True,
                                compress=with_compress,
                                batch_bytes=batch_mib << 20)
    log(f"prewarm (concurrent compile of all programs): "
        f"{time.perf_counter() - t0:.1f}s")
    B, P = indexer.lanes, indexer.part_bytes
    batch_bytes = B * P
    block_bytes = 8 << 20
    blocks_per_batch = batch_bytes // block_bytes
    n_batches = max(1, -(-total_bytes // batch_bytes))
    log(f"workload: {n_batches} batches x {batch_bytes >> 20} MiB "
        f"({B} lanes x {P >> 20} MiB parts), structured corpus")

    t0 = time.perf_counter()
    mirror = next(segments(1, 7, batch_bytes)).reshape(-1, 128)
    batch_dev = jax.device_put(mirror)
    mirror_flat = mirror.reshape(-1)
    mirror_blocks = [
        mirror_flat[b * block_bytes:(b + 1) * block_bytes].tobytes()
        for b in range(blocks_per_batch)]
    log(f"corpus batch: {time.perf_counter() - t0:.1f}s")
    lengths = np.full((B,), P, dtype=np.int32)

    if with_compress:
        # warm the anchor-fn compile before timing
        e = indexer.plan_hash(indexer.submit(
            [None] * B, batch_dev, lengths), keep_words=True)
        jax.block_until_ready(indexer.submit_compress(e))

    asm_pool = ThreadPoolExecutor(max_workers=2)

    def run(n: int, compress: bool):
        stage1: deque = deque()
        stage2: deque = deque()
        asm_futures = []
        n_chunks = n_bytes = 0

        asm_buf = threading.local()

        def assemble(anchors):
            # per-thread reusable dst: the into-variant skips the memset
            # + copy-out of the bytes API (~3x assembly throughput)
            dst = getattr(asm_buf, "dst", None)
            if dst is None:
                dst = asm_buf.dst = np.empty(
                    lz4.compress_bound(block_bytes), np.uint8)
            total = 0
            for b, (apos, aref) in enumerate(anchors[:blocks_per_batch]):
                r = lz4.assemble_anchors_into(
                    mirror_blocks[b], apos, aref, dst)
                # store-raw-when-bigger, as the reference's
                # compressblockstore does (longtail_compressblockstore.c:86)
                total += min(r, block_bytes)
            return total

        def drain(item):
            nonlocal n_chunks, n_bytes
            entry, ch = item
            for _, sizes, hashes in indexer.retire(entry):
                n_chunks += len(hashes)
                n_bytes += int(np.asarray(sizes, dtype=np.int64).sum())
            if ch is not None:
                anchors = indexer.collect_compress(ch)
                asm_futures.append(asm_pool.submit(assemble, anchors))

        d = indexer.queue_depth
        for i in range(n):
            stage1.append(indexer.submit([None] * B, batch_dev, lengths))
            if len(stage1) >= d:
                e = indexer.plan_hash(stage1.popleft(),
                                      keep_words=compress)
                ch = indexer.submit_compress(e) if compress else None
                stage2.append((e, ch))
            if len(stage2) >= d:
                drain(stage2.popleft())
        while stage1:
            e = indexer.plan_hash(stage1.popleft(), keep_words=compress)
            ch = indexer.submit_compress(e) if compress else None
            stage2.append((e, ch))
        while stage2:
            drain(stage2.popleft())
        comp_bytes = sum(f.result() for f in asm_futures)
        return n_chunks, n_bytes, comp_bytes

    t0 = time.perf_counter()
    n_chunks, _, _ = run(2, with_compress)          # every shape compiled
    log(f"warmup: {time.perf_counter() - t0:.1f}s ({n_chunks} chunks)")

    result = {}
    if with_compress:
        t0 = time.perf_counter()
        n_chunks, n_bytes, comp = run(n_batches, True)
        dt = time.perf_counter() - t0
        assert n_bytes == n_batches * batch_bytes, (n_bytes, n_batches)
        gbps = n_bytes / dt / 1e9
        ratio = n_bytes / max(comp, 1)
        log(f"chunk+hash+compress: {dt:.2f}s  {gbps:.3f} GB/s  "
            f"{n_chunks} chunks  ratio {ratio:.2f}x")
        result.update({
            "metric": "chunk_hash_compress_throughput",
            "value": round(gbps, 3),
            "unit": "GB/s",
            "compress_ratio": round(ratio, 2),
        })
        # context sub-metric: chunk+hash alone on a shorter run
        sub = min(n_batches, 16)
        t0 = time.perf_counter()
        _, nb, _ = run(sub, False)
        result["chunk_hash_gbps"] = round(nb / (time.perf_counter() - t0)
                                          / 1e9, 3)
        log(f"chunk+hash only (context): {result['chunk_hash_gbps']} GB/s")
        # context: the DEFAULT codec's device-assisted path (zstd via
        # anchor scan + ZSTD_compressSequences) vs host level 3, one block
        from longtail_jax.ops import zstd as _z
        from longtail_jax.ops import zstd_device
        if zstd_device._zstd_api() is not None:
            zt = h3 = raw = 0
            for blk in mirror_blocks:
                zout = zstd_device.compress_block(blk)
                assert _z.decompress(zout, len(blk)) == blk
                zt += len(zout)
                h3 += len(_z.compress(blk, 3))
                raw += len(blk)
            result["zstd_device_ratio"] = round(raw / zt, 2)
            result["zstd_level3_ratio"] = round(raw / h3, 2)
            log(f"zstd device-assisted (context, full batch): ratio "
                f"{result['zstd_device_ratio']}x vs host level3 "
                f"{result['zstd_level3_ratio']}x (decode verified)")
    else:
        t0 = time.perf_counter()
        n_chunks, n_bytes, _ = run(n_batches, False)
        dt = time.perf_counter() - t0
        assert n_bytes == n_batches * batch_bytes, (n_bytes, n_batches)
        gbps = n_bytes / dt / 1e9
        log(f"chunk+hash: {dt:.2f}s  {gbps:.3f} GB/s  {n_chunks} chunks")
        result.update({
            "metric": "chunk_hash_throughput",
            "value": round(gbps, 3),
            "unit": "GB/s",
        })

    if verify:
        result["verified"] = verify_data_plane(
            indexer, batch_dev, lengths, mirror, mirror_blocks,
            target_chunk_size, with_compress)
    asm_pool.shutdown()
    return result


def verify_data_plane(indexer, batch_dev, lengths, mirror, mirror_blocks,
                      target_chunk_size: int, with_compress: bool) -> bool:
    """Bit-exactness on the record: device chunk sizes + hashes vs the
    host oracle (native CDC + BLAKE3), and device-anchored LZ4 blocks
    decode back to the mirror.  Raises on any mismatch."""
    from longtail_jax.formats.constants import chunker_params_from_target
    from longtail_jax.ops import blake3, cdc, lz4

    mn, av, mx = chunker_params_from_target(target_chunk_size)
    B, P = indexer.lanes, indexer.part_bytes
    entry = indexer.plan_hash(
        indexer.submit([None] * B, batch_dev, lengths),
        keep_words=with_compress)
    ch = indexer.submit_compress(entry) if with_compress else None
    flat = mirror.reshape(-1)
    t0 = time.perf_counter()
    for lane, (_, sizes, hashes) in enumerate(indexer.retire(entry)):
        data = flat[lane * P: lane * P + int(lengths[lane])]
        ref_ends = cdc.chunk_part(data, mn, av, mx)
        ref_sizes = np.diff(np.concatenate([[0], ref_ends]))
        assert np.array_equal(sizes.astype(np.int64), ref_sizes), \
            f"lane {lane}: chunk sizes diverge from host oracle"
        starts = np.concatenate([[0], ref_ends[:-1]]).astype(np.int64)
        ref_hashes = blake3.hash64_ranges(
            data, starts, ref_sizes.astype(np.int64))
        assert np.array_equal(hashes, ref_hashes), \
            f"lane {lane}: chunk hashes diverge from host oracle"
    log(f"verify: {B} lanes chunk+hash bit-exact vs host oracle "
        f"({time.perf_counter() - t0:.1f}s)")
    if ch is not None:
        anchors = indexer.collect_compress(ch)
        for b in range(min(len(mirror_blocks), len(anchors))):
            apos, aref = anchors[b]
            out = lz4.assemble_anchors(mirror_blocks[b], apos, aref)
            assert lz4.decompress(out, len(mirror_blocks[b])) == \
                mirror_blocks[b], f"block {b}: lz4 roundtrip mismatch"
        log(f"verify: {len(anchors)} device-anchored LZ4 blocks decode "
            "bit-exact")
    return True


def bench_mesh_chunk_hash(total_bytes: int, target_chunk_size: int) -> dict:
    """The mesh data plane on the available devices: the same resident
    batch loop as the main bench, but dealt round-robin over
    MeshPartIndexer's device-pinned pipelines."""
    from collections import deque

    import jax

    from longtail_jax.parallel.pipeline import MeshPartIndexer
    from longtail_jax.utils.corpus import segments

    devices = jax.devices()
    mesh_ix = MeshPartIndexer(target_chunk_size, devices, prewarm=True,
                              batch_bytes_per_dev=256 << 20)
    n = len(devices)
    B, P = mesh_ix.indexers[0].lanes, mesh_ix.part_bytes
    batch_bytes = B * P
    n_batches = max(2 * n, -(-total_bytes // batch_bytes))
    batch0 = next(segments(1, 7, batch_bytes)).reshape(-1, 128)
    per_dev = [jax.device_put(batch0, d) for d in devices]
    lengths = np.full((B,), P, dtype=np.int32)

    def run(nb):
        stage1: deque = deque()
        stage2: deque = deque()
        n_bytes = 0
        d = mesh_ix.indexers[0].queue_depth * n
        for i in range(nb):
            k = i % n
            stage1.append((k, mesh_ix.indexers[k].submit(
                [None] * B, per_dev[k], lengths)))
            if len(stage1) >= d:
                k, e = stage1.popleft()
                stage2.append((k, mesh_ix.indexers[k].plan_hash(e)))
            if len(stage2) >= d:
                k, e = stage2.popleft()
                for _, sizes, _ in mesh_ix.indexers[k].retire(e):
                    n_bytes += int(np.asarray(sizes, np.int64).sum())
        while stage1:
            k, e = stage1.popleft()
            stage2.append((k, mesh_ix.indexers[k].plan_hash(e)))
        while stage2:
            k, e = stage2.popleft()
            for _, sizes, _ in mesh_ix.indexers[k].retire(e):
                n_bytes += int(np.asarray(sizes, np.int64).sum())
        return n_bytes

    run(2 * n)                      # every shape compiled on every device
    t0 = time.perf_counter()
    n_bytes = run(n_batches)
    dt = time.perf_counter() - t0
    gbps = n_bytes / dt / 1e9
    log(f"mesh[{n} dev] chunk+hash: {dt:.2f}s {gbps:.3f} GB/s")
    return {
        "metric": "mesh_chunk_hash_throughput",
        "value": round(gbps, 3),
        "unit": "GB/s",
        "n_devices": n,
    }


def bench_device_compress(total_bytes: int) -> dict:
    """Device LZ4 codec alone: batched fast-tier anchor scan
    (parallel/device_match.py) + native host assembly, over a
    device-resident 64 MiB word batch (the host->device copy excluded).
    Reports device-scan GB/s, host-assembly GB/s/core, ratio vs the host
    greedy encoder."""
    import jax
    import jax.numpy as jnp

    from longtail_jax.ops import lz4
    from longtail_jax.parallel.device_match import (
        fast_block_anchors,
        make_fast_anchor_fn,
    )

    batch = 64 << 20
    block = 8 << 20
    total_bytes = max(batch, (total_bytes // batch) * batch)
    n_batches = total_bytes // batch
    rng = np.random.default_rng(11)
    text = (b"the quick brown fox jumps over the lazy dog; "
            b"pack my box with five dozen liquor jugs. ") * 12000
    tile = rng.integers(0, 256, 24 << 10, np.uint8).tobytes() * 40
    noise = rng.integers(0, 256, 1 << 20, np.uint8).tobytes()
    unit = text + bytes(1 << 19) + tile + noise
    corpus = (unit * (batch // len(unit) + 1))[:batch]
    w = jax.device_put(np.frombuffer(corpus, "<u4").copy())
    fn = make_fast_anchor_fn(batch // 4, block // 4)
    jax.block_until_ready(fn(w))
    log(f"device-lz4 workload: {n_batches} x 64 MiB batches")

    # device scan alone: one dispatch per batch (async), counts fetched
    # per handle
    sum_counts = jax.jit(lambda c: jnp.sum(c))
    _ = np.asarray(sum_counts(fn(w)[2]))
    t0 = time.perf_counter()
    handles = [sum_counts(fn(w)[2]) for _ in range(n_batches)]
    _ = [np.asarray(h) for h in handles]
    scan_dt = time.perf_counter() - t0
    scan_gbps = n_batches * batch / scan_dt / 1e9

    # assembly + ratio on one batch
    anchors = fast_block_anchors(w, block // 4)
    srcs = [corpus[b * block:(b + 1) * block]
            for b in range(batch // block)]
    _ = lz4.assemble_anchors(srcs[0], *anchors[0])
    t0 = time.perf_counter()
    comp = 0
    for src, (apos, aref) in zip(srcs, anchors):
        comp += len(lz4.assemble_anchors(src, apos, aref))
    asm_gbps = batch / (time.perf_counter() - t0) / 1e9
    for src, (apos, aref) in zip(srcs, anchors):
        out = lz4.assemble_anchors(src, apos, aref)
        assert lz4.decompress(out, len(src)) == src
    host_comp = sum(len(lz4.compress(s)) for s in srcs)
    log(f"device lz4 scan: {scan_gbps:.2f} GB/s; assembly "
        f"{asm_gbps:.2f} GB/s/core; ratio {batch / comp:.2f}x "
        f"(host greedy {batch / host_comp:.2f}x); decode verified")
    return {
        "metric": "device_lz4_scan_throughput",
        "value": round(scan_gbps, 3),
        "unit": "GB/s",
        "compress_ratio": round(batch / comp, 2),
        "host_greedy_ratio": round(batch / host_comp, 2),
        "assembly_gbps_per_core": round(asm_gbps, 3),
    }


def bench_device_decode(total_bytes: int) -> dict:
    """The decode-side experiment: batched LZ4 decode on the device
    (parse + interval expansion + pointer-jump gathers,
    parallel/device_decode.py) vs the host scalar decoder, bit-exact
    both ways.  Decode is random-access bound; this mode decides whether
    downsync should decode on the device (it decodes on the host)."""
    from longtail_jax.ops import lz4
    from longtail_jax.parallel.device_decode import decode_block_device

    block = 4 << 20
    n_blocks = max(4, min(16, total_bytes // block))
    rng = np.random.default_rng(5)
    tile = rng.integers(0, 256, 24 << 10, np.uint8).tobytes()
    text = (b"the quick brown fox jumps over the lazy dog; "
            b"pack my box with five dozen liquor jugs. ") * 6000
    blocks = []
    for i in range(n_blocks):
        noise = rng.integers(0, 256, block // 4, np.uint8).tobytes()
        raw = ((text + bytes(1 << 18) + tile * 20 + noise)
               * 4)[:block]
        blocks.append((raw, lz4.compress(raw)))
    log(f"device-decode workload: {n_blocks} x {block >> 20} MiB blocks "
        f"(ratio {sum(len(r) for r, _ in blocks) / sum(len(c) for _, c in blocks):.2f}x)")

    # warm compiles + verify bit-exactness on every block
    for raw, comp in blocks[:2]:
        assert decode_block_device(comp, len(raw)) == raw

    t0 = time.perf_counter()
    for raw, comp in blocks:
        out = decode_block_device(comp, len(raw))
        assert len(out) == len(raw)
    dev_dt = time.perf_counter() - t0
    dev_gbps = n_blocks * block / dev_dt / 1e9

    t0 = time.perf_counter()
    dst = np.empty(block, np.uint8)
    for raw, comp in blocks:
        lz4.decompress_into(comp, dst)
    host_dt = time.perf_counter() - t0
    host_gbps = n_blocks * block / host_dt / 1e9
    for raw, comp in blocks:
        assert decode_block_device(comp, len(raw)) == raw
    log(f"device decode: {dev_gbps:.3f} GB/s; host decode: "
        f"{host_gbps:.3f} GB/s/core (both bit-exact)")
    return {
        "metric": "device_lz4_decode_throughput",
        "value": round(dev_gbps, 3),
        "unit": "GB/s",
        "host_decode_gbps_per_core": round(host_gbps, 3),
    }


def bench_device_entropy(total_bytes: int) -> dict:
    """The device Huffman entropy stage: device-packed zstd literal
    sections (ops/device_entropy.py, an XLA scatter-add) over text-like
    literal streams — pack throughput over a device-resident batch of
    streams, byte-identity with the host encoder, and the full
    device-zstd block (device anchors + device literals entropy +
    from-spec frame, no libzstd in the encode path) vs libzstd level 3."""
    import jax
    import jax.numpy as jnp

    from longtail_jax.ops import zstd as _z
    from longtail_jax.ops import zstd_device, zstd_frame
    from longtail_jax.ops.device_entropy import (
        encode_literals_device,
        make_hufpack_fn,
    )

    rng = np.random.default_rng(13)
    text = (b"the quick brown fox jumps over the lazy dog; "
            b"pack my box with five dozen liquor jugs. " * 4000)
    skew = rng.choice(np.arange(256), size=1 << 20,
                      p=np.r_[np.full(16, 0.05),
                              np.full(240, 0.2 / 240)]).astype(np.uint8)
    sections = []
    seg = 128 << 10                     # one zstd block's literals
    stream = (text + skew.tobytes()) * 8
    n = max(seg, min(total_bytes, len(stream)))
    for off in range(0, n - seg + 1, seg):
        sections.append(stream[off:off + seg])

    # byte-identity on an exact-histogram size
    probe = sections[0][: 48 << 10]
    assert encode_literals_device(probe) == \
        zstd_frame._encode_literals(probe)

    # pack throughput: one dispatch packs a 128-stream device-resident
    # batch with one code table built from all of it; one tiny fetch
    # forces completion
    S, seg_pad = 128, 128 << 10
    big = (stream * (S * seg_pad // len(stream) + 1))[: S * seg_pad]
    lits_np = np.frombuffer(big, np.uint8).reshape(S, seg_pad)
    freqs = np.bincount(lits_np.reshape(-1), minlength=256)
    _, code_val, code_len = zstd_frame.build_huffman(freqs.tolist())
    fn = make_hufpack_fn(seg_pad, S)
    cv = jax.device_put(np.asarray(code_val + [0] * (256 - len(code_val)),
                                   np.int32))
    cl = jax.device_put(np.asarray(code_len + [0] * (256 - len(code_len)),
                                   np.int32))
    lits = jax.device_put(lits_np)
    n_lit = jax.device_put(np.full((S,), seg_pad, np.int32))
    tot = jax.jit(lambda t: jnp.sum(t))
    _ = np.asarray(tot(fn(lits, n_lit, cv, cl)[1]))         # compile
    iters = 16
    t0 = time.perf_counter()
    acc = None
    for _ in range(iters):
        _, t = fn(lits, n_lit, cv, cl)
        acc = tot(t)
    _ = np.asarray(acc)
    dt = time.perf_counter() - t0
    gbps = iters * S * seg_pad / dt / 1e9
    comp = sum(len(encode_literals_device(s)) for s in sections)
    raw = sum(len(s) for s in sections)
    log(f"device literals entropy (resident batch): {gbps:.3f} GB/s; "
        f"section ratio {raw / comp:.2f}x")

    # full device-zstd block, no libzstd in the encode path
    block = stream[: 4 << 20]
    frame = zstd_device.compress_block(block)
    assert zstd_frame.decompress(frame, len(block)) == block
    result = {
        "metric": "device_entropy_throughput",
        "value": round(gbps, 3),
        "unit": "GB/s",
        "section_ratio": round(raw / comp, 2),
        "device_zstd_ratio": round(len(block) / len(frame), 2),
    }
    if _z._load_native() is not None:
        assert _z.decompress(frame, len(block)) == block
        result["zstd_level3_ratio"] = round(
            len(block) / len(_z.compress(block, 3)), 2)
        log(f"device-zstd frame (device anchors + entropy): ratio "
            f"{result['device_zstd_ratio']}x vs host L3 "
            f"{result['zstd_level3_ratio']}x (upstream-decode verified)")
    return result


def bench_stages(target_chunk_size: int) -> dict:
    """Hand kernel vs plain XLA for each device stage that has both — the
    cut walk (stage 1) and the pack + BLAKE3 (stage 3) — on one batch of
    two parts (64 MiB at the default target).  Each variant is compiled
    (compile seconds reported), checked bit-exact against the host
    chunker and hasher, and timed as the mean wall time of 10
    back-to-back calls after a warm-up call.  parallel/backend.py keeps
    the faster of each for the card."""
    import dataclasses

    import jax

    from longtail_jax.ops import blake3, cdc
    from longtail_jax.parallel import backend
    from longtail_jax.parallel.device_chunker import ChunkerConfig
    from longtail_jax.parallel.pipeline import (
        _pow2_padded,
        class_floor,
        class_plan,
        make_stage3_fn,
        pow2_cap,
    )
    from longtail_jax.parallel.stage1 import (
        Stage1Plan,
        _scan,
        _walk_triton,
        _walk_xla,
        make_stage1_fn,
        unpack_stage1,
    )

    cfg = ChunkerConfig.from_target(target_chunk_size)
    B, P = 2, target_chunk_size * 1024
    plan = Stage1Plan(cfg, B, P)
    flat = make_corpus(B * P)
    lengths = np.array([P, P - 12345], np.int32)
    flat[P + lengths[1]:] = 0
    rows_d = jax.device_put(flat.reshape(-1, 128))
    len_d = jax.device_put(lengths)
    slack = pow2_cap(cfg.padded_chunk) // 4 + 2048
    res: dict = {}

    def timed(name, f, *args):
        t = time.perf_counter()
        f.lower(*args).compile()
        res[f"{name}_compile_s"] = time.perf_counter() - t
        jax.block_until_ready(f(*args))
        t = time.perf_counter()
        for _ in range(10):
            out = f(*args)
        jax.block_until_ready(out)
        res[f"{name}_ms"] = (time.perf_counter() - t) / 10 * 1e3
        log(f"{name}: {res[f'{name}_ms']:.3f} ms, compile "
            f"{res[f'{name}_compile_s']:.2f} s")
        return out

    ref_sizes = []
    for b in range(B):
        ends = cdc.chunk_part(flat[b * P: b * P + lengths[b]], cfg.min_size,
                              cfg.avg_size, cfg.max_size)
        ref_sizes.append(np.diff(np.concatenate([[0], ends])))

    z = plan.z
    summ = timed("scan", jax.jit(lambda r, l: _scan(r.reshape(B, P), l, cfg,
                                                     z)), rows_d, len_d)
    walks = {
        "xla": lambda *a: _walk_xla(*a, cfg, z, plan.c_pad),
        "triton": lambda *a: _walk_triton(*a, cfg, z, plan.c_pad),
    }
    words2d = None
    for walk, body in walks.items():
        timed(f"walk_{walk}", jax.jit(body), *summ, len_d)
        impls = dataclasses.replace(backend.GPU, walk=walk)
        fn = make_stage1_fn(plan, impls, slack_words=slack)
        timed(f"stage1_{walk}", fn.program, rows_d, len_d)
        packed, _, words2d = fn(rows_d, len_d)
        sizes, n, amb = unpack_stage1(np.asarray(packed), plan)
        for b in range(B):
            if not amb[b] and not np.array_equal(sizes[b, :n[b]],
                                                 ref_sizes[b]):
                sys.exit(f"stage 1 ({walk} walk): lane {b} differs from "
                         "cdc.chunk_part")

    fs = np.concatenate(ref_sizes).astype(np.int64)
    st = np.concatenate([np.concatenate([[0], np.cumsum(r)[:-1]]) + b * P
                         for b, r in enumerate(ref_sizes)]).astype(np.int64)
    padded = _pow2_padded(fs, pow2_cap(cfg.padded_chunk), class_floor(cfg))
    layout = class_plan(cfg, B * P)
    blob, mapping = [], []
    for cls, r in layout:
        idx = np.flatnonzero(padded == cls)[:r]
        part = np.zeros(2 * r, np.int32)
        part[:len(idx)] = st[idx]
        part[r:r + len(idx)] = fs[idx]
        blob.append(part)
        mapping.append((idx, r))
    blob = jax.device_put(np.concatenate(blob))
    want = blake3.hash64_ranges(flat, st, fs)
    for h in ("xla", "triton"):
        impls = dataclasses.replace(backend.GPU, hash=h)
        lo, hi = (np.asarray(x) for x in timed(
            f"stage3_{h}", make_stage3_fn(layout, "blake3", impls),
            words2d, blob))
        got = lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))
        off = 0
        for idx, r in mapping:
            if not np.array_equal(got[off:off + len(idx)], want[idx]):
                sys.exit(f"stage 3 ({h}): hashes differ from "
                         "blake3.hash64_ranges")
            off += r
    log(f"every variant bit-exact ({len(fs)} chunks, layout {layout})")
    return {"metric": "stage_times", "unit": "ms", "chunks": len(fs),
            "batch_bytes": B * P, **res}


def bench_compress(total_bytes: int) -> dict:
    """Host block-codec throughput (compress+decompress verify), LZ4 path."""
    from longtail_jax.ops import lz4

    buf = make_corpus(total_bytes)
    block = 8 << 20
    t0 = time.perf_counter()
    comp = 0
    for off in range(0, len(buf), block):
        comp += len(lz4.compress(buf[off:off + block].tobytes()))
    dt = time.perf_counter() - t0
    gbps = total_bytes / dt / 1e9
    log(f"lz4 compress: {dt:.2f}s {gbps:.3f} GB/s ratio "
        f"{total_bytes / comp:.2f}x")
    return {
        "metric": "lz4_compress_throughput",
        "value": round(gbps, 3),
        "unit": "GB/s",
    }


def bench_real_data(total_bytes: int, path: str) -> dict:
    """Real on-disk data mode: chunk+dedup+compress an actual directory
    tree (default /usr) so ratio and dedup-rate claims rest on real
    content, not the constructed corpus.  Host data plane.  Reports
    end-to-end upsync GB/s, compress ratio, and chunk-level dedup
    rate."""
    import shutil
    import tempfile

    from longtail_jax import api
    from longtail_jax.formats import constants as C
    from longtail_jax.stores.compressblockstore import CompressBlockStore
    from longtail_jax.stores.fsblockstore import FSBlockStore
    from longtail_jax.stores.storage import FSStorage

    if not os.path.isdir(path):
        log(f"real-data path {path} absent; skipping")
        return {"metric": "real_data_upsync_throughput", "value": 0.0,
                "unit": "GB/s", "skipped": True}
    base = tempfile.mkdtemp(prefix="lt_real_")
    try:
        st = FSStorage()
        store = CompressBlockStore(
            FSBlockStore(st, os.path.join(base, "store")))
        t0 = time.perf_counter()
        vi, vsi = api.upsync(
            st, path.rstrip("/"), store,
            compression_tag=C.COMPRESSION_TYPE_ZSTD_DEFAULT, workers=8)
        dt = time.perf_counter() - t0
        raw = int(vi.asset_sizes.sum())
        stored = sum(
            os.path.getsize(os.path.join(r, f))
            for r, _, fs in os.walk(os.path.join(base, "store"))
            for f in fs)
        # version index chunk table is already unique; dedup rate =
        # referenced asset bytes over unique chunk bytes
        unique_chunk_bytes = int(
            np.asarray(vi.chunk_sizes, np.int64).sum())
        dedup = raw / max(unique_chunk_bytes, 1)
        gbps = raw / dt / 1e9
        log(f"real-data upsync [{path}]: {raw / 1e9:.2f} GB in {dt:.1f}s "
            f"= {gbps:.3f} GB/s; ratio {raw / max(stored, 1):.2f}x; "
            f"chunk dedup {dedup:.2f}x ({vi.asset_count} assets, "
            f"{vi.chunk_count} chunks)")
        return {
            "metric": "real_data_upsync_throughput",
            "value": round(gbps, 3),
            "unit": "GB/s",
            "compress_ratio": round(raw / max(stored, 1), 2),
            "chunk_dedup_ratio": round(dedup, 2),
            "raw_gb": round(raw / 1e9, 2),
            "path": path,
        }
    finally:
        shutil.rmtree(base, ignore_errors=True)


def bench_downsync(total_bytes: int) -> dict:
    """End-to-end cold downsync (the reference's headline unpack benchmark,
    CHANGELOG.md:51-78): upsync a synthetic tree into a zstd fs store, then
    reconstruct it through the CLI in a subprocess — wall-clock GB/s plus
    the child's peak RSS (the 0.4.1 memory story)."""
    import shutil
    import subprocess
    import tempfile

    from longtail_jax import api
    from longtail_jax.formats import constants as C
    from longtail_jax.stores.compressblockstore import CompressBlockStore
    from longtail_jax.stores.fsblockstore import FSBlockStore
    from longtail_jax.stores.storage import FSStorage

    base = tempfile.mkdtemp(prefix="lt_bench_")
    try:
        src = os.path.join(base, "src")
        os.makedirs(src)
        corpus = make_corpus(total_bytes)
        file_bytes = 64 << 20
        for i in range(0, len(corpus), file_bytes):
            with open(os.path.join(src, f"f{i // file_bytes:04d}.bin"),
                      "wb") as f:
                f.write(corpus[i:i + file_bytes].tobytes())
        del corpus
        st = FSStorage()
        store = CompressBlockStore(
            FSBlockStore(st, os.path.join(base, "store")))
        t0 = time.perf_counter()
        vi, _ = api.upsync(
            st, src, store,
            compression_tag=C.COMPRESSION_TYPE_ZSTD_DEFAULT, workers=8)
        up_dt = time.perf_counter() - t0
        lvi = os.path.join(base, "v.lvi")
        with open(lvi, "wb") as f:
            f.write(vi.to_bytes())
        stored = sum(
            os.path.getsize(os.path.join(r, f))
            for r, _, fs in os.walk(os.path.join(base, "store")) for f in fs)
        log(f"upsync: {up_dt:.2f}s {total_bytes / up_dt / 1e9:.3f} GB/s "
            f"ratio {total_bytes / stored:.2f}x")

        out = os.path.join(base, "out")
        t0 = time.perf_counter()
        child = subprocess.Popen(
            [sys.executable, "-m", "longtail_jax.cli", "--workers", "8",
             "downsync",
             "--storage-uri", os.path.join(base, "store"),
             "--source-path", lvi, "--target-path", out],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        # sample /proc: getrusage(RUSAGE_CHILDREN).ru_maxrss counts the
        # brief fork window where the child still shares this process's
        # (corpus-sized) pages, wildly overstating the child's real peak
        rss_kb = 0
        while child.poll() is None:
            try:
                with open(f"/proc/{child.pid}/status") as f:
                    for ln in f:
                        if ln.startswith("VmRSS"):
                            rss_kb = max(rss_kb, int(ln.split()[1]))
            except FileNotFoundError:
                break   # pid vanished between poll() and open()
            time.sleep(0.05)
        child.wait()    # reap + ensure returncode is set after the break
        if child.returncode != 0:
            raise RuntimeError(f"downsync failed: {child.returncode}")
        dt = time.perf_counter() - t0
        gbps = total_bytes / dt / 1e9
        log(f"downsync: {dt:.2f}s {gbps:.3f} GB/s  peak RSS "
            f"{rss_kb / 1048576:.2f} GiB")
        # verify a sample file round-tripped
        sample = sorted(os.listdir(src))[0]
        with open(os.path.join(src, sample), "rb") as a, \
                open(os.path.join(out, sample), "rb") as b:
            assert a.read() == b.read(), "reconstruction mismatch"
        return {
            "metric": "downsync_throughput",
            "value": round(gbps, 3),
            "unit": "GB/s",
            "peak_rss_gib": round(rss_kb / 1048576, 3),
            "upsync_gbps": round(total_bytes / up_dt / 1e9, 3),
            "compress_ratio": round(total_bytes / stored, 2),
        }
    finally:
        shutil.rmtree(base, ignore_errors=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gib", type=float, default=4.0,
                    help="workload size in GiB")
    ap.add_argument("--mode", default="chunk_hash_compress",
                    choices=["chunk_hash_compress", "chunk_hash",
                             "mesh_chunk_hash", "compress",
                             "device_compress", "device_decode",
                             "device_entropy", "downsync", "real",
                             "stages"])
    ap.add_argument("--path", default="/usr",
                    help="directory tree for --mode real")
    ap.add_argument("--target-chunk-size", type=int, default=32768)
    ap.add_argument("--batch-mib", type=int, default=256)
    ap.add_argument("--no-verify", action="store_true",
                    help="skip the bit-exactness verification phase")
    args = ap.parse_args()

    device = device_info()
    total = int(args.gib * 2**30)
    if args.mode == "chunk_hash_compress":
        result = bench_data_plane(total, args.target_chunk_size,
                                  with_compress=True,
                                  verify=not args.no_verify,
                                  batch_mib=args.batch_mib)
    elif args.mode == "chunk_hash":
        result = bench_data_plane(total, args.target_chunk_size,
                                  with_compress=False,
                                  verify=not args.no_verify,
                                  batch_mib=args.batch_mib)
    elif args.mode == "mesh_chunk_hash":
        result = bench_mesh_chunk_hash(total, args.target_chunk_size)
    elif args.mode == "downsync":
        result = bench_downsync(total)
    elif args.mode == "device_compress":
        result = bench_device_compress(total)
    elif args.mode == "device_decode":
        result = bench_device_decode(total)
    elif args.mode == "device_entropy":
        result = bench_device_entropy(total)
    elif args.mode == "real":
        result = bench_real_data(total, args.path)
    elif args.mode == "stages":
        result = bench_stages(args.target_chunk_size)
    else:
        result = bench_compress(total)
    result["device"] = device
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
