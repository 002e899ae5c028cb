#!/usr/bin/env python
"""End-to-end proof that the device data plane runs on an NVIDIA card.

    python chip_smoke.py               # one card: phases (a)-(d) below
    python chip_smoke.py --four-cards  # four cards: the mesh path only
    python chip_smoke.py --rehearse    # every phase tiny, on the CPU,
                                       # Pallas kernels in interpret mode

Phases (one card):
  (a) card and build: the card's name and power limit, JAX's platform,
      device kind and count (the platform must be ``gpu``); every native
      C library built from the sources on this host, or a failure;
  (d) the ``gpu``-marked tests, in a child process that has the card to
      itself (run first, before this process opens the card);
  (b) a seeded >= 2 GiB build tree (big files plus ~2,000 small files in
      nested dirs) upsynced through ``longtail_jax.cli.main`` at CLI
      defaults, once on the host and once with ``--device``: the two
      ``.lvi`` files must be byte-identical, and a downsync from the
      ``--device`` store must rebuild the tree bit for bit;
  (c) each device stage against its plain reference at production widths
      (64 MiB batches, 32 MiB parts): stage-1 chunk sizes, stage-3
      hashes, the Huffman literal pack, the device LZ4 round trip, plus
      ``memory_analysis()`` of the stage-1 and stage-3 programs.

``--four-cards`` runs only ``api.upsync`` over a 4-device mesh against the
single-device run's ``.lvi`` byte for byte, and the sharded chunk + dedup
collective (``distributed.make_sharded_chunk_fn``) against the host.

Any failed phase exits non-zero.  The last line of standard output is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(phase: str, msg: str) -> None:
    print(f"chip_smoke: phase {phase} FAILED: {msg}", file=sys.stderr,
          flush=True)
    sys.exit(1)


class Sizes:
    """Corpus and check widths: the real ones, or tiny for --rehearse."""

    def __init__(self, rehearse: bool):
        MiB = 1 << 20
        if rehearse:
            self.big_files = [3 * MiB + 77, 5 * MiB]
            self.mesh_big_files = self.big_files
            self.n_small, self.small_max = 40, 96 << 10
            self.seg = 1 * MiB
            self.target, self.parts_per_batch = 1024, 8
            self.min_total = 0
        else:
            self.big_files = [256 * MiB, 256 * MiB + 4097, 320 * MiB,
                              384 * MiB, 512 * MiB, 768 * MiB + 1]
            # 18 parts of 32 MiB: every card of the mesh takes batches
            self.mesh_big_files = [160 * MiB, 128 * MiB + 1, 160 * MiB,
                                   128 * MiB]
            self.n_small, self.small_max = 2000, 512 << 10
            self.seg = 64 * MiB
            self.target, self.parts_per_batch = 32768, 2
            self.min_total = 2 << 30
        self.small_min = 4 << 10


# -- (a) card and build ------------------------------------------------------

def card_line(rehearse: bool) -> str:
    if rehearse:
        return "card: none (rehearsal on the CPU)"
    smi = shutil.which("nvidia-smi")
    if smi is None:
        fail("a", "nvidia-smi not found: no NVIDIA card on this host")
    r = subprocess.run([smi, "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True)
    if r.returncode != 0 or not r.stdout.strip():
        fail("a", f"nvidia-smi found no card: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def check_platform(rehearse: bool, count: int):
    import jax

    from longtail_jax.utils import compile_cache

    compile_cache.enable()
    devs = jax.devices()
    d = devs[0]
    log(f"jax: platform={d.platform} kind={d.device_kind} "
        f"count={len(devs)}")
    want = "cpu" if rehearse else "gpu"
    if d.platform != want:
        fail("a", f"JAX's platform is {d.platform!r}, not {want!r}")
    if len(devs) < count:
        fail("a", f"{count} devices needed, JAX has {len(devs)}")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}


def build_native() -> None:
    from longtail_jax import native

    t = time.perf_counter()
    missing = [n for n in native.LIBRARIES if native.load(n) is None]
    if missing:
        fail("a", f"native libraries did not build or load: {missing}")
    log(f"native: {len(native.LIBRARIES)} libraries built and loaded "
        f"({time.perf_counter() - t:.1f}s)")


# -- (d) card-only tests -----------------------------------------------------

def card_tests(rehearse: bool) -> None:
    env = dict(os.environ, PYTHONPATH=ROOT)
    if not rehearse:
        env["LT_TESTS_GPU"] = "1"
    t = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-m", "gpu", "-q", "-rs",
         "-p", "no:cacheprovider", os.path.join(ROOT, "tests")],
        cwd=ROOT, env=env, capture_output=True, text=True)
    tail = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    log(f"gpu tests: {tail} ({time.perf_counter() - t:.1f}s)")
    if r.returncode != 0 or (not rehearse and "skipped" in tail):
        fail("d", r.stdout[-4000:] + r.stderr[-2000:])


# -- (b) upsync on host and device, downsync ---------------------------------

def write_corpus(src: str, sz: Sizes, seed: int) -> int:
    """The seeded build tree: big files cut from a stream of structured
    segments (1/8 duplicated), small files sliced from the same stream
    into nested dirs.  Returns its byte count."""
    import numpy as np

    from longtail_jax.utils.corpus import segments

    total_big = sum(sz.big_files)
    n_seg = -(-total_big // sz.seg) + 1
    stream = segments(n_seg, seed, sz.seg)
    buf = next(stream)
    pos = 0
    rng = np.random.default_rng(seed + 1)
    samples = []
    os.makedirs(src)
    for i, size in enumerate(sz.big_files):
        with open(os.path.join(src, f"pak{i}.bin"), "wb") as f:
            left = size
            while left:
                if pos == len(buf):
                    buf, pos = next(stream), 0
                n = min(left, len(buf) - pos)
                f.write(buf[pos: pos + n].data)
                if len(samples) < 64:
                    samples.append(buf[pos: pos + min(n, sz.small_max)]
                                   .copy())
                pos += n
                left -= n
    pool = np.concatenate(samples)
    lo, hi = np.log(sz.small_min), np.log(sz.small_max)
    total = total_big
    for i in range(sz.n_small):
        n = int(np.exp(rng.uniform(lo, hi)))
        off = int(rng.integers(0, len(pool) - n))
        d = os.path.join(src, f"d{i % 23}", f"e{i % 7}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"f{i}.dat"), "wb") as f:
            f.write(pool[off: off + n].data)
        total += n
    return total


def same_tree(a: str, b: str) -> int:
    """Bit-exact comparison of two trees; returns the file count."""
    import filecmp

    n = 0
    for root, dirs, files in os.walk(a):
        rel = os.path.relpath(root, a)
        other = os.path.join(b, rel)
        if sorted(files) != sorted(
                f for f in os.listdir(other)
                if os.path.isfile(os.path.join(other, f))):
            fail("b", f"file lists differ under {rel}")
        for f in files:
            if not filecmp.cmp(os.path.join(root, f),
                               os.path.join(other, f), shallow=False):
                fail("b", f"{os.path.join(rel, f)} differs after downsync")
            n += 1
    return n


def upsync_phase(work: str, sz: Sizes) -> None:
    from longtail_jax import cli

    src = os.path.join(work, "src")
    t = time.perf_counter()
    total = write_corpus(src, sz, seed=7)
    n_files = sum(len(f) for _, _, f in os.walk(src))
    log(f"corpus: {n_files} files, {total} bytes "
        f"({time.perf_counter() - t:.1f}s)")
    if total < sz.min_total:
        fail("b", f"corpus of {total} bytes is under {sz.min_total}")
    lvis = {}
    for mode in ("host", "device"):
        store = os.path.join(work, f"store_{mode}")
        lvi = os.path.join(work, f"{mode}.lvi")
        argv = ["upsync", "--storage-uri", store, "--source-path", src,
                "--target-path", lvi]
        if mode == "device":
            argv.append("--device")
        t = time.perf_counter()
        if cli.main(argv) != 0:
            fail("b", f"{mode} upsync failed")
        dt = time.perf_counter() - t
        log(f"upsync {mode}: {dt:.1f}s ({total / dt / 1e9:.3f} GB/s wall, "
            "compilation included)")
        with open(lvi, "rb") as f:
            lvis[mode] = f.read()
    if lvis["host"] != lvis["device"]:
        fail("b", "the --device .lvi differs from the host .lvi")
    log(f"upsync: .lvi byte-identical, host vs --device "
        f"({len(lvis['host'])} bytes)")
    out = os.path.join(work, "out")
    t = time.perf_counter()
    if cli.main(["downsync", "--storage-uri",
                 os.path.join(work, "store_device"), "--source-path",
                 os.path.join(work, "device.lvi"), "--target-path",
                 out]) != 0:
        fail("b", "downsync failed")
    n = same_tree(src, out)
    log(f"downsync from the --device store: {n} files bit-exact "
        f"({time.perf_counter() - t:.1f}s)")


# -- (c) each stage vs its plain reference -----------------------------------

def stage_checks(sz: Sizes, impls) -> None:
    import jax
    import numpy as np

    from longtail_jax.ops import blake3, cdc, lz4, zstd_frame
    from longtail_jax.ops.device_entropy import _pack_streams_device
    from longtail_jax.parallel.device_chunker import ChunkerConfig
    from longtail_jax.parallel.device_lz4 import compress_block
    from longtail_jax.parallel.pipeline import (
        DevicePartIndexer,
        _pow2_padded,
        make_stage3_fn,
        padded_words_rows,
    )
    from longtail_jax.parallel.stage1 import unpack_stage1
    from longtail_jax.utils.corpus import segments

    cfg = ChunkerConfig.from_target(sz.target)
    P = sz.target * 1024
    B = sz.parts_per_batch
    ix = DevicePartIndexer(sz.target, lanes=B)
    batch = np.concatenate(list(segments(-(-B * P // sz.seg), 11, sz.seg)))
    rows = batch[: B * P].reshape(-1, 128)
    lengths = np.full((B,), P, np.int32)
    lengths[-1] = P - 4097
    rows.reshape(-1)[(B - 1) * P + lengths[-1]:] = 0
    rows_d = jax.device_put(rows)

    # stage 1: chunk sizes vs the host chunker
    prog = ix._stage1.program
    log(f"stage-1 program ({B} x {P >> 20} MiB parts): "
        f"{prog.lower(rows_d, lengths).compile().memory_analysis()}")
    packed, _, words2d = ix._stage1(rows_d, lengths)
    sizes, n, amb = unpack_stage1(np.asarray(packed), ix.plan)
    flat = rows.reshape(-1)
    all_st, all_sz = [], []
    for b in range(B):
        lane = flat[b * P: b * P + lengths[b]]
        want = np.diff(np.concatenate(
            [[0], cdc.chunk_part(lane, cfg.min_size, cfg.avg_size,
                                 cfg.max_size)]))
        if not amb[b] and not np.array_equal(sizes[b, : n[b]], want):
            fail("c", f"stage-1 sizes of lane {b} differ from the host")
        all_sz.append(want)
        all_st.append(np.concatenate([[0], np.cumsum(want)[:-1]]) + b * P)
    log(f"stage 1: chunk sizes of {B} lanes match cdc.chunk_part "
        f"(flagged lanes: {int(np.count_nonzero(amb))})")

    # stage 3: hashes vs the native host hasher
    st = np.concatenate(all_st).astype(np.int64)
    szs = np.concatenate(all_sz).astype(np.int64)
    padded = _pow2_padded(szs, ix._cap, ix._floor)
    blob, slots = [], []
    for cls, r in ix._class_plan:
        # rows past the plan take the pipeline's spill dispatch, which
        # runs this same program at the class's own shape
        idx = np.flatnonzero(padded == cls)[:r]
        part = np.zeros(2 * r, np.int32)
        part[: len(idx)] = st[idx]
        part[r: r + len(idx)] = szs[idx]
        blob.append(part)
        slots.append((idx, r))
    blob = jax.device_put(np.concatenate(blob))
    f3 = make_stage3_fn(ix._class_plan, "blake3", impls)
    assert words2d.shape[0] == padded_words_rows(rows.shape[0], ix._slack)
    log(f"stage-3 program ({ix._class_plan}): "
        f"{f3.lower(words2d, blob).compile().memory_analysis()}")
    lo, hi = (np.asarray(x) for x in f3(words2d, blob))
    got = lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))
    want = blake3.hash64_ranges(flat, st, szs)
    off = 0
    for idx, r in slots:
        if not np.array_equal(got[off: off + len(idx)], want[idx]):
            fail("c", "stage-3 hashes differ from the host hasher")
        off += r
    log(f"stage 3: {len(szs)} chunk hashes match blake3.hash64_ranges")

    # Huffman literal pack vs the host bitstream writer: one zstd block's
    # literals (128 KiB, four streams)
    lits = flat[sz.seg // 16: sz.seg // 16 + (128 << 10)]   # text region
    streams = np.array_split(lits, 4)
    _, code_val, code_len = zstd_frame.build_huffman(
        np.bincount(lits, minlength=256).tolist())
    got = _pack_streams_device(streams, code_val, code_len)
    for s, g in zip(streams, got):
        if g != zstd_frame._huf_encode_stream(s.tobytes(), code_val,
                                              code_len):
            fail("c", "device Huffman pack differs from the host writer")
    log(f"entropy: device Huffman pack of {len(lits)} literals matches "
        "zstd_frame._huf_encode_stream")

    # device LZ4 codec round trip on one 8 MiB block
    block = flat[: min(8 << 20, len(flat))].tobytes()
    out = compress_block(block)
    if lz4.decompress(out, len(block)) != block:
        fail("c", "device LZ4 block does not round-trip")
    log(f"lz4: device-anchored block round-trips "
        f"(ratio {len(block) / len(out):.2f}x)")


# -- --four-cards: the mesh path ---------------------------------------------

def four_cards(work: str, sz: Sizes) -> None:
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from longtail_jax import api
    from longtail_jax.formats import constants as C
    from longtail_jax.ops import blake3, cdc
    from longtail_jax.parallel.device_chunker import ChunkerConfig
    from longtail_jax.parallel.distributed import (
        host_unique_hashes,
        make_sharded_chunk_fn,
    )
    from longtail_jax.stores.fsblockstore import FSBlockStore
    from longtail_jax.stores.storage import FSStorage

    mesh = Mesh(np.asarray(jax.devices()[:4]), ("d",))
    src = os.path.join(work, "src")
    sz.n_small = min(sz.n_small, 200)
    sz.big_files = sz.mesh_big_files
    total = write_corpus(src, sz, seed=9)
    log(f"corpus: {total} bytes")
    lvis = {}
    for name, kw in (("single-device", {"xp": jax.numpy}),
                     ("mesh", {"mesh": mesh})):
        store = FSBlockStore(FSStorage(), os.path.join(work, name))
        t = time.perf_counter()
        vi, _ = api.upsync(FSStorage(), src, store,
                           compression_tag=C.COMPRESSION_TYPE_NONE, **kw)
        store.flush()
        lvis[name] = vi.to_bytes()
        log(f"upsync {name}: {time.perf_counter() - t:.1f}s")
    if lvis["mesh"] != lvis["single-device"]:
        fail("four-cards", "mesh .lvi differs from the single-device .lvi")
    log("four-cards: mesh upsync .lvi byte-identical to single-device")

    cfg = ChunkerConfig.from_target(sz.target)
    lanes, part = 8, 1 << 20
    rng = np.random.default_rng(5)
    parts = rng.integers(0, 256, (lanes, part), dtype=np.uint8)
    lengths = np.full((lanes,), part, np.int32)
    lengths[1] = cfg.min_size
    fn = make_sharded_chunk_fn(cfg, mesh, lanes // 4, part)
    _, _, _, ulo, uhi, n_uniq, overflow = fn(parts, lengths)
    if int(overflow):
        fail("four-cards", "dedup slots overflowed")
    got = host_unique_hashes(ulo, uhi, int(n_uniq))
    want = []
    for b in range(lanes):
        data = parts[b, : lengths[b]]
        ends = cdc.chunk_part(data, cfg.min_size, cfg.avg_size,
                              cfg.max_size)
        st = np.concatenate([[0], ends[:-1]]).astype(np.int64)
        want.append(blake3.hash64_ranges(data, st, (ends - st)))
    want = np.unique(np.concatenate(want))
    if not np.array_equal(got, want):
        fail("four-cards", "sharded chunk + dedup differs from the host")
    log(f"four-cards: sharded chunk + all-gather dedup matches the host "
        f"({len(want)} unique chunks)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-device mesh path")
    ap.add_argument("--rehearse", action="store_true",
                    help="every phase tiny on the CPU, kernels interpreted")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    try:
        import longtail_jax  # noqa: F401
    except ImportError:
        fail("a", "run from a checkout: the longtail_jax package is "
             "not beside chip_smoke.py")
    count = 4 if args.four_cards else 1
    if args.rehearse:
        os.environ["JAX_PLATFORMS"] = "cpu"
        if count > 1:
            os.environ["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "") +
                f" --xla_force_host_platform_device_count={count}").strip()
    sz = Sizes(args.rehearse)

    log(card_line(args.rehearse))                       # (a), before JAX
    if not args.four_cards:
        card_tests(args.rehearse)                       # (d)
    device = check_platform(args.rehearse, count)       # (a)
    build_native()                                      # (a)

    from longtail_jax.parallel import backend

    impls = backend.rehearsal() if args.rehearse else backend.current()
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        with backend.forced(impls):
            if args.four_cards:
                four_cards(work, sz)
            else:
                upsync_phase(work, sz)                  # (b)
                stage_checks(sz, impls)                 # (c)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
