"""Multi-host scaffold: the 2-process CPU dryrun.

Two real OS processes initialize jax.distributed over a local
coordinator, shard the file list, chunk their own shards, exchange the
chunk streams with the padded all-gather, and upload their own block
slices into one shared fs store.  The merged result must be
byte-identical to a single-process upsync: same ``.lvi``, same block
set.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def _build_tree(root):
    rng = np.random.default_rng(77)
    spec = [("a/big.bin", 1024 * 1024 + 333), ("b/mid.bin", 300000),
            ("c.bin", 150000), ("d/e/deep.bin", 70000),
            ("small.txt", 900), ("tiny", 1), ("empty", 0)]
    for path, size in spec:
        full = os.path.join(root, path)
        os.makedirs(os.path.dirname(full), exist_ok=True)
        with open(full, "wb") as f:
            f.write(rng.integers(0, 256, size, np.uint8).tobytes())


def run_two_process_upsync(tmp: str, timeout: int = 300) -> None:
    """Shared helper (also used by __graft_entry__.dryrun_multichip)."""
    src = os.path.join(tmp, "src")
    os.makedirs(src)
    _build_tree(src)

    # single-process reference
    from longtail_jax import api
    from longtail_jax.stores.compressblockstore import CompressBlockStore
    from longtail_jax.stores.fsblockstore import FSBlockStore
    from longtail_jax.stores.storage import FSStorage

    st = FSStorage()
    store_s = CompressBlockStore(
        FSBlockStore(FSStorage(), os.path.join(tmp, "store_s")))
    vi_s, _ = api.upsync(st, src, store_s, target_chunk_size=1024,
                         workers=4)
    store_s.flush()

    port = _free_port()
    store_m = os.path.join(tmp, "store_m")
    lvi_m = os.path.join(tmp, "vm.lvi")
    out_m = os.path.join(tmp, "out_m")
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        LT_MH_COORD=f"127.0.0.1:{port}",
        LT_MH_NPROC="2",
        LT_MH_SRC=src,
        LT_MH_STORE=store_m,
        LT_MH_LVI=lvi_m,
        LT_MH_OUT=out_m,
        LT_MH_TCS="1024",
    )
    env.pop("XLA_FLAGS", None)   # one CPU device per process is fine
    procs = []
    for pid in range(2):
        e = dict(env, LT_MH_PID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "longtail_jax.parallel.multihost"],
            env=e, cwd=os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out.decode(errors="replace"))
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"

    with open(lvi_m, "rb") as f:
        lvi_mesh = f.read()
    assert lvi_mesh == vi_s.to_bytes(), "2-process .lvi differs"

    # same block set on disk
    def blocks(d):
        out = set()
        for r, _, fs in os.walk(d):
            out.update(f for f in fs if f.endswith(".lrb"))
        return out

    assert blocks(store_m) == blocks(os.path.join(tmp, "store_s")), \
        "2-process store block set differs"

    # and the merged store serves a full reconstruction
    store2 = CompressBlockStore(FSBlockStore(FSStorage(), store_m))
    out_dir = os.path.join(tmp, "out")
    from longtail_jax.formats.version_index import VersionIndex
    api.downsync(store2, st, out_dir, VersionIndex.from_bytes(lvi_mesh),
                 workers=4)

    def assert_tree_equal(got_root):
        n = 0
        for r, _, fs in os.walk(src):
            for f in fs:
                a = os.path.join(r, f)
                b = os.path.join(got_root, os.path.relpath(a, src))
                with open(a, "rb") as fa, open(b, "rb") as fb:
                    assert fa.read() == fb.read(), a
                n += 1
        assert n > 0

    assert_tree_equal(out_dir)
    # the SHARDED downsync (blocks dealt over the two processes into one
    # shared target, multihost.downsync_sharded) must reconstruct the
    # identical tree
    assert_tree_equal(out_m)


def test_two_process_upsync_matches_single(tmp_path):
    run_two_process_upsync(str(tmp_path))
