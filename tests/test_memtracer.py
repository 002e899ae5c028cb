"""memtracer: per-context allocation stats + CLI --mem-tracer flag.

Reference: lib/memtracer/longtail_memtracer.c:32-78 (context stats),
:122 (DumpStats), cmd/main.c:2959 (--mem-tracer flag).
"""

import numpy as np

from longtail_jax.utils import memtracer


def test_context_attribution_and_peak():
    memtracer.install()
    memtracer.reset()
    try:
        keep = []
        with memtracer.context("phase_a"):
            keep.append(np.zeros(1 << 20, dtype=np.uint8))
        with memtracer.context("phase_b"):
            tmp = np.zeros(4 << 20, dtype=np.uint8)
            del tmp
        a = memtracer.stats("phase_a")
        b = memtracer.stats("phase_b")
        assert a.count == 1 and a.mem >= 1 << 20
        # phase_b freed its allocation: net ~0 but peak saw the 4 MiB
        assert b.peak >= 4 << 20
        assert abs(b.mem) < 1 << 19
        assert memtracer.global_peak() >= 4 << 20
        summary = memtracer.dump_stats()
        assert "phase_a" in summary and "global peak" in summary
    finally:
        memtracer.uninstall()


def test_noop_when_not_installed():
    memtracer.reset()
    with memtracer.context("dark"):
        pass
    assert memtracer.stats("dark").count == 0


def test_csv_dump(tmp_path):
    memtracer.install()
    memtracer.reset()
    try:
        with memtracer.context("csv_phase"):
            _ = bytearray(1 << 16)
        out = tmp_path / "mem.csv"
        memtracer.dump_stats(str(out))
        lines = out.read_text().splitlines()
        assert lines[0] == "context;count;net_mem;peak"
        assert any(line.startswith("csv_phase;1;") for line in lines[1:])
    finally:
        memtracer.uninstall()


def test_cli_mem_tracer_flag(tmp_path, capsys):
    from longtail_jax.cli import main

    src = tmp_path / "src"
    src.mkdir()
    (src / "a.bin").write_bytes(np.random.default_rng(0).integers(
        0, 256, 1 << 16, dtype=np.uint8).tobytes())
    store = tmp_path / "store"
    lvi = tmp_path / "v.lvi"
    rc = main(["--mem-tracer", "upsync",
               "--storage-uri", str(store),
               "--source-path", str(src),
               "--target-path", str(lvi)])
    assert rc == 0
    err = capsys.readouterr().err
    assert "ChunkAssets" in err and "global peak" in err
