"""CLI end-to-end: the seven reference commands against a real filesystem
(pipeline parity with cmd/main.c UpSync/DownSync/Validate/ls/cp/Pack/Unpack)."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(REPO, "tests", "testdata", "sample_folder")


def cli(*args):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               PYTHONIOENCODING="utf-8")
    return subprocess.run(
        [sys.executable, "-m", "longtail_jax.cli", *args],
        capture_output=True, text=True, encoding="utf-8", env=env,
        timeout=120)


def tree(root):
    out = {}
    for dirpath, _dirnames, filenames in os.walk(root):
        for f in filenames:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


@pytest.fixture(scope="module")
def synced(tmp_path_factory):
    base = tmp_path_factory.mktemp("cli")
    store = str(base / "store")
    lvi = str(base / "v1.lvi")
    r = cli("upsync", "--storage-uri", store, "--source-path", SAMPLE,
            "--target-path", lvi, "--target-chunk-size", "512")
    assert r.returncode == 0, r.stderr + r.stdout
    return base, store, lvi


def test_upsync_creates_store_and_index(synced):
    base, store, lvi = synced
    assert os.path.exists(lvi)
    assert os.path.exists(os.path.join(store, "store.lsi"))
    assert os.path.isdir(os.path.join(store, "chunks"))


def test_downsync_bit_exact(synced):
    base, store, lvi = synced
    dst = str(base / "dst")
    r = cli("downsync", "--storage-uri", store, "--source-path", lvi,
            "--target-path", dst)
    assert r.returncode == 0, r.stderr + r.stdout
    assert tree(dst) == tree(SAMPLE)


def test_validate(synced):
    base, store, lvi = synced
    r = cli("validate", "--storage-uri", store, "--version-index-path", lvi)
    assert r.returncode == 0, r.stderr + r.stdout
    assert "OK" in r.stdout


def test_ls(synced):
    base, store, lvi = synced
    r = cli("ls", "--version-index-path", lvi)
    assert r.returncode == 0, r.stderr + r.stdout
    assert "WillBeRenamed.txt" in r.stdout
    r2 = cli("ls", "--version-index-path", lvi, "strange")
    # the fixture's name is non-ASCII (checked out as U+FFFD on this image)
    assert "�.txt" in r2.stdout


def test_cp(synced):
    base, store, lvi = synced
    out = str(base / "copied.txt")
    r = cli("cp", "--storage-uri", store, "--version-index-path", lvi,
            "JustDifferent.txt", out)
    assert r.returncode == 0, r.stderr + r.stdout
    assert open(out, "rb").read() == \
        open(os.path.join(SAMPLE, "JustDifferent.txt"), "rb").read()


def test_pack_unpack(tmp_path):
    la = str(tmp_path / "sample.la")
    r = cli("pack", "--source-path", SAMPLE, "--target-path", la,
            "--target-chunk-size", "512", "--compression-algorithm", "lz4")
    assert r.returncode == 0, r.stderr + r.stdout
    assert os.path.exists(la)
    dst = str(tmp_path / "unpacked")
    r = cli("unpack", "--source-path", la, "--target-path", dst)
    assert r.returncode == 0, r.stderr + r.stdout
    assert tree(dst) == tree(SAMPLE)


def test_downsync_with_cache(synced, tmp_path):
    base, store, lvi = synced
    cache = str(tmp_path / "cache")
    dst = str(tmp_path / "dst2")
    r = cli("downsync", "--storage-uri", store, "--source-path", lvi,
            "--target-path", dst, "--cache-path", cache)
    assert r.returncode == 0, r.stderr + r.stdout
    assert tree(dst) == tree(SAMPLE)
    assert os.path.isdir(cache)


def test_device_refuses_a_silent_cpu(tmp_path, monkeypatch):
    """--device on JAX's CPU backend fails unless JAX_PLATFORMS=cpu asked
    for it, and leaves no codec switched to the device path."""
    from longtail_jax import cli as cli_mod
    from longtail_jax.ops.compression_registry import Lz4Codec, ZstdCodec

    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    with pytest.raises(SystemExit, match="no accelerator"):
        cli_mod.main(["upsync", "--storage-uri", str(tmp_path / "store"),
                      "--source-path", SAMPLE, "--target-path",
                      str(tmp_path / "v.lvi"), "--device"])
    assert not Lz4Codec.use_device and not ZstdCodec.use_device
    assert not os.path.exists(tmp_path / "v.lvi")


def test_device_upsync_on_cpu_when_asked(synced, tmp_path, monkeypatch):
    """With JAX_PLATFORMS=cpu the device plane runs on the CPU, writes
    the host run's .lvi byte for byte, and restores the codecs after."""
    from longtail_jax import cli as cli_mod
    from longtail_jax.ops.compression_registry import Lz4Codec, ZstdCodec

    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    lvi = tmp_path / "dev.lvi"
    assert cli_mod.main(["upsync", "--storage-uri", str(tmp_path / "store"),
                         "--source-path", SAMPLE, "--target-path", str(lvi),
                         "--target-chunk-size", "512", "--device"]) == 0
    assert not Lz4Codec.use_device and not ZstdCodec.use_device
    assert lvi.read_bytes() == open(synced[2], "rb").read()
