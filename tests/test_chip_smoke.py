"""chip_smoke.py's contract off the card: the CPU rehearsal runs every
phase and ends with the result line; without a card, or outside a
checkout, it exits non-zero and prints no result."""

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "chip_smoke.py")


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, SMOKE, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_rehearse_runs_every_phase(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    r = _run(["--rehearse"], str(tmp_path), env)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == {
        "ok": True, "device": {"platform": "cpu", "kind": "cpu",
                               "count": 1}}
    out = r.stdout
    for phase in ("gpu tests:", "native: 6 libraries", ".lvi byte-identical",
                  "bit-exact", "stage 1:", "stage 3:", "entropy:", "lz4:"):
        assert phase in out, phase


def test_without_a_card_no_result(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PATH="")
    r = _run([], str(tmp_path), env)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_alone_in_a_directory_no_result(tmp_path):
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, "chip_smoke.py", "--rehearse"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=120, env=dict(os.environ, PYTHONPATH=""))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
