"""The package under a second import name (utils/alias.py)."""

import importlib
import os
import subprocess
import sys

import longtail_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_alias_serves_the_same_module_objects():
    from longtail_jax.utils import alias

    old = "longtail_former"
    n_finders = len(sys.meta_path)
    alias.install(old)
    try:
        assert importlib.import_module(old) is longtail_jax
        dedup = importlib.import_module(old + ".core.dedup")
        import longtail_jax.core.dedup as real
        assert dedup is real
        assert real.__spec__.name == "longtail_jax.core.dedup"
    finally:
        del sys.meta_path[0]
        for name in [m for m in sys.modules if m.split(".")[0] == old]:
            del sys.modules[name]
    assert len(sys.meta_path) == n_finders


def test_alias_runs_the_cli_as_a_module():
    code = ("import runpy, sys; from longtail_jax.utils import alias; "
            "alias.install('longtail_former'); "
            "sys.argv = ['cli', '--help']; "
            "runpy.run_module('longtail_former.cli', run_name='__main__')")
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "upsync" in r.stdout
