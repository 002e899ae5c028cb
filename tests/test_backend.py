"""The seam between JAX backends and device stages
(parallel/backend.py), and where the compile cache lives
(utils/compile_cache.py)."""

import os
import subprocess
import sys

import pytest

jax = pytest.importorskip("jax")

from longtail_jax.parallel import backend  # noqa: E402
from longtail_jax.utils import compile_cache  # noqa: E402


def test_gpu_gets_the_card_kernels():
    impls = backend.for_backend("gpu")
    assert (impls.walk, impls.hash) == ("triton", "triton")
    assert impls.max_lanes is None and not impls.interpret


def test_cpu_gets_the_plain_references():
    impls = backend.for_backend("cpu")
    assert (impls.walk, impls.hash) == ("xla", "xla")
    assert impls.max_lanes == 8 and not impls.interpret
    assert backend.current() == impls        # the suite runs on the CPU


def test_unknown_backend_is_an_error_naming_it():
    with pytest.raises(RuntimeError, match="'metal'"):
        backend.for_backend("metal")


def test_rehearsal_is_explicit_and_scoped():
    """Interpret mode comes only from rehearsal(), in force only inside
    forced(); the pipeline picks it up, and its lane cap goes with it."""
    from longtail_jax.parallel.pipeline import DevicePartIndexer

    assert backend.rehearsal().interpret
    assert backend.rehearsal().walk == backend.GPU.walk
    capped = DevicePartIndexer(1024, batch_bytes=64 << 20)
    assert capped.impls == backend.CPU and capped.lanes == 8
    with backend.forced(backend.rehearsal()) as impls:
        assert backend.current() is impls
        wide = DevicePartIndexer(1024, batch_bytes=64 << 20)
        assert wide.impls.interpret and wide.lanes == 64
    assert backend.current() == backend.CPU


def _cache_dir_in_child(env_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    code = ("import jax; from longtail_jax.utils import compile_cache; "
            "print(compile_cache.enable()); "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True,
                         cwd=compile_cache.CHECKOUT).stdout.split()
    return out


def test_cache_defaults_to_the_checkout():
    want = os.path.join(compile_cache.CHECKOUT, ".jax_cache")
    assert _cache_dir_in_child(None) == [want, want]
    assert os.path.isfile(os.path.join(compile_cache.CHECKOUT,
                                       "longtail_jax", "__init__.py"))


def test_cache_env_var_wins(tmp_path):
    d = str(tmp_path / "cc")
    assert _cache_dir_in_child(d) == [d, d]
