import os

import pytest

# The suite runs on a virtual 8-device CPU mesh, so multi-device sharding
# logic is exercised without a card.  LT_TESTS_GPU=1 keeps JAX's own
# backend instead, for the card-only tests (marked ``gpu``):
#     LT_TESTS_GPU=1 python -m pytest -m gpu tests/
_ON_CARD = os.environ.get("LT_TESTS_GPU") == "1"
if not _ON_CARD:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

from longtail_jax.utils import compile_cache  # noqa: E402

if not _ON_CARD:
    jax.config.update("jax_platforms", "cpu")
# the persistent compile cache keeps repeat test runs fast
compile_cache.enable()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


@pytest.fixture
def gpu():
    """Skip unless JAX's backend is the card (decided at test time)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs the card: LT_TESTS_GPU=1 python -m pytest "
                    "-m gpu tests/")
    return jax.devices()[0]
