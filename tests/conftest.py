"""Test configuration: run the suite on the CPU backend with 8 virtual
devices so sharding logic is exercised without several cards, and so
results are deterministic.  Mirrors the reference's strategy of
value-pinned CPU tests (reference ``tests/``, SURVEY.md §4).

Tests marked ``gpu`` need an NVIDIA GPU; they skip here and run on the
card through ``python chip_smoke.py``, whose phases make the same checks.
"""
import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# Persistent XLA compile cache (the suite is compile-dominated): the
# program's own rule — JAX_COMPILATION_CACHE_DIR when set, else the
# checkout's .jax_cache.
import openfdcm_tpu  # noqa: E402

openfdcm_tpu.enable_compilation_cache(min_compile_secs=1.0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips elsewhere; the same "
        "checks run on the card in chip_smoke.py)")


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX has none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU; run python chip_smoke.py on the card")
