"""Test configuration: the suite runs on the CPU with 8 virtual devices.

Tests must be hermetic and exercise the multi-device sharding paths, so the
CPU backend is the default, with 8 virtual devices.  Tests of the CUDA
kernels are marked `gpu` and skip there; on a machine with an NVIDIA GPU
they run with

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -n 0

(the program itself runs on the GPU through `chip_smoke.py`).
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

from ringsnark_tpu.utils.cache import enable_compile_cache  # noqa: E402

jax.config.update("jax_enable_x64", True)
# persistent jit cache: repeat runs skip recompilation (the suite is
# compile-dominated on the CPU)
enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: exhaustive sweep / redundant parameterization; skipped unless "
        "RINGSNARK_SLOW=1.  The default tier keeps one representative case "
        "per code path.",
    )


def pytest_collection_modifyitems(config, items):
    if os.environ.get("RINGSNARK_SLOW"):
        return
    skip = pytest.mark.skip(reason="slow sweep; set RINGSNARK_SLOW=1 to run")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on an NVIDIA GPU (decided at test time)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
