"""Test harness configuration.

Tests run on the CPU with 8 virtual XLA devices, so the multi-device
sharding path (mesh + shard_map + psum) is exercised without accelerators
(XLA_FLAGS=--xla_force_host_platform_device_count=N). This must be set
before JAX initializes a backend, hence the top of conftest.

`JAX_PLATFORMS` picks the platform: unset, it defaults to the CPU here.
Tests marked `gpu` need an NVIDIA GPU and skip elsewhere; whether one is
present is decided per test, in a fixture (`chip_smoke.py` runs them on the
card).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_ON_CPU = os.environ["JAX_PLATFORMS"] == "cpu"
if _ON_CPU:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)

# The persistent compilation cache's native serializer has segfaulted on
# large 8-virtual-device CPU executables (in both put_executable_and_time
# and get_executable_and_time — jax compilation_cache.py:238/265). Tests
# gain nothing from executable persistence, so it stays off for the suite.
jax.config.update("jax_enable_compilation_cache", False)

import gc  # noqa: E402

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips on other platforms")


@pytest.fixture(autouse=True)
def _gpu_only(request):
    if request.node.get_closest_marker("gpu") \
            and jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run `python chip_smoke.py` on one)")


@pytest.fixture(autouse=True, scope="module")
def _bounded_executable_memory():
    """Drop JAX's in-process executable caches after every test module.

    One pytest process compiles thousands of 8-virtual-device CPU
    executables over the full suite; holding all of them alive has ended
    the run with a SIGSEGV inside the XLA:CPU backend. Executables are
    rarely shared across modules (shapes differ), so clearing per module
    bounds memory at near-zero recompile cost.
    """
    yield
    jax.clear_caches()
    gc.collect()
