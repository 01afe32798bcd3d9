"""Test configuration: run everything on a virtual 8-device CPU mesh.

The tests are CPU tests: sharding correctness is validated on host-platform
virtual devices (multi-device testing without a cluster, SURVEY.md §4).
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

# If some plugin imported jax before this conftest ran, the env var above was
# read too late — update the live config too.
jax.config.update("jax_platforms", "cpu")
# Keep CPU-compiled programs out of the package's persistent cache: that
# directory travels with the checkout, and XLA entries compiled for this
# host's CPU features can crash (SIGILL) a process on another host that
# loads them.
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)
