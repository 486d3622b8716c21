"""Test configuration: run everything on a virtual 8-device CPU mesh.

Mirrors the reference's loopback-mtssrv trick for exercising multi-node
logic on one machine (SURVEY.md §4.2): multi-chip sharding is validated on
CPU with XLA's forced host device count. Must run before jax is imported.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

from mitsuba_customization_tpu.utils import compile_cache  # noqa: E402

# Persistent compilation cache: the suite's wall time is dominated by XLA
# compiles of near-identical render graphs, so repeat runs reuse them.
compile_cache.enable()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def gpu_device():
    """The first GPU; tests marked `gpu` skip where there is none."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU (chip_smoke.py runs these checks on one)")
    return gpus[0]
