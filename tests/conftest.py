"""Test harness: run everything on a virtual 8-device CPU mesh.

Sharding/collective tests need multiple devices; TPU hardware is exercised
separately by bench.py and the driver's graft entry. Env vars must be set
before the first jax import.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"  # override: the host env pins the TPU
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# The TPU plugin overrides jax_platforms at register time — override it
# back so tests stay on the virtual CPU mesh (shared helper).
sys_path_root = os.path.join(os.path.dirname(__file__), "..")
import sys  # noqa: E402

sys.path.insert(0, sys_path_root)
from gsplat_tpu.utils.platform import honor_cpu_platform_request  # noqa: E402

honor_cpu_platform_request()

# Persistent XLA-CPU compile cache: interpret-mode pallas compiles dominate
# suite wall-clock (~30-60 s per distinct step geometry); cache hits across
# pytest runs cut repeat suite time severalfold.
jax.config.update(
    "jax_compilation_cache_dir",
    os.path.join(os.path.dirname(__file__), "..", ".jax_cache"),
)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run tests marked slow (deep redundancy checks)",
    )


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: deep/redundant check, skipped unless --runslow"
    )
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips without a card"
    )


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip = pytest.mark.skip(reason="slow: run with --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture
def rng():
    return np.random.default_rng(0)
