"""Test harness: run everything on an 8-device virtual CPU mesh.

This is the analog of the reference's local-cluster test rig
(grpc_testlib.h MakeTestCluster): multi-device semantics without hardware.
Must run before jax initializes its backends.

Tests marked ``gpu`` need the card and skip elsewhere (decided inside the
``gpu`` fixture, never at collection). They run on a GPU machine with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``, in one process:
a JAX process reserves most of the card's memory, so no second JAX
process may open it meanwhile.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import jax  # noqa: E402

from deeprec_tpu.utils import compile_cache  # noqa: E402

# Persistent compile cache: the suite is dominated by XLA CPU compiles of the
# probing/scatter loops; cache them across runs.
compile_cache.enable()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long multi-process / subprocess-cluster tests")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one (see the "
                   "gpu fixture)")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test on a host without one."""
    if jax.default_backend() != "gpu":
        pytest.skip(f"needs a CUDA device; default backend is "
                    f"{jax.default_backend()}")
    return jax.devices()[0]
