"""Test configuration.

The suite runs on the CPU backend with 8 virtual devices unless
JAX_PLATFORMS says otherwise (the analogue of the reference's
thread-count sweeps in tests/test_owf_wpp_tiles.sh — sharding layouts
must not change results).  Tests marked `gpu` need a CUDA card and skip
elsewhere; on a machine with one:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")

# NO persistent compilation cache for the suite: deserializing cached
# executables on the 8-virtual-device CPU backend segfaults the
# interpreter deterministically mid-suite (crash inside
# compilation_cache.get_executable_and_time / zstd).  Cold compiles
# are the stable trade.
os.environ["JAX_COMPILATION_CACHE_DIR"] = ""
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# Concurrent jit compiles from the encoder's worker threads have
# crashed inside the persistent-cache read path (zstd/deserialize
# segfault); serialize compiles process-wide for the whole suite.
import kvazaar_jax  # noqa: E402

kvazaar_jax.serialize_jax_compiles()


@pytest.fixture
def gpu_device():
    """The first CUDA device; skips the test when JAX has none."""
    import jax
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a CUDA GPU (JAX_PLATFORMS=cuda -m gpu)")
    return devs[0]
