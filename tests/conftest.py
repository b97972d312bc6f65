"""Test configuration: hermetic 8-virtual-device CPU mesh + float64.

Multi-device code is tested without a cluster the standard JAX way
(SURVEY.md §4): force the host platform to expose 8 fake CPU devices
(XLA_FLAGS must be set before the CPU client initializes) and pin the
platform to the CPU.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: the suite's wall time is dominated by
# jit compiles of many distinct solver configurations; caching them on
# disk makes repeat runs (the common case while iterating) several times
# faster.  Keyed by jaxpr/flags/version, so stale hits are not a risk.
# JAX_COMPILATION_CACHE_DIR, when set, wins (JAX reads it itself).
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir",
                      os.path.join(os.path.dirname(__file__), ".jax_cache"))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    # deterministic RNG fixture (reference unit_tests.py:8 seeds 42)
    return np.random.default_rng(42)
