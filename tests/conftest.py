"""Test configuration: run on a simulated 8-device CPU mesh.

Multi-device hardware is not available in CI; distributed tests follow the
strategy of SURVEY.md §4.6 — XLA host-platform device multiplication.
Must run before the first jax import.

Tests that need an NVIDIA GPU carry the ``gpu`` marker and take the
``gpu`` fixture, which skips them unless JAX's default backend is a GPU.
Run them on a machine with a card by opting out of the CPU pin:

    SGRACE_TEST_GPU=1 python -m pytest tests/ -m gpu
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# Force CPU unless the GPU opt-in is set (tests must be runnable anywhere).
# The env var alone is not enough when jax is already imported, so use the
# config API as well.
if not os.environ.get("SGRACE_TEST_GPU"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none. Decided here,
    at run time, never while the module is collected."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with SGRACE_TEST_GPU=1)")
    return jax.devices()[0]


@pytest.fixture
def rng():
    return np.random.default_rng(12345)


def make_random_graph(rng, n, avg_degree=4, self_loops=True):
    """Random directed graph edge_index [2, E] without duplicate edges."""
    e = n * avg_degree
    rows = rng.integers(0, n, size=e)
    cols = rng.integers(0, n, size=e)
    pairs = np.unique(np.stack([rows, cols]), axis=1)
    return pairs


@pytest.fixture
def random_graph(rng):
    return make_random_graph(rng, 64)
