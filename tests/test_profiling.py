"""Host-clock timing helpers (utils/profiling.py) and the benchmark's
refusal to time anything but a GPU."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np

from sgracex1_tpu.utils.profiling import Timer, edges_per_second, time_call

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_time_call_counts_reps_after_warmup():
    calls = []

    def f(x):
        calls.append(1)
        return x * 2

    ts = time_call(f, jnp.ones(4), reps=5, warmup=3)
    assert ts.shape == (5,) and (ts > 0).all()
    assert len(calls) == 8


def test_timer_blocks_on_device_work():
    with Timer() as t:
        y = jax.block_until_ready(jax.jit(lambda x: x @ x)(jnp.ones((64, 64))))
    assert t.elapsed > 0
    np.testing.assert_allclose(np.asarray(y), 64.0)
    assert edges_per_second(100, 0.5) == 200.0
    assert edges_per_second(100, 0.0) == float("inf")


def test_bench_refuses_without_gpu():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    p = subprocess.run(
        [sys.executable, "bench.py"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert p.returncode == 1
    assert p.stdout == ""
    assert "no GPU" in p.stderr
