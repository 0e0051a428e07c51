"""Profiling and telemetry.

The reference instruments FIFO stall counters in fabric
(check_fifo_*, kernelMatrixmult_all.cpp:1018-1291) plus host wall-clock
timers behind config.profiling and a max_fea range-telemetry register
(sgrace.py:506-520). Equivalents here: host-clock timers that end in
``block_until_ready`` (JAX returns before the device finishes, so a timer
without it measures only the enqueue), jax.profiler traces, and edges/s
throughput accounting.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional

import numpy as np


class Timer:
    """Wall-clock timer. Call ``jax.block_until_ready`` on device results
    inside the scope, or it times only their enqueue."""

    def __init__(self):
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        return False


def time_call(
    fn: Callable, *args, reps: int = 20, warmup: int = 2
) -> np.ndarray:
    """Host-clock seconds of ``reps`` calls of ``fn(*args)``, each ended by
    ``block_until_ready``, after ``warmup`` untimed calls (the first one
    compiles)."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    ts = np.empty(reps)
    for i in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts[i] = time.perf_counter() - t0
    return ts


def edges_per_second(nnz: int, seconds: float) -> float:
    return nnz / seconds if seconds > 0 else float("inf")


@contextlib.contextmanager
def profiler_trace(logdir: Optional[str]):
    """jax.profiler trace scope (no-op when logdir is None)."""
    if logdir is None:
        yield
        return
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
