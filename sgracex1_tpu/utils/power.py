"""Power and energy recording.

The reference samples board power rails during training with a pynq
``DataRecorder`` (``demo/emulation/demo_sgrace.py:158-168``:
``recorder = DataRecorder(rails['0V85'].power)``,
``with recorder.record(0.2): ...``, results in ``recorder.frame``). Here:

* :class:`PowerRecorder` — the same record-while-running API, driven by any
  sampler callable. :func:`nvidia_smi_power` is the sampler for an NVIDIA
  card: it reads ``nvidia-smi`` in a child process, so the sampling thread
  never touches JAX.
* :func:`energy_estimate` — a model-based estimate for a device without a
  sensor: wall time x a utilization-interpolated power envelope that the
  caller supplies (idle and busy watts of that device).
"""

from __future__ import annotations

import contextlib
import subprocess
import threading
import time
from typing import Callable, List, Optional, Tuple


def nvidia_smi(query: str, index: int = 0) -> str:
    """One ``nvidia-smi --query-gpu=<query>`` reading of card ``index``
    (CSV, no header), e.g. ``nvidia_smi("name,power.limit")``."""
    return subprocess.run(
        [
            "nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader",
            "-i", str(index),
        ],
        capture_output=True, text=True, check=True, timeout=30,
    ).stdout.strip()


def nvidia_smi_power(index: int = 0) -> Callable[[], float]:
    """Sampler for :class:`PowerRecorder`: the card's power draw in watts."""

    def sample() -> float:
        return float(nvidia_smi("power.draw", index).split()[0])

    return sample


class PowerRecorder:
    """Sample a power sensor while a block runs; integrate to energy.

    API mirrors the pynq ``DataRecorder`` the reference uses
    (``demo_sgrace.py:158-168``): construct with a sensor, ``record()`` as a
    context manager around the workload, read ``frame`` / ``energy_j``
    afterwards.

    ``sampler`` is any zero-arg callable returning instantaneous watts.
    """

    def __init__(self, sampler: Callable[[], float]):
        self.sampler = sampler
        self.frame: List[Tuple[float, float]] = []  # (t_rel_s, watts)
        self._stop: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None

    @contextlib.contextmanager
    def record(self, interval_s: float = 0.2):
        self.frame = []
        self._stop = threading.Event()
        t0 = time.time()

        def loop():
            while not self._stop.is_set():
                try:
                    w = float(self.sampler())
                except Exception:  # sensor glitch: skip the sample
                    w = float("nan")
                self.frame.append((time.time() - t0, w))
                self._stop.wait(interval_s)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        try:
            yield self
        finally:
            self._stop.set()
            self._thread.join(timeout=5.0)
            # closing sample so the last interval integrates
            try:
                self.frame.append((time.time() - t0, float(self.sampler())))
            except Exception:
                pass

    @property
    def duration_s(self) -> float:
        return self.frame[-1][0] if self.frame else 0.0

    @property
    def mean_w(self) -> float:
        vals = [w for _, w in self.frame if w == w]  # drop NaNs
        return sum(vals) / len(vals) if vals else 0.0

    @property
    def energy_j(self) -> float:
        """Trapezoidal integral of the recorded (t, W) samples."""
        pts = [(t, w) for t, w in self.frame if w == w]
        e = 0.0
        for (t0, w0), (t1, w1) in zip(pts, pts[1:]):
            e += 0.5 * (w0 + w1) * (t1 - t0)
        return e


def energy_estimate(
    sec: float,
    utilization: float,
    *,
    idle_w: float,
    busy_w: float,
) -> dict:
    """Model-based energy for a kernel with no power sensor available.

    ``utilization`` is the achieved fraction of the binding resource's peak
    (``CostModel.roofline(sec)["pct_roofline"] / 100``): power is
    interpolated linearly between the idle and busy envelopes — the standard
    first-order accelerator power model (activity-proportional dynamic power
    on top of static leakage).
    """
    u = min(max(utilization, 0.0), 1.0)
    watts = idle_w + (busy_w - idle_w) * u
    return dict(
        watts=round(watts, 1),
        joules=round(watts * sec, 4),
        utilization=round(u, 3),
        model=f"linear idle={idle_w}W busy={busy_w}W",
    )


def energy_for_cost(cost, sec: float, **kw) -> dict:
    """Energy estimate for one kernel invocation from its roofline cost
    model (:class:`sgracex1_tpu.utils.roofline.CostModel`) and measured
    seconds; ``kw`` carries the envelope (idle_w, busy_w) and optionally
    ``device_kind`` for the roofline."""
    r = cost.roofline(sec, device_kind=kw.pop("device_kind", None))
    out = energy_estimate(sec, r["pct_roofline"] / 100.0, **kw)
    out["bound"] = r["bound"]
    return out
