from sgracex1_tpu.utils.profiling import Timer, edges_per_second
from sgracex1_tpu.utils.power import PowerRecorder, energy_estimate

__all__ = [
    "Timer",
    "edges_per_second",
    "PowerRecorder",
    "energy_estimate",
]
