"""Interconnect communication-volume model for the distributed layers.

A first-order comm model: the exact bytes each collective moves per layer
(a property of the halo plan, not the hardware), divided by the link
bandwidth of the device, against the compute time. It turns the scaling
target (BASELINE.md: >= 80% edges/s efficiency at N devices) into a
falsifiable prediction (mesh -> shardings -> collectives -> count the
bytes) that a measured multi-device step can be held to.

The reference's analogue is its crossbar/DMA sizing arithmetic
(``kernelMatrixmult_all.cpp`` C-buffer replication; SURVEY.md §2.5) — the
FPGA design also had to budget boundary traffic against fabric bandwidth.

Link bandwidth comes from the peaks table of utils/roofline, keyed by
``device_kind``: on an H100 host NVLink joins every card to every other at
450 GB/s each way, so a 1-D ``all_to_all`` is bounded by each device's own
outbound rate whatever the mesh order.
"""

from __future__ import annotations

import dataclasses

from sgracex1_tpu.utils.roofline import device_peaks

# the device the model predicts for when the caller names none
DEFAULT_DEVICE = "NVIDIA H100 80GB HBM3"


def link_bytes_s(device_kind: str = DEFAULT_DEVICE) -> float:
    """Outbound interconnect bytes/s of one device (NVLink, each way)."""
    return device_peaks(device_kind)["nvlink_each_way"]


@dataclasses.dataclass(frozen=True)
class CommCost:
    """Per-device, per-layer-invocation interconnect traffic in bytes."""

    bytes_out: float  # sent over the interconnect by each device
    note: str = ""

    def seconds(self, bytes_s: float | None = None) -> float:
        return self.bytes_out / (bytes_s or link_bytes_s())

    def __add__(self, other: "CommCost") -> "CommCost":
        return CommCost(
            self.bytes_out + other.bytes_out,
            "+".join(n for n in (self.note, other.note) if n),
        )


def halo_comm(G, F: int, *, itemsize: int = 4, backward: bool = False) -> CommCost:
    """Boundary exchange of :class:`~sgracex1_tpu.parallel.halo.HaloGraph`.

    The forward ``all_to_all`` ships ``send_idx``-gathered rows [S, L, F];
    each device keeps its own slot, so (S-1)*L*F*itemsize crosses the links.
    The backward transposes the collective (same volume back).
    """
    S, L = G.n_shards, G.halo_len
    per_pass = (S - 1) * L * F * itemsize
    return CommCost(
        float(per_pass * (2 if backward else 1)),
        note=f"halo S={S} L={L} F={F}",
    )


def allgather_comm(n_pad: int, F: int, S: int, *, itemsize: int = 4,
                   backward: bool = False) -> CommCost:
    """Replicated-H layer (``spmm_dist.dist_gnn_layer``): each device
    receives the other shards' rows — (S-1)/S * n_pad * F. The backward's
    ``psum``/reduce-scatter of the gathered cotangent moves the same volume."""
    per_pass = (S - 1) / S * n_pad * F * itemsize
    return CommCost(
        float(per_pass * (2 if backward else 1)),
        note=f"all-gather n={n_pad} F={F} S={S}",
    )


def predicted_efficiency(
    comp_sec_single: float,
    n_devices: int,
    comm: CommCost,
    *,
    bytes_s: float | None = None,
    overlap: float = 0.0,
) -> dict:
    """Scaling efficiency prediction: perfect 1/S compute split plus
    serialized (or partially overlapped) collective time.

    efficiency = T_1 / (S * T_S)  with  T_S = T_1/S + (1-overlap)*T_comm.
    """
    t_comp = comp_sec_single / n_devices
    t_comm = comm.seconds(bytes_s) * (1.0 - min(max(overlap, 0.0), 1.0))
    t_step = t_comp + t_comm
    return dict(
        t_comp_us=round(t_comp * 1e6, 2),
        t_comm_us=round(t_comm * 1e6, 2),
        efficiency=round(t_comp / t_step, 4) if t_step > 0 else 1.0,
        comm_bytes=int(comm.bytes_out),
        note=comm.note,
    )


def scaling_table(
    comp_sec_single: float,
    comms: dict,
    *,
    bytes_s: float | None = None,
    overlap: float = 0.0,
) -> dict:
    """``{n_devices: CommCost}`` -> per-count efficiency predictions."""
    return {
        s: predicted_efficiency(
            comp_sec_single, s, c, bytes_s=bytes_s, overlap=overlap
        )
        for s, c in sorted(comms.items())
    }
