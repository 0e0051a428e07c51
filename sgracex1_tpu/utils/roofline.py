"""Roofline attribution: how far an aggregation sits from the device's peaks.

The analogue of the reference's in-fabric FIFO stall counters
(``kernelMatrixmult_all.cpp:1018-1291``, decoded in
``jupyter/test/mmult-master.ipynb`` cells 39-40 into statements like
"frontend fast/slow"). A GPU exposes no such counters to the program, but
each backend's ideal device-memory bytes and FLOPs per invocation can be
computed from its shapes; divided by a measured time they give the achieved
fraction of the device's peak for each resource. The resource with the
highest fraction is the one the kernel is bound by.

Peaks come from one table keyed by ``device_kind``
(``jax.devices()[0].device_kind``). A device that is not in the table is an
error, not a default: a share of the wrong peak is worse than none.
"""

from __future__ import annotations

import dataclasses

# Published dense peaks (no sparsity). Source: NVIDIA H100 Tensor Core GPU
# data sheet, SXM5 column; the rates assume the card's full 700 W power
# limit. ``nvlink_each_way`` is half the 900 GB/s bidirectional NVLink.
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(
        bf16_flops=989e12,
        tf32_flops=495e12,
        f32_flops=67e12,
        int8_ops=1979e12,
        hbm_bytes=3.35e12,
        nvlink_each_way=450e9,
        source="NVIDIA H100 data sheet (SXM5, dense)",
    ),
}


def device_peaks(device_kind: str | None = None) -> dict:
    """Peak rates of ``device_kind`` (default: JAX's first device)."""
    if device_kind is None:
        import jax

        device_kind = jax.devices()[0].device_kind
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device {device_kind!r}; add them to "
            "sgracex1_tpu.utils.roofline.PEAKS with their source"
        ) from None


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Ideal per-invocation resource footprint of one kernel call.

    ``flops_kind`` names the peak the FLOPs are held to (``bf16_flops``,
    ``tf32_flops``, ``f32_flops``, ``int8_ops``)."""

    flops: float
    hbm_bytes: float
    note: str = ""
    flops_kind: str = "bf16_flops"

    def __add__(self, other: "CostModel") -> "CostModel":
        return CostModel(
            self.flops + other.flops,
            self.hbm_bytes + other.hbm_bytes,
            "+".join(n for n in (self.note, other.note) if n),
            self.flops_kind,
        )

    def roofline(self, sec: float, *, device_kind: str | None = None) -> dict:
        """Achieved rates and % of peak; ``bound`` names the resource whose
        utilization is highest (the one the kernel is limited by if the cost
        model is right). ``pct_roofline`` is the least time the device could
        take over ``sec``."""
        peaks = device_peaks(device_kind)
        pct = {
            "compute": 100.0 * self.flops / sec / peaks[self.flops_kind],
            "memory": 100.0 * self.hbm_bytes / sec / peaks["hbm_bytes"],
        }
        bound = max(pct, key=pct.get)
        return dict(
            tflops=self.flops / sec / 1e12,
            gb_s=self.hbm_bytes / sec / 1e9,
            pct_compute=pct["compute"],
            pct_memory=pct["memory"],
            bound=bound,
            pct_roofline=pct[bound],
            note=self.note,
        )


def cost_dense(n_pad: int, P: int, a_itemsize: int = 2) -> CostModel:
    """Dense backend: one [n, n] @ [n, P] matmul; the adjacency streams from
    device memory, H is read and the output written once."""
    return CostModel(
        flops=2.0 * n_pad * n_pad * P,
        hbm_bytes=float(
            n_pad * n_pad * a_itemsize + n_pad * P * 2 + n_pad * P * 4
        ),
        note="dense",
    )


def cost_xla_edges(nnz: int, n_rows: int, P: int) -> CostModel:
    """XLA take + segment_sum: per edge, 3 index/value words, a gathered
    feature row, and a scatter read-modify-write of the output row."""
    return CostModel(
        flops=2.0 * nnz * P,
        hbm_bytes=float(nnz * 12 + nnz * P * 4 + 2 * nnz * P * 4),
        note="xla-edges",
        flops_kind="f32_flops",
    )


def cost_for_prep(prep, P: int) -> CostModel:
    """Cost model for ``agg_matmul(prep, H)`` with feature width P."""
    if prep.kind == "dense":
        return cost_dense(prep.dense.shape[0], P, prep.dense.dtype.itemsize)
    return cost_xla_edges(prep.A.nnz, prep.A.n_rows, P)
