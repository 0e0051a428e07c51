"""Roofline cost models and the device peaks table (utils/roofline.py) —
the analogue of the reference's FIFO stall-counter decode
(mmult-master.ipynb cells 39-40)."""

import numpy as np
import pytest
import scipy.sparse as sp

from sgracex1_tpu.graph.csr import SparseMatrix
from sgracex1_tpu.ops.dispatch import prepare_adjacency
from sgracex1_tpu.utils.roofline import (
    PEAKS,
    CostModel,
    cost_for_prep,
    device_peaks,
)

H100 = "NVIDIA H100 80GB HBM3"


def _adj(n=600, density=0.02):
    mat = sp.random(n, n, density=density, format="csr",
                    random_state=3).astype(np.float32)
    mat.setdiag(1.0)
    return SparseMatrix.from_scipy(mat)


def test_roofline_report_fields_and_bound():
    c = CostModel(flops=1e15, hbm_bytes=1e9)
    r = c.roofline(1.0, device_kind=H100)
    # 1 PF/s of 989 TF/s bf16 peak -> compute-bound, ~101%
    assert r["bound"] == "compute"
    assert r["pct_compute"] == pytest.approx(100.0 * 1e15 / 989e12)
    assert r["pct_roofline"] == r["pct_compute"]
    c2 = CostModel(flops=1e9, hbm_bytes=1e12)
    r2 = c2.roofline(1.0, device_kind=H100)
    assert r2["bound"] == "memory"
    assert r2["pct_memory"] == pytest.approx(100.0 / 3.35)


def test_cost_models_per_backend():
    A = _adj()
    P = 32
    for method in ("dense", "xla"):
        prep = prepare_adjacency(A, method=method)
        c = cost_for_prep(prep, P)
        assert c.flops > 0 and c.hbm_bytes > 0, method
        assert method in c.note or c.note == "xla-edges", (method, c.note)
    # xla edge path FLOPs = 2*nnz*P exactly, held to the f32 peak
    cx = cost_for_prep(prepare_adjacency(A, method="xla"), P)
    assert cx.flops == 2 * A.nnz * P
    assert cx.flops_kind == "f32_flops"
    # dense pays O(n^2) bytes: far more than the edge path on a sparse graph
    cd = cost_for_prep(prepare_adjacency(A, method="dense"), P)
    assert cd.hbm_bytes > 600 * 600 * 2 and cd.flops_kind == "bf16_flops"


@pytest.mark.parametrize(
    "key", ["bf16_flops", "tf32_flops", "f32_flops", "int8_ops",
            "hbm_bytes", "nvlink_each_way"],
)
def test_peaks_table_has_published_h100_rates(key):
    peaks = device_peaks(H100)
    assert peaks is PEAKS[H100]
    assert peaks[key] > 0
    assert "data sheet" in peaks["source"]


@pytest.mark.parametrize("kind", ["cpu", "AMD Instinct MI300X", "NVIDIA A100-SXM4-80GB"])
def test_unknown_device_raises(kind):
    with pytest.raises(KeyError, match="no published peaks"):
        device_peaks(kind)
    with pytest.raises(KeyError):
        CostModel(1.0, 1.0).roofline(1.0, device_kind=kind)


def test_cost_model_sum_keeps_parts():
    a = CostModel(1.0, 2.0, "a")
    b = CostModel(3.0, 4.0, "b")
    s = a + b
    assert (s.flops, s.hbm_bytes, s.note) == (4.0, 6.0, "a+b")
