"""Power recording (DataRecorder analogue, demo_sgrace.py:158-168) and the
interconnect comm-volume scaling model (BASELINE.md scaling target)."""

import time

import numpy as np
import pytest

from sgracex1_tpu.parallel.comm_model import (
    CommCost,
    allgather_comm,
    halo_comm,
    predicted_efficiency,
    scaling_table,
)
from sgracex1_tpu.utils.power import (
    PowerRecorder,
    energy_estimate,
    energy_for_cost,
)
from sgracex1_tpu.utils.roofline import cost_dense


class TestPowerRecorder:
    def test_record_integrates_constant_load(self):
        rec = PowerRecorder(lambda: 100.0)
        with rec.record(0.01):
            time.sleep(0.12)
        assert rec.duration_s >= 0.1
        assert rec.mean_w == pytest.approx(100.0)
        # constant 100 W for duration d -> 100*d joules
        assert rec.energy_j == pytest.approx(100.0 * rec.duration_s, rel=0.02)
        assert len(rec.frame) >= 5

    def test_sensor_glitches_skipped(self):
        calls = [0]

        def flaky():
            calls[0] += 1
            if calls[0] % 2:
                raise OSError("sensor")
            return 50.0

        rec = PowerRecorder(flaky)
        with rec.record(0.01):
            time.sleep(0.06)
        assert rec.mean_w == pytest.approx(50.0)
        assert rec.energy_j > 0

    def test_reusable_across_records(self):
        rec = PowerRecorder(lambda: 10.0)
        with rec.record(0.01):
            time.sleep(0.03)
        first = rec.energy_j
        with rec.record(0.01):
            time.sleep(0.03)
        assert rec.energy_j > 0 and first > 0  # frame reset, both valid


class TestEnergyModel:
    def test_idle_and_busy_endpoints(self):
        idle = energy_estimate(1.0, 0.0, idle_w=60, busy_w=200)
        busy = energy_estimate(1.0, 1.0, idle_w=60, busy_w=200)
        assert idle["joules"] == pytest.approx(60.0)
        assert busy["joules"] == pytest.approx(200.0)
        half = energy_estimate(2.0, 0.5, idle_w=60, busy_w=200)
        assert half["joules"] == pytest.approx(130.0 * 2)

    def test_utilization_clamped(self):
        env = dict(idle_w=60, busy_w=200)
        assert energy_estimate(1.0, 7.5, **env)["utilization"] == 1.0
        assert energy_estimate(1.0, -1.0, **env)["utilization"] == 0.0

    def test_energy_for_cost_uses_roofline_bound(self):
        c = cost_dense(4096, 128)
        out = energy_for_cost(
            c, sec=1e-3, idle_w=70, busy_w=400,
            device_kind="NVIDIA H100 80GB HBM3",
        )
        assert out["bound"] in ("memory", "compute")
        assert 0 < out["joules"] < 1.0  # sub-second kernel, sub-joule

    def test_envelope_is_required(self):
        with pytest.raises(TypeError):
            energy_estimate(1.0, 0.5)

    def test_nvidia_smi_power_sampler(self, monkeypatch):
        import subprocess

        from sgracex1_tpu.utils import power

        calls = []

        def fake_run(cmd, **kw):
            calls.append(cmd)
            return subprocess.CompletedProcess(cmd, 0, stdout="123.45 W\n")

        monkeypatch.setattr(power.subprocess, "run", fake_run)
        sample = power.nvidia_smi_power(2)
        assert sample() == pytest.approx(123.45)
        assert calls[0][:2] == ["nvidia-smi", "--query-gpu=power.draw"]
        assert calls[0][-2:] == ["-i", "2"]
        rec = PowerRecorder(sample)
        with rec.record(0.01):
            time.sleep(0.03)
        assert rec.mean_w == pytest.approx(123.45)


class TestCommModel:
    def test_halo_volume_counts_only_cross_device_rows(self):
        from sgracex1_tpu.graph.datasets import sbm_node_classification
        from sgracex1_tpu.graph.normalize import sym_norm
        from sgracex1_tpu.parallel.halo import build_halo

        data = sbm_node_classification(n=256, seed=0)
        A = sym_norm(data.edge_index, data.num_nodes)
        G, _ = build_halo(A, 4)
        c = halo_comm(G, F=32)
        assert c.bytes_out == (4 - 1) * G.halo_len * 32 * 4
        assert halo_comm(G, F=32, backward=True).bytes_out == 2 * c.bytes_out

    def test_allgather_dominates_halo_on_sparse_boundaries(self):
        # all-gather ships every row; halo ships only boundary rows -- for a
        # partition with index locality (ring lattice, k=4 forward
        # neighbors) the halo plan must move far less
        from sgracex1_tpu.graph.normalize import sym_norm
        from sgracex1_tpu.parallel.halo import build_halo

        n, k = 2048, 4
        src = np.repeat(np.arange(n), k)
        dst = (src + np.tile(np.arange(1, k + 1), n)) % n
        edge_index = np.stack([src, dst])
        A = sym_norm(edge_index, n)
        G, n_pad = build_halo(A, 8)
        h = halo_comm(G, F=64)
        g = allgather_comm(n_pad, F=64, S=8)
        assert h.bytes_out < g.bytes_out

    def test_efficiency_monotone_in_comm(self):
        small = predicted_efficiency(1e-3, 8, CommCost(1e3))
        big = predicted_efficiency(1e-3, 8, CommCost(1e7))
        assert small["efficiency"] > big["efficiency"]
        assert small["efficiency"] <= 1.0

    def test_overlap_recovers_efficiency(self):
        c = CommCost(1e6)
        none = predicted_efficiency(1e-3, 8, c, overlap=0.0)
        full = predicted_efficiency(1e-3, 8, c, overlap=1.0)
        assert full["efficiency"] == pytest.approx(1.0)
        assert none["efficiency"] < 1.0

    def test_link_bandwidth_is_nvlink_each_way(self):
        from sgracex1_tpu.parallel.comm_model import link_bytes_s

        assert link_bytes_s() == 450e9
        assert CommCost(450e9).seconds() == pytest.approx(1.0)
        with pytest.raises(KeyError):
            link_bytes_s("AMD Instinct MI300X")

    def test_scaling_table_shape(self):
        tbl = scaling_table(1e-3, {2: CommCost(1e5), 8: CommCost(4e5)})
        assert set(tbl) == {2, 8}
        assert all("efficiency" in v for v in tbl.values())
