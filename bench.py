"""Benchmark of the main paths on one GPU — one JSON line on stdout.

Phases, each timed with the host clock around ``block_until_ready``
(median of 20 warm calls, the first calls compile):

1. Citeseer 1-layer GNN forward ``D = A @ (X @ W)`` — the reference's one
   recorded hardware perf probe (4.65 ms on the RFSoC FPGA, 1 FEA-thread /
   1 ADJ-thread / 2 CUs, fp16 — jupyter/test/mmult-master.ipynb cell 34; see
   BASELINE.md). Reported as the headline ``value``/``vs_baseline``.
2. Pubmed GAT attention aggregation on the edge path (the gat_mode
   accelerator call, sgrace.py:498-539), 1 and 4 heads.
3. A 2^20-node power-law graph (avg_degree 16) aggregated on the
   cost-model-chosen backend, P=128, bf16 and f32 features.
4. int8: pubmed full-integer 2-layer GCN forward and int8 GAT layer.

Prints the device it ran on; refuses to run without a GPU, since a CPU
time is not a device metric. Usage: ``python bench.py``.
"""

from __future__ import annotations

import json
import sys

import numpy as np

BASELINE_MS = 4.65  # FPGA citeseer 1t1t2c (BASELINE.md)
CITESEER = dict(N=3327, M=3703, P=32, NNZ_ADJ=12431, NNZ_FEA=105165)
PUBMED = dict(N=19717, M=500, NNZ_ADJ=88651)

RESULT: dict = {}
EXTRA: dict = {}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def median_ms(fn, *args) -> float:
    from sgracex1_tpu.utils.profiling import time_call

    return float(np.median(time_call(fn, *args)) * 1e3)


def load_citeseer():
    from sgracex1_tpu.graph import io

    if io.reference_data_dir() is not None:
        adj, fea, w = io.load_reference_dataset("citeseer")
        return adj, np.asarray(fea.to_dense()), w
    # synthetic with identical dims/sparsity if reference data not mounted
    from sgracex1_tpu.graph.csr import SparseMatrix

    rng = np.random.default_rng(0)
    c = CITESEER
    r = rng.integers(0, c["N"], c["NNZ_ADJ"])
    cl = rng.integers(0, c["N"], c["NNZ_ADJ"])
    adj = SparseMatrix.from_coo(
        r, cl, rng.random(c["NNZ_ADJ"]).astype(np.float32), (c["N"], c["N"])
    )
    X = np.zeros((c["N"], c["M"]), np.float32)
    X[rng.integers(0, c["N"], c["NNZ_FEA"]),
      rng.integers(0, c["M"], c["NNZ_FEA"])] = 1.0
    w = rng.standard_normal((c["M"], c["P"])).astype(np.float32) * 0.1
    return adj, X, w


def load_pubmed_adj():
    from sgracex1_tpu.graph import io

    if io.reference_data_dir() is not None:
        adj, _, _ = io.load_reference_dataset("pubmed")
        return adj
    from sgracex1_tpu.graph.csr import SparseMatrix

    rng = np.random.default_rng(1)
    p = PUBMED
    r = rng.integers(0, p["N"], p["NNZ_ADJ"])
    c = rng.integers(0, p["N"], p["NNZ_ADJ"])
    return SparseMatrix.from_coo(
        r, c, rng.random(p["NNZ_ADJ"]).astype(np.float32) + 0.1,
        (p["N"], p["N"]),
    )


def phase_citeseer():
    import jax
    import jax.numpy as jnp

    from sgracex1_tpu.ops.dispatch import agg_matmul, prepare_adjacency

    adj, X, w = load_citeseer()
    prep = prepare_adjacency(adj.device(), method="auto")
    X = jax.device_put(X)
    W = jax.device_put(w.astype(np.float32))

    @jax.jit
    def layer(prep, X, W):
        return agg_matmul(prep, jnp.dot(X, W, preferred_element_type=jnp.float32))

    ms = median_ms(layer, prep, X, W)
    log(f"citeseer layer fwd ({prep.kind}): {ms:.4f} ms")
    RESULT.update(
        metric="citeseer_layer_fwd_ms", value=ms, unit="ms",
        vs_baseline=BASELINE_MS / ms,
    )
    EXTRA["citeseer_backend"] = prep.kind


def phase_pubmed_gat():
    import jax
    import jax.numpy as jnp

    from sgracex1_tpu.ops.sddmm import gat_attention_agg_ref

    adj = load_pubmed_adj().device()
    rng = np.random.default_rng(0)
    for H, F in ((1, 32), (4, 32)):
        s1 = jnp.asarray(rng.standard_normal((adj.n_rows, H)), jnp.float32)
        s2 = jnp.asarray(rng.standard_normal((adj.n_rows, H)), jnp.float32)
        wh = jnp.asarray(rng.standard_normal((adj.n_rows, H, F)), jnp.float32)
        ms = median_ms(jax.jit(gat_attention_agg_ref), adj, s1, s2, wh)
        log(f"pubmed GAT agg fwd H={H} F={F}: {ms:.4f} ms")
        EXTRA[f"pubmed_gat_h{H}_ms"] = ms


def phase_powerlaw_1m():
    import jax
    import jax.numpy as jnp

    from sgracex1_tpu.graph.datasets import powerlaw_node_classification
    from sgracex1_tpu.graph.normalize import sym_norm
    from sgracex1_tpu.graph.reorder import degree_order, permute_graph
    from sgracex1_tpu.ops.dispatch import agg_matmul, prepare_adjacency

    n = 1 << 20
    data = powerlaw_node_classification(n=n, avg_degree=16, num_features=8)
    A = sym_norm(data.edge_index, data.num_nodes)
    A, _ = permute_graph(A, degree_order(A))
    prep = prepare_adjacency(A.device(), method="auto")
    key = jax.random.PRNGKey(0)
    agg = jax.jit(agg_matmul)
    for dt in (jnp.bfloat16, jnp.float32):
        H = jax.random.normal(key, (A.n_cols, 128), dt)
        ms = median_ms(agg, prep, H)
        name = jnp.dtype(dt).name
        log(f"powerlaw 2^20 agg ({prep.kind}, {name}): {ms:.3f} ms "
            f"({A.nnz / ms / 1e3:.0f} M edges/s)")
        EXTRA[f"powerlaw_1m_agg_{name}_ms"] = ms
    EXTRA["powerlaw_1m_nnz"] = int(A.nnz)
    EXTRA["powerlaw_1m_backend"] = prep.kind


def phase_int8():
    import jax
    import jax.numpy as jnp

    from sgracex1_tpu.quant import int8 as qi8
    from sgracex1_tpu.quant.calibration import CalibrationTable

    adj = load_pubmed_adj()
    rng = np.random.default_rng(0)
    N, F_in, h1, p = adj.n_rows, 64, 32, 16
    X = rng.uniform(0, 1, (N, F_in)).astype(np.float32)
    W1 = rng.uniform(-0.5, 0.5, (F_in, h1)).astype(np.float32)
    W2 = rng.uniform(-0.5, 0.5, (h1, p)).astype(np.float32)
    amax = qi8.collect_amax_gcn2_sparse(adj, X, W1, W2)
    cal = CalibrationTable.for_qbits(
        8,
        dict(w_min=-0.5, w_max=0.5, w_min2=-0.5, w_max2=0.5,
             f_min=0.0, f_max=1.0, a_min=0.0,
             a_max=float(np.asarray(adj.vals).max()) or 1.0),
    )
    net = qi8.freeze_gcn2_sparse(W1, W2, adj.device(), cal, **amax)
    xs = qi8.quantize_unsigned_shifted(jnp.asarray(X), cal.features)
    ms = median_ms(jax.jit(qi8.int8_gcn2_sparse_forward), net, xs)
    log(f"pubmed full-integer 2-layer GCN fwd: {ms:.4f} ms")
    EXTRA["int8_pubmed_gcn2_ms"] = ms

    att = rng.uniform(-0.5, 0.5, (2 * h1, 1)).astype(np.float32)
    layer = qi8.freeze_gat_layer(
        W1, att, cal.features, cal.weights, h_absmax=8.0
    )
    A = adj.device()
    gat = jax.jit(
        lambda layer, A, xs: qi8.int8_gat_layer(
            layer, A.rows, A.cols, A.vals > 0, A.n_rows, xs
        )[0]
    )
    ms = median_ms(gat, layer, A, xs)
    log(f"pubmed int8 GAT layer fwd: {ms:.4f} ms")
    EXTRA["int8_pubmed_gat_ms"] = ms


def main() -> int:
    import jax

    from sgracex1_tpu.platform import on_gpu
    from sgracex1_tpu.utils.compcache import enable_persistent_cache
    from sgracex1_tpu.utils.power import nvidia_smi

    enable_persistent_cache()
    dev = jax.devices()[0]
    log("devices:", jax.devices())
    if not on_gpu():
        log(f"no GPU (platform {dev.platform!r}): nothing to measure")
        return 1
    EXTRA["device"] = dict(
        platform=dev.platform, kind=dev.device_kind, count=len(jax.devices()),
        nvidia_smi=nvidia_smi("name,power.limit"),
    )
    log(EXTRA["device"]["nvidia_smi"])
    for fn in (phase_citeseer, phase_pubmed_gat, phase_powerlaw_1m,
               phase_int8):
        fn()
    RESULT["extra"] = EXTRA
    print(json.dumps(RESULT))
    return 0


if __name__ == "__main__":
    sys.exit(main())
