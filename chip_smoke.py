"""Smoke run of the main paths on one NVIDIA GPU, through compiled code only.

    python chip_smoke.py               # phases 1-5 on one card
    python chip_smoke.py --four-cards  # only the distributed phase, 4 cards

Phases (each prints its own lines; any failure exits non-zero):

1. setup: devices, device kind, the card's name and power limit.
2. GCN training: GCNModel at the OGB ogbn-products GCN baseline's widths
   (3 layers, hidden 256, 100 features, 47 classes) on a 2^20-node
   power-law graph (avg degree 16, degree-sorted), 5 steps through
   train_node_classifier with prepare="auto"; the loss must be finite and
   fall, and agg_matmul on the chosen backend must match scipy (float64).
3. GAT training: GATModel at Velickovic et al.'s widths (8 heads x 8
   hidden) on the same graph, 5 steps; one GATConv forward must match a
   numpy (float64) edge-softmax reference.
4. int8: freeze_gcn2 / int8_gcn2_forward at pubmed shape (19,717 nodes,
   500 features) against the float model, and the sparse int8 path against
   the dense one (both exact integer math).
5. --four-cards: one training step of the halo GCN and halo GAT layers on a
   4-device 1-D mesh over the 2^20 graph split with the LPT balance,
   compared with the same step on one device.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a GPU the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def log(*a):
    print(*a, flush=True)


def rel_err(out, ref) -> float:
    out = np.asarray(out, np.float64)
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30))


def check(name: str, ok: bool, detail: str) -> None:
    log(f"  check {name}: {'ok' if ok else 'FAILED'} ({detail})")
    if not ok:
        raise AssertionError(f"{name}: {detail}")


def peak_bytes(dev) -> int:
    stats = dev.memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", -1))


def powerlaw_graph(n: int, seed: int = 0):
    """The ogbn-products-shaped graph of phases 2-3, degree-sorted."""
    from sgracex1_tpu.graph.datasets import powerlaw_node_classification
    from sgracex1_tpu.graph.normalize import sym_norm
    from sgracex1_tpu.graph.reorder import degree_order, permute_node_data

    data = powerlaw_node_classification(
        n=n, avg_degree=16, num_features=100, num_classes=47, seed=seed
    )
    return permute_node_data(
        data, degree_order(sym_norm(data.edge_index, n))
    )


def train(model, data, steps: int, dev, name: str):
    from sgracex1_tpu.config import SGRACEConfig
    from sgracex1_tpu.train.loop import train_node_classifier

    cfg = SGRACEConfig(num_epochs=steps, learning_rate=0.01)
    t0 = time.perf_counter()
    _, hist = train_node_classifier(model, data, cfg, prepare="auto")
    total = time.perf_counter() - t0
    warm = np.asarray(hist.step_s[1:]) * 1e3
    log(
        f"  {name}: backend={hist.backend} run_s={total:.2f} "
        f"first_step_s={hist.step_s[0]:.2f} (compile+run) "
        f"step_ms median={np.median(warm):.3f} min={warm.min():.3f} "
        f"over {len(warm)} warm steps; peak_bytes_in_use={peak_bytes(dev)}"
    )
    log(f"  {name}: loss {' '.join(f'{l:.5f}' for l in hist.loss)}")
    check(f"{name} loss finite", bool(np.isfinite(hist.loss).all()),
          "all steps")
    check(f"{name} loss falls", hist.loss[-1] < hist.loss[0],
          f"{hist.loss[0]:.5f} -> {hist.loss[-1]:.5f}")
    return hist


def phase_gcn(n: int, steps: int, dev):
    import jax
    import jax.numpy as jnp

    from sgracex1_tpu.graph.normalize import sym_norm
    from sgracex1_tpu.nn.models import GCNModel
    from sgracex1_tpu.ops.dispatch import agg_matmul, prepare_adjacency

    log("phase gcn")
    t0 = time.perf_counter()
    data = powerlaw_graph(n)
    log(f"  graph: n={n} edges={data.edge_index.shape[1]} "
        f"setup_s={time.perf_counter() - t0:.2f}")
    model = GCNModel(
        num_features=100, hidden_channels=256, num_classes=47, num_layers=3
    )
    train(model, data, steps, dev, "gcn")

    # the backend the chooser picked, against scipy in float64
    A = sym_norm(data.edge_index, n)
    prep = prepare_adjacency(A.device(), method="auto")
    H = np.random.default_rng(1).standard_normal((n, 256)).astype(np.float32)
    out = jax.jit(agg_matmul)(prep, jnp.asarray(H))
    ref = A.to_scipy().astype(np.float64) @ H.astype(np.float64)
    # the edge path is an f32 gather + segment sum (no matmul, so no TF32):
    # only the summation order differs. A dense prep rounds A and H to bf16.
    tol = 1e-2 if prep.kind == "dense" else 1e-4
    check("gcn agg_matmul vs scipy", rel_err(out, ref) < tol,
          f"backend={prep.kind} max|err|/max|ref|={rel_err(out, ref):.2e} "
          f"< {tol:g}")
    return data


def gat_reference(A, x, W, att, heads: int, F: int, alpha: float = 0.2):
    """numpy float64 GATConv forward: per-head edge softmax over each row's
    edges with value > 0, then the weighted sum of neighbour features."""
    r = np.asarray(A.rows[: A.nnz]).astype(np.int64)
    c = np.asarray(A.cols[: A.nnz]).astype(np.int64)
    keep = np.asarray(A.vals[: A.nnz]) > 0
    r, c = r[keep], c[keep]
    order = np.argsort(r, kind="stable")
    r, c = r[order], c[order]
    starts = np.flatnonzero(np.r_[True, r[1:] != r[:-1]])
    rows_u = r[starts]
    Wh = (x.astype(np.float64) @ W.astype(np.float64)).reshape(-1, heads, F)
    a = att.astype(np.float64).reshape(-1)
    a_src = a[: heads * F].reshape(heads, F)
    a_dst = a[heads * F:].reshape(heads, F)
    s1 = np.einsum("nhf,hf->nh", Wh, a_src)
    s2 = np.einsum("nhf,hf->nh", Wh, a_dst)
    out = np.zeros((x.shape[0], heads, F))
    for h in range(heads):
        e = s1[r, h] + s2[c, h]
        e = np.where(e > 0, e, alpha * e)
        m = np.maximum.reduceat(e, starts)
        ex = np.exp(e - np.repeat(m, np.diff(np.r_[starts, len(e)])))
        den = np.add.reduceat(ex, starts)
        p = ex / np.repeat(den, np.diff(np.r_[starts, len(e)]))
        out[rows_u, h] = np.add.reduceat(p[:, None] * Wh[c, h], starts)
    return out.reshape(x.shape[0], heads * F)


def phase_gat(data, steps: int, dev):
    import jax
    import jax.numpy as jnp

    from sgracex1_tpu.graph.normalize import sym_norm
    from sgracex1_tpu.nn.layers import GATConv
    from sgracex1_tpu.nn.models import GATModel

    log("phase gat")
    heads, F = 8, 8
    model = GATModel(
        num_features=100, hidden_channels=F, num_classes=47, nheads=heads
    )
    train(model, data, steps, dev, "gat")

    n = data.num_nodes
    A = sym_norm(data.edge_index, n)
    Ad = A.device()
    x = jnp.asarray(data.x)
    conv = GATConv(100, F, nheads=heads)
    params = conv.init(jax.random.PRNGKey(2), Ad, x)
    ref = gat_reference(
        A, data.x, np.asarray(params["params"]["weight"]),
        np.asarray(params["params"]["attention"]), heads, F,
    )
    fwd = jax.jit(conv.apply)
    # default precision: X @ W runs in TF32 (~5e-4 relative per entry),
    # which the softmax's exponent can amplify a few-fold
    err = rel_err(fwd(params, Ad, x), ref)
    check("GATConv fwd vs numpy (TF32 X@W)", err < 1e-2,
          f"max|err|/max|ref|={err:.2e} < 1e-2")
    with jax.default_matmul_precision("highest"):
        err = rel_err(jax.jit(conv.apply)(params, Ad, x), ref)
    check("GATConv fwd vs numpy (f32 X@W)", err < 1e-4,
          f"max|err|/max|ref|={err:.2e} < 1e-4")


def phase_int8(n: int, dev):
    import jax
    import jax.numpy as jnp

    from sgracex1_tpu.graph.normalize import sym_norm
    from sgracex1_tpu.quant import int8 as qi8
    from sgracex1_tpu.quant.calibration import CalibrationTable

    log("phase int8")
    f, h, p = 500, 16, 3
    rng = np.random.default_rng(4)
    # a uniform random graph with pubmed's mean degree (88,648 directed
    # edges at 19,717 nodes). On a power-law graph the per-tensor hidden
    # grid's step is set by the hubs, and most activations round to 0
    pairs = rng.integers(0, n, (2, int(n * 88648 / 19717) // 2))
    k = np.unique(np.concatenate([pairs[0] * n + pairs[1],
                                  pairs[1] * n + pairs[0]]))
    A = sym_norm(np.stack([k // n, k % n]), n)
    mat = A.to_scipy().astype(np.float64)
    X = rng.uniform(0, 1, (n, f)).astype(np.float32)
    W1 = rng.uniform(-0.1, 0.1, (f, h)).astype(np.float32)
    W2 = rng.uniform(-0.5, 0.5, (h, p)).astype(np.float32)
    h1 = np.maximum(mat @ (X @ W1.astype(np.float64)), 0.0)
    ref = mat @ (h1 @ W2)
    amax = qi8.collect_amax_gcn2_sparse(A, X, W1, W2)
    cal = CalibrationTable.for_qbits(
        8,
        dict(w_min=-0.1, w_max=0.1, w_min2=-0.5, w_max2=0.5,
             f_min=0.0, f_max=1.0, a_min=0.0,
             a_max=float(mat.max()) or 1.0),
    )
    xs = qi8.quantize_unsigned_shifted(jnp.asarray(X), cal.features)
    t0 = time.perf_counter()
    net = qi8.freeze_gcn2(
        W1, W2, mat.astype(np.float32).toarray(), cal, **amax
    )
    fwd = jax.jit(qi8.int8_gcn2_forward)
    dense_out = np.asarray(jax.block_until_ready(fwd(net, xs)))
    log(f"  dense int8 2-layer GCN: first call {time.perf_counter() - t0:.2f}s "
        f"(freeze+compile+run)")
    err = rel_err(dense_out, ref)
    check("int8 GCN2 (dense int8 dot) vs float64", err < 0.08,
          f"max|err|/max|ref|={err:.3f} < 0.08 (8-bit grids)")
    net_s = qi8.freeze_gcn2_sparse(W1, W2, A.device(), cal, **amax)
    sparse_out = np.asarray(jax.jit(qi8.int8_gcn2_sparse_forward)(net_s, xs))
    check("int8 GCN2 sparse == dense", np.array_equal(sparse_out, dense_out),
          "exact int32 edge sum vs int8 dot")
    log(f"  peak_bytes_in_use={peak_bytes(dev)}")


def phase_four_cards(n: int, dev):
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from sgracex1_tpu.graph.datasets import powerlaw_node_classification
    from sgracex1_tpu.graph.normalize import sym_norm
    from sgracex1_tpu.graph.reorder import degree_balanced_order, permute_graph
    from sgracex1_tpu.graph.reorder import shard_edge_counts
    from sgracex1_tpu.parallel.halo import (
        build_halo,
        dist_gat_layer_halo,
        dist_gnn_layer_halo,
    )
    from sgracex1_tpu.parallel.mesh import make_mesh
    from sgracex1_tpu.parallel.partition import pad_nodes
    from sgracex1_tpu.utils.profiling import time_call

    log("phase four-cards")
    S = 4
    if len(jax.devices()) < S:
        raise RuntimeError(f"needs {S} devices, found {len(jax.devices())}")
    data = powerlaw_node_classification(
        n=n, avg_degree=16, num_features=100, num_classes=47, seed=0
    )
    A = sym_norm(data.edge_index, n)
    perm = degree_balanced_order(A, S)
    A, _ = permute_graph(A, perm)
    counts = shard_edge_counts(A, S)
    log(f"  LPT shard edges {counts.tolist()} "
        f"(max/mean {counts.max() / counts.mean():.3f})")
    x_np, y_np = data.x[perm], data.y[perm].astype(np.int32)
    m_np = data.train_mask[perm].astype(np.float32)

    rng = np.random.default_rng(0)

    def w(*shape, scale=0.1):
        return jnp.asarray(rng.standard_normal(shape).astype(np.float32) * scale)

    params = dict(
        W1=w(100, 256), W2=w(256, 256), Wo=w(256, 47),
        G1=w(100, 64), a1=w(128, 1), G2=w(64, 8), a2=w(16, 1), Go=w(8, 47),
    )
    opt = optax.adam(0.01)

    def make_step(n_dev):
        mesh = make_mesh(n_dev)
        G, n_pad = build_halo(A, n_dev)
        sh = NamedSharding(mesh, P("graph"))
        data = (jax.device_put(G, sh),) + tuple(
            jax.device_put(pad_nodes(a, n_pad), sh) for a in (x_np, y_np, m_np)
        )

        def loss_fn(p, G, x, y, m):
            def xent(logits):
                ls = optax.softmax_cross_entropy_with_integer_labels(
                    logits, y
                )
                return jnp.sum(ls * m) / jnp.sum(m)

            h = dist_gnn_layer_halo(mesh, G, x, p["W1"], relu=True)
            h = dist_gnn_layer_halo(mesh, G, h, p["W2"])
            gcn = xent(h @ p["Wo"])
            g = dist_gat_layer_halo(mesh, G, x, p["G1"], p["a1"],
                                    relu=True, nheads=8)
            g = dist_gat_layer_halo(mesh, G, g, p["G2"], p["a2"])
            return gcn + xent(g @ p["Go"]), gcn

        # the graph and node arrays are arguments: captured, they would be
        # folded into the program as constants
        @jax.jit
        def step(p, s, G, x, y, m):
            (loss, gcn), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                p, G, x, y, m
            )
            upd, s = opt.update(grads, s)
            return optax.apply_updates(p, upd), s, loss, gcn, grads

        return lambda p, s: step(p, s, *data)

    results = {}
    for n_dev in (S, 1):
        step = make_step(n_dev)
        s0 = opt.init(params)
        t0 = time.perf_counter()
        out = jax.block_until_ready(step(params, s0))
        first = time.perf_counter() - t0
        ts = time_call(step, params, s0, reps=5, warmup=1) * 1e3
        log(f"  {n_dev} device(s): loss={float(out[2]):.6f} "
            f"(gcn {float(out[3]):.6f}) first_call_s={first:.2f} "
            f"step_ms median={np.median(ts):.2f} min={ts.min():.2f} "
            f"over {len(ts)}")
        results[n_dev] = jax.device_get(out)
    (_, _, l4, _, g4), (_, _, l1, _, g1) = results[S], results[1]
    err_l = abs(float(l4) - float(l1)) / abs(float(l1))
    check("loss 4 devices vs 1", err_l < 1e-4, f"rel err {err_l:.2e} < 1e-4")
    err_g = max(rel_err(g4[k], np.asarray(g1[k], np.float64)) for k in g1)
    check("grads 4 devices vs 1", err_g < 1e-3,
          f"max over params of max|err|/max|ref| = {err_g:.2e} < 1e-3")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-device distributed phase")
    args = ap.parse_args(argv)

    import jax

    from sgracex1_tpu.platform import on_gpu
    from sgracex1_tpu.utils.compcache import enable_persistent_cache

    enable_persistent_cache()  # before the first compile
    dev = jax.devices()[0]
    if not on_gpu():
        print(f"no GPU: JAX's first device is {dev.platform!r}",
              file=sys.stderr)
        return 2

    log("phase setup")
    log(f"  devices: {jax.devices()}")
    log(f"  device_kind: {dev.device_kind}")
    from sgracex1_tpu.utils.power import nvidia_smi

    log(nvidia_smi("name,power.limit"))
    if args.four_cards:
        phase_four_cards(1 << 20, dev)
    else:
        data = phase_gcn(1 << 20, 5, dev)
        phase_gat(data, 5, dev)
        del data
        phase_int8(19717, dev)
    log(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
