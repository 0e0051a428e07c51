"""End-to-end quantization pipeline: float train -> amax calibration ->
QAT fine-tune -> full-integer int8 freeze.

This is the workflow the reference spreads across demo_sgrace.py (float /
fake-quant training), init_SGRACE's hand calibration tables, and the demo
bitstream's integer datapath — here it is one script:

1. train a float 2-layer GCN;
2. calibrate quantization constants from the trained model's observed
   activation ranges (the max_fea telemetry analogue);
3. fine-tune with fake-quant QAT at the chosen bit width;
4. freeze to the full-integer int8 inference form (both matmuls int8 on
   XLA's int8 dot) and compare accuracy float vs QAT vs int8.

Usage: python examples/quantization_pipeline.py [--qbits 8|4|2|1]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp

from sgracex1_tpu.config import SGRACEConfig
from sgracex1_tpu.graph.datasets import sbm_node_classification
from sgracex1_tpu.graph.normalize import sym_norm
from sgracex1_tpu.nn.models import GCNModel
from sgracex1_tpu.quant import int8 as qi8
from sgracex1_tpu.quant.autocal import calibrate
from sgracex1_tpu.train.loop import train_node_classifier


def accuracy(logits, y, mask):
    pred = np.argmax(np.asarray(logits), -1)
    return float(((pred == y) * mask).sum() / mask.sum())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--qbits", type=int, default=8, choices=[1, 2, 4, 8])
    ap.add_argument("--epochs", type=int, default=60)
    args = ap.parse_args()

    data = sbm_node_classification(n=600, num_classes=4, seed=0)
    A = sym_norm(data.edge_index, data.num_nodes)
    x = jnp.asarray(data.x)
    kw = dict(
        num_features=data.num_features,
        hidden_channels=32,
        num_classes=data.num_classes,
    )

    # 1. float training
    cfg = SGRACEConfig(num_epochs=args.epochs, learning_rate=0.01)
    model_f = GCNModel(**kw)
    state_f, hist_f = train_node_classifier(model_f, data, cfg)
    print(f"float best test acc:  {hist_f.best_test_acc:.4f}")

    # 2. calibration from the trained model's activation ranges
    params_f = {"params": hist_f.best_params["params"]}
    cal = calibrate(model_f, params_f, A, x, qbits=args.qbits)
    print(
        f"calibrated ({args.qbits}-bit): f_max={cal.raw['f_max']:.3f} "
        f"w_max={cal.raw['w_max']:.3f} w_max2={cal.raw['w_max2']:.3f}"
    )

    # 3. QAT fine-tune at the target bit width
    cfg_q = SGRACEConfig(num_epochs=args.epochs, w_qbits=args.qbits)
    model_q = GCNModel(**kw, calibration=cal)
    state_q, hist_q = train_node_classifier(model_q, data, cfg_q)
    print(f"QAT  best test acc:   {hist_q.best_test_acc:.4f}")

    # 4. int8 freeze (8-bit integer pipeline regardless of QAT width —
    #    the int grids of <8-bit models embed into int8 exactly)
    p = hist_q.best_params["params"]
    W1 = np.asarray(p["conv1"]["weight"])
    W2 = np.asarray(p["conv2"]["weight"])
    A_dense = A.to_dense().astype(np.float32)
    X_np = np.asarray(x)
    am = qi8.collect_amax_gcn2(A_dense, X_np, W1, W2)
    net = qi8.freeze_gcn2(W1, W2, A_dense, cal, **am)
    xs = qi8.quantize_unsigned_shifted(x, cal.features)
    hidden = jax.jit(qi8.int8_gcn2_forward)(net, xs)
    # classification head stays float (the reference's Linear head is host
    # torch as well, demo_sgrace.py:386-388)
    head_k = [k for k in p if k.startswith("Dense")][0]
    logits = (
        np.asarray(hidden) @ np.asarray(p[head_k]["kernel"])
        + np.asarray(p[head_k]["bias"])
    )
    acc = accuracy(logits, data.y, data.test_mask)
    print(f"int8 frozen test acc: {acc:.4f}")

    # 5. the same freeze on the SPARSE adjacency (no dense N x N — the form
    #    that runs at pubmed/1M scale): exact int32 edge-path aggregation
    net_s = qi8.freeze_gcn2_sparse(W1, W2, A, cal, **am)
    hidden_s = jax.jit(qi8.int8_gcn2_sparse_forward)(net_s, xs)
    logits_s = (
        np.asarray(hidden_s)[: data.num_nodes]
        @ np.asarray(p[head_k]["kernel"])
        + np.asarray(p[head_k]["bias"])
    )
    acc_s = accuracy(logits_s, data.y, data.test_mask)
    print(f"int8 sparse-tile test acc: {acc_s:.4f} (== dense to 1e-5)")


if __name__ == "__main__":
    main()
