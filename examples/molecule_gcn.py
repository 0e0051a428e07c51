"""MUTAG molecule graph classification — the reference's accuracy anchor.

Reproduces the Graph_Classification notebook experiment
(jupyter/molecule_gcn/Graph_Classification.ipynb, cells 4-20): 188 MUTAG
graphs, 150/38 split, 2-layer GCN (raw block-diagonal adjacency — the
notebook's GraphConvolution_pynq computes plain ``A @ X @ W`` with no
normalization or self-loops), hidden 64, global mean pool, dropout 0.5,
Adam lr=0.01, full-batch (the notebook's batch_size=256 covers all 150
training graphs). Target: >= 0.76 test accuracy (README.md:127-129 reports
0.76 around epoch 36 on the FPGA; this run typically exceeds it
within ~10 epochs).

Usage: python examples/molecule_gcn.py [--data-root PATH] [--seed N]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from sgracex1_tpu.config import SGRACEConfig
from sgracex1_tpu.graph.batch import batch_graphs
from sgracex1_tpu.graph.datasets import load_tu_dataset
from sgracex1_tpu.nn.models import MoleculeGCN
from sgracex1_tpu.train.loop import train_graph_classifier

DEFAULT_ROOTS = [
    os.environ.get("MUTAG_ROOT"),
    "/root/reference/jupyter/molecule_gcn",
]


def full_batch(graphs, pad_to=128):
    n = sum(g.num_nodes for g in graphs)
    n_pad = ((n + pad_to - 1) // pad_to) * pad_to
    return [
        batch_graphs(
            graphs, n_pad=n_pad, g_pad=len(graphs) + 1, normalize=False
        )
    ]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--epochs", type=int, default=50)
    args = ap.parse_args()

    root = args.data_root or next(
        (r for r in DEFAULT_ROOTS if r and os.path.isdir(r)), None
    )
    if root is None:
        sys.exit("MUTAG data not found; pass --data-root or set MUTAG_ROOT")

    graphs = load_tu_dataset(root, "MUTAG")
    print(f"{len(graphs)} graphs, {graphs[0].x.shape[1]} features")

    rng = np.random.default_rng(args.seed)
    idx = rng.permutation(len(graphs))
    train = [graphs[i] for i in idx[:150]]
    test = [graphs[i] for i in idx[150:]]

    cfg = SGRACEConfig(num_epochs=args.epochs, learning_rate=0.01)
    model = MoleculeGCN(num_features=7, hidden_channels=64, num_classes=2)
    _, hist = train_graph_classifier(
        model, full_batch(train), full_batch(test), cfg, log_every=10
    )
    first = next(
        (i + 1 for i, a in enumerate(hist.test_acc) if a >= 0.76), None
    )
    print(
        f"best test acc {hist.best_test_acc:.4f} "
        f"(anchor 0.76 first hit at epoch {first})"
    )


if __name__ == "__main__":
    main()
