"""Model families from the reference.

- ``GATModel`` / ``GCNModel``: the 2-layer node-classification network of
  ``GAT_PYNQ`` (``demo/emulation/demo_sgrace.py:271-399``): conv1 with fused
  relu, conv2 without, dropout(0.5), Linear head. Layer 1 consumes (possibly
  sparse-on-host) input features, layer 2 dense hidden features — the
  reference's per-layer ``dense=0/1`` execution modes collapse here, where
  the dense feature matmul is the fast path for both.
- ``MoleculeGCN``: the molecule graph-classification network of the
  Graph_Classification notebook (``jupyter/molecule_gcn``, cells 14-20):
  2x GCNConv + global mean pool over the graph batch + dropout + Linear.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from sgracex1_tpu.graph.csr import SparseMatrix
from sgracex1_tpu.nn.layers import GCNConv, GATConv
from sgracex1_tpu.nn.module import Dense, Dropout, Module, remat as _remat
from sgracex1_tpu.quant.calibration import CalibrationTable


def _conv_apply(remat: bool, relu: bool):
    """Returns fn(conv_module, A, x) applying the conv, optionally under
    jax.checkpoint (nn.module.remat). relu is closed over — it cannot be a
    traced argument of the checkpointed function."""
    fn = lambda conv, A, x: conv(A, x, relu=relu)
    return _remat(fn) if remat else fn


def global_mean_pool(x: jax.Array, graph_ids: jax.Array, num_graphs: int):
    """Mean of node embeddings per graph (PyG global_mean_pool equivalent)."""
    sums = jax.ops.segment_sum(x, graph_ids, num_segments=num_graphs)
    counts = jax.ops.segment_sum(
        jnp.ones((x.shape[0], 1), x.dtype), graph_ids, num_segments=num_graphs
    )
    return sums / jnp.maximum(counts, 1.0)


class GCNModel(Module):
    """N-layer GCN for node classification (GAT_PYNQ with attention off;
    depth = the reference's ``layer_count`` register, sgrace.py:1852 —
    default 2 like every reference deployment).

    ``remat`` rematerializes each conv in the backward pass
    (jax.checkpoint) — trades FLOPs for activation memory on large graphs.
    Quantized layers beyond the first share the reference's layer-2
    constant set (its ``layern`` state only alternates two tables).
    """

    num_features: int
    hidden_channels: int
    num_classes: int
    calibration: Optional[CalibrationTable] = None
    dropout: float = 0.5
    remat: bool = False
    num_layers: int = 2

    def __call__(self, A: SparseMatrix, x, *, training: bool = False):
        cal = self.calibration
        # explicit names keep the param tree identical with/without remat
        for i in range(self.num_layers):
            q = cal.layer_params(i) if cal else None
            f_in = self.num_features if i == 0 else self.hidden_channels
            last = i == self.num_layers - 1
            x = _conv_apply(self.remat, not last)(
                GCNConv(f_in, self.hidden_channels, quant=q,
                        name=f"conv{i + 1}"),
                A, x,
            )
        x = Dropout(self.dropout, deterministic=not training)(x)
        return Dense(self.num_classes)(x)


class GATModel(Module):
    """2-layer GAT for node classification (GAT_PYNQ, compute_attention=1)."""

    num_features: int
    hidden_channels: int
    num_classes: int
    nheads: int = 1
    alpha: float = 0.2
    calibration: Optional[CalibrationTable] = None
    dropout: float = 0.5
    remat: bool = False

    def __call__(self, A: SparseMatrix, x, *, training: bool = False):
        cal = self.calibration
        q1 = cal.layer_params(0) if cal else None
        q2 = cal.layer_params(1) if cal else None
        x = _conv_apply(self.remat, True)(
            GATConv(
                self.num_features,
                self.hidden_channels,
                nheads=self.nheads,
                alpha=self.alpha,
                quant=q1,
                name="conv1",
            ),
            A, x,
        )
        x = _conv_apply(self.remat, False)(
            GATConv(
                self.hidden_channels * self.nheads,
                self.hidden_channels,
                nheads=1,
                alpha=self.alpha,
                quant=q2,
                name="conv2",
            ),
            A, x,
        )
        x = Dropout(self.dropout, deterministic=not training)(x)
        return Dense(self.num_classes)(x)


class MoleculeGCN(Module):
    """2-layer GCN + global mean pool for graph classification (MUTAG-style).

    Mirrors GCN_PYNQ of the molecule notebook: conv1(relu fused), conv2,
    global_mean_pool, dropout(0.5), linear head; trained with Adam lr=0.01
    to the 0.76-accuracy-by-epoch-36 anchor (README.md:127-129).
    """

    num_features: int
    hidden_channels: int
    num_classes: int
    calibration: Optional[CalibrationTable] = None
    dropout: float = 0.5
    remat: bool = False

    def __call__(
        self,
        A: SparseMatrix,
        x,
        graph_ids,
        num_graphs: int,
        *,
        training: bool = False,
    ):
        cal = self.calibration
        q1 = cal.layer_params(0) if cal else None
        q2 = cal.layer_params(1) if cal else None
        x = _conv_apply(self.remat, True)(
            GCNConv(self.num_features, self.hidden_channels, quant=q1,
                    name="conv1"),
            A, x,
        )
        x = _conv_apply(self.remat, False)(
            GCNConv(self.hidden_channels, self.hidden_channels, quant=q2,
                    name="conv2"),
            A, x,
        )
        x = global_mean_pool(x, graph_ids, num_graphs)
        x = Dropout(self.dropout, deterministic=not training)(x)
        return Dense(self.num_classes)(x)
