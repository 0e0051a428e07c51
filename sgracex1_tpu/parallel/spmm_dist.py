"""Distributed (multi-chip) GNN layers via shard_map + XLA collectives.

Row-parallel execution: X and the output are row-sharded over the 'graph'
mesh axis; W and attention params are replicated. Each layer computes the
local XW, all-gathers the (small) hidden activations across shards, then
aggregates its local adjacency rows — the replacement for the
reference's FEA->ADJ crossbar, where every ADJ thread could read every FEA
thread's C_buffer block (dsp_kernel_*_adj_2/4 block-select,
kernelMatrixmult_all.cpp:1413-1776).

Differentiable end-to-end: jax.grad through shard_map transposes the
all_gather into a reduce_scatter automatically, giving the correct
row-sharded gradients.

These functions take explicit arrays (not flax modules) so they compose with
any training step; `dist_gnn_layer`/`dist_gat_layer` mirror the single-chip
layers in ops/fused_gnn.py.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from sgracex1_tpu.parallel.partition import ShardedGraph
from sgracex1_tpu.ops.fused_gnn import relu_hw

_NEG_INF = -9e15


def _local_spmm(rows_l, cols, vals, H_full, n_local):
    gathered = jnp.take(H_full, cols, axis=0) * vals[:, None]
    return jax.ops.segment_sum(gathered, rows_l, num_segments=n_local)


def dist_spmm(mesh: Mesh, G: ShardedGraph, H: jax.Array) -> jax.Array:
    """out = A @ H with A row-sharded and H row-sharded [n_pad, P]."""

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P("graph", None),
            P("graph", None),
            P("graph", None),
            P("graph", None),
        ),
        out_specs=P("graph", None),
    )
    def f(rows_l, cols, vals, H_l):
        H_full = jax.lax.all_gather(H_l, "graph", axis=0, tiled=True)
        return _local_spmm(rows_l[0], cols[0], vals[0], H_full, G.n_local)

    return f(G.rows_local, G.cols, G.vals, H)


def dist_gnn_layer(
    mesh: Mesh,
    G: ShardedGraph,
    x: jax.Array,
    W: jax.Array,
    *,
    relu: bool = False,
) -> jax.Array:
    """GCN layer ReLU?(A @ (X @ W)), row-sharded x [n_pad, F]."""

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P("graph", None),
            P("graph", None),
            P("graph", None),
            P("graph", None),
            P(None, None),
        ),
        out_specs=P("graph", None),
    )
    def f(rows_l, cols, vals, x_l, W_r):
        H_l = jnp.dot(x_l, W_r, preferred_element_type=jnp.float32)
        H_full = jax.lax.all_gather(H_l, "graph", axis=0, tiled=True)
        out = _local_spmm(rows_l[0], cols[0], vals[0], H_full, G.n_local)
        return relu_hw(out) if relu else out

    return f(G.rows_local, G.cols, G.vals, x, W)


def dist_gat_layer(
    mesh: Mesh,
    G: ShardedGraph,
    x: jax.Array,
    W: jax.Array,
    attention: jax.Array,
    *,
    alpha: float = 0.2,
    relu: bool = False,
) -> jax.Array:
    """GAT layer with row-sharded attention softmax.

    The row partition keeps every row's edges in one shard, so the
    edge-softmax is shard-local; only the hidden activations are exchanged.
    """
    F = W.shape[1]

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P("graph", None),
            P("graph", None),
            P("graph", None),
            P("graph", None),
            P(None, None),
            P(None),
        ),
        out_specs=P("graph", None),
    )
    def f(rows_l, cols, vals, x_l, W_r, a):
        rows_l, cols, vals = rows_l[0], cols[0], vals[0]
        H_l = jnp.dot(x_l, W_r, preferred_element_type=jnp.float32)
        H_full = jax.lax.all_gather(H_l, "graph", axis=0, tiled=True)

        Hsg = jax.lax.stop_gradient(H_full)
        s1 = jnp.dot(Hsg, a[:F], preferred_element_type=jnp.float32)
        s2 = jnp.dot(Hsg, a[F:], preferred_element_type=jnp.float32)
        shard = jax.lax.axis_index("graph")
        row_global = rows_l + shard * G.n_local
        e = jnp.take(s1, row_global) + jnp.take(s2, cols)
        e = jnp.where(e > 0, e, alpha * e)

        mask = vals > 0
        masked = jnp.where(mask, e, _NEG_INF)
        row_max = jax.ops.segment_max(masked, rows_l, num_segments=G.n_local)
        row_max = jnp.where(jnp.isfinite(row_max), row_max, 0.0)
        ex = jnp.where(mask, jnp.exp(masked - jnp.take(row_max, rows_l)), 0.0)
        denom = jax.ops.segment_sum(ex, rows_l, num_segments=G.n_local)
        att = ex / jnp.take(jnp.where(denom > 0, denom, 1.0), rows_l)

        out = _local_spmm(rows_l, cols, att, H_full, G.n_local)
        return relu_hw(out) if relu else out

    return f(G.rows_local, G.cols, G.vals, x, W, attention.reshape(-1))
