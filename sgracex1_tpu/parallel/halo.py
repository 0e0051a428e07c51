"""Halo (boundary) exchange for row-partitioned graphs.

The all-gather layer in ``spmm_dist`` replicates the whole hidden matrix to
every shard — the direct analogue of the reference's C_buffer replication
(compute1_2/4 write one copy per ADJ thread, kernelMatrixmult_all.cpp:
2807-2916), and wasteful for the same reason. Real graphs touch few remote
rows: this module precomputes, per shard pair (owner -> reader), exactly
which hidden rows must move, ships them with one ``all_to_all``, and
aggregates local and halo edges separately so XLA can overlap the
collective with the local segment-sum (neither depends on the other).

Comm volume: O(boundary nodes) instead of O(N) per shard — the design the
scaling-efficiency target in BASELINE.md assumes.

Host-side plan (``build_halo``):
- shard s owns rows [s*n_local, (s+1)*n_local); its edges split into local
  (col owner == s) and remote.
- send_idx[t, s, :] = owner-local indices of the rows shard t sends shard s
  (padded with 0 — unreferenced slots are harmless).
- remote edge columns are relabeled to halo-buffer slots t*L + l.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from sgracex1_tpu.graph.csr import SparseMatrix
from sgracex1_tpu.ops.fused_gnn import relu_hw


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class HaloGraph:
    """Row-partitioned graph with a precomputed boundary-exchange plan.

    Edge arrays are shard-major [S, E]; send_idx is [S, S, L] (axis 0 =
    owner shard, axis 1 = destination shard).
    """

    rows_loc: np.ndarray  # int32[S, E_loc] local-edge destination (shard-local)
    cols_loc: np.ndarray  # int32[S, E_loc] local-edge source (shard-local)
    vals_loc: np.ndarray  # float[S, E_loc]
    rows_rem: np.ndarray  # int32[S, E_rem] remote-edge destination (shard-local)
    cols_halo: np.ndarray  # int32[S, E_rem] slot into the halo buffer
    vals_rem: np.ndarray  # float[S, E_rem]
    send_idx: np.ndarray  # int32[S, S, L] owner-local rows to ship
    n_shards: int = dataclasses.field(metadata=dict(static=True))
    n_local: int = dataclasses.field(metadata=dict(static=True))
    n_pad: int = dataclasses.field(metadata=dict(static=True))

    @property
    def halo_len(self) -> int:
        return self.send_idx.shape[2]


def _grouped_fill(dst_rows, values_list, group, n_groups):
    """Scatter per-group value streams into padded [n_groups, E] arrays.
    ``group`` must be sorted; returns per-group counts."""
    counts = np.bincount(group, minlength=n_groups)
    start = np.concatenate([[0], np.cumsum(counts)])
    pos = np.arange(len(group)) - start[group]
    for dst, val in zip(dst_rows, values_list):
        dst[group, pos] = val
    return counts


def build_halo(
    A: SparseMatrix, n_shards: int, *, pad_to: int = 128
) -> Tuple[HaloGraph, int]:
    """Partition adjacency rows and build the boundary-exchange plan.

    Fully vectorized (r4): one lexsort + one np.unique over the remote
    edges replace the r3 per-(owner, reader) loops — O(S^2) np.unique
    calls were the prepare bottleneck at the 2^22-node scale."""
    N = A.n_rows
    n_pad = _round_up(N, n_shards * 8)
    n_local = n_pad // n_shards
    S = n_shards

    r = np.asarray(A.rows[: A.nnz]).astype(np.int64)
    c = np.asarray(A.cols[: A.nnz]).astype(np.int64)
    v = np.asarray(A.vals[: A.nnz])
    s_of_r = r // n_local
    s_of_c = c // n_local
    local_m = s_of_r == s_of_c

    # ---- send lists: unique (reader, owner, col) over the remote edges
    rr, cc, vv = r[~local_m], c[~local_m], v[~local_m]
    readers, owners = s_of_r[~local_m], s_of_c[~local_m]
    pair = readers * S + owners
    key = pair * n_pad + cc
    uk, inv = np.unique(key, return_inverse=True)
    pair_u = uk // n_pad
    col_u = uk % n_pad
    owner_u = pair_u % S
    reader_u = pair_u // S
    cnt_pair = np.bincount(pair_u, minlength=S * S)
    L = max(_round_up(int(cnt_pair.max(initial=0)), 8), 8)
    start_pair = np.concatenate([[0], np.cumsum(cnt_pair)])
    pos_u = np.arange(len(uk)) - start_pair[pair_u]  # slot within (s, t)

    send_idx = np.zeros((S, S, L), np.int32)
    send_idx.reshape(-1)[
        (owner_u * S + reader_u) * L + pos_u
    ] = col_u - owner_u * n_local

    # ---- remote edge arrays, grouped by reader shard (stable in pair
    # order — edge order within a shard is irrelevant to segment_sum)
    order = np.argsort(readers, kind="stable")
    halo_slot = (owners * L)[order] + pos_u[inv][order]
    e_rem = max(
        _round_up(int(np.bincount(readers, minlength=S).max(initial=1)),
                  pad_to),
        pad_to,
    )
    rows_rem = np.zeros((S, e_rem), np.int32)
    cols_halo = np.zeros((S, e_rem), np.int32)
    vals_rem = np.zeros((S, e_rem), v.dtype)
    _grouped_fill(
        (rows_rem, cols_halo, vals_rem),
        ((rr - readers * n_local)[order], halo_slot, vv[order]),
        readers[order], S,
    )

    # ---- local edge arrays, grouped by shard
    rl, cl, vl = r[local_m], c[local_m], v[local_m]
    sl = s_of_r[local_m]
    order = np.argsort(sl, kind="stable")
    e_loc = max(
        _round_up(int(np.bincount(sl, minlength=S).max(initial=1)), pad_to),
        pad_to,
    )
    rows_loc = np.zeros((S, e_loc), np.int32)
    cols_loc = np.zeros((S, e_loc), np.int32)
    vals_loc = np.zeros((S, e_loc), v.dtype)
    _grouped_fill(
        (rows_loc, cols_loc, vals_loc),
        ((rl - sl * n_local)[order], (cl - sl * n_local)[order], vl[order]),
        sl[order], S,
    )
    return (
        HaloGraph(
            rows_loc=rows_loc,
            cols_loc=cols_loc,
            vals_loc=vals_loc,
            rows_rem=rows_rem,
            cols_halo=cols_halo,
            vals_rem=vals_rem,
            send_idx=send_idx,
            n_shards=n_shards,
            n_local=n_local,
            n_pad=n_pad,
        ),
        n_pad,
    )


def dist_spmm_halo(
    mesh: Mesh, G: HaloGraph, H: jax.Array, *, exchange: bool = True
) -> jax.Array:
    """out = A @ H with boundary-only exchange; H row-sharded [n_pad, P].

    ``exchange=False`` is a BENCHMARK ABLATION: the all_to_all is replaced
    by the local send buffer (same shapes and local compute, wrong values),
    so ``t_full - t_no_exchange`` isolates the collective's cost — the
    measured check on the comm model (parallel/comm_model.py)."""

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("graph", None),) * 6 + (P("graph", None, None), P("graph", None)),
        out_specs=P("graph", None),
    )
    def f(rows_loc, cols_loc, vals_loc, rows_rem, cols_halo, vals_rem,
          send_idx, H_l):
        rows_loc, cols_loc, vals_loc = rows_loc[0], cols_loc[0], vals_loc[0]
        rows_rem, cols_halo, vals_rem = rows_rem[0], cols_halo[0], vals_rem[0]
        send_idx = send_idx[0]  # [S, L]

        # ship boundary rows: gather my rows for each destination, exchange
        send = jnp.take(H_l, send_idx.reshape(-1), axis=0).reshape(
            send_idx.shape + (H_l.shape[1],)
        )  # [S, L, P]
        halo = (
            jax.lax.all_to_all(
                send, "graph", split_axis=0, concat_axis=0, tiled=False
            )
            if exchange
            else send
        ).reshape(-1, H_l.shape[1])  # [S*L, P] — slot t*L+l = row from owner t

        # local aggregation is independent of the collective -> overlappable
        out = jax.ops.segment_sum(
            jnp.take(H_l, cols_loc, axis=0) * vals_loc[:, None],
            rows_loc,
            num_segments=G.n_local,
        )
        out = out + jax.ops.segment_sum(
            jnp.take(halo, cols_halo, axis=0) * vals_rem[:, None],
            rows_rem,
            num_segments=G.n_local,
        )
        return out

    return f(
        G.rows_loc, G.cols_loc, G.vals_loc,
        G.rows_rem, G.cols_halo, G.vals_rem,
        G.send_idx, H,
    )


def dist_gnn_layer_halo(
    mesh: Mesh,
    G: HaloGraph,
    x: jax.Array,
    W: jax.Array,
    *,
    relu: bool = False,
    exchange: bool = True,
) -> jax.Array:
    """GCN layer ReLU?(A @ (X @ W)) with halo exchange of XW.
    ``exchange=False``: benchmark ablation (see dist_spmm_halo)."""
    H = jnp.dot(x, W, preferred_element_type=jnp.float32)
    out = dist_spmm_halo(mesh, G, H, exchange=exchange)
    return relu_hw(out) if relu else out


_NEG_INF = -9e15


def dist_gat_layer_halo(
    mesh: Mesh,
    G: HaloGraph,
    x: jax.Array,
    W: jax.Array,
    attention: jax.Array,
    *,
    alpha: float = 0.2,
    relu: bool = False,
    nheads: int = 1,
) -> jax.Array:
    """GAT layer with boundary-only exchange (multi-head).

    The row partition keeps each row's edges (and therefore its softmax) in
    one shard; attention scores on remote columns are computed from the
    received halo rows (``s2 = halo @ a_dst``) — no full replication of Wh.
    One halo exchange serves all heads (the full [N_l, F*H] hidden block is
    shipped once). Gradient semantics match the single-chip layer: scores
    are computed on gradient-stopped hidden states (reference backward
    approximation, sgrace.py:1094-1103).

    W: [F_in, F*H]; attention: [2*F*H, 1] (reference layout,
    sgrace.py:1176-1179). Output: [n_pad, F*H] (heads concatenated).
    """
    FH = W.shape[1]
    assert FH % nheads == 0
    F = FH // nheads

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("graph", None),) * 6
        + (P("graph", None, None), P("graph", None), P(None, None), P(None)),
        out_specs=P("graph", None),
    )
    def f(rows_loc, cols_loc, vals_loc, rows_rem, cols_halo, vals_rem,
          send_idx, x_l, W_r, a):
        rows_loc, cols_loc, vals_loc = rows_loc[0], cols_loc[0], vals_loc[0]
        rows_rem, cols_halo, vals_rem = rows_rem[0], cols_halo[0], vals_rem[0]
        send_idx = send_idx[0]

        H_l = jnp.dot(x_l, W_r, preferred_element_type=jnp.float32)
        send = jnp.take(H_l, send_idx.reshape(-1), axis=0).reshape(
            send_idx.shape + (FH,)
        )
        halo = jax.lax.all_to_all(
            send, "graph", split_axis=0, concat_axis=0, tiled=False
        ).reshape(-1, FH)

        Hsg = jax.lax.stop_gradient(H_l).reshape(-1, nheads, F)
        halo_sg = jax.lax.stop_gradient(halo).reshape(-1, nheads, F)
        a_src = a[:FH].reshape(nheads, F)
        a_dst = a[FH:].reshape(nheads, F)

        rows_all = jnp.concatenate([rows_loc, rows_rem])
        mask = (jnp.concatenate([vals_loc, vals_rem]) > 0)[:, None]
        n_loc = rows_loc.shape[0]

        # heads batched as vector lanes [E, H] through the whole edge path
        s1_l = jnp.einsum("nhf,hf->nh", Hsg, a_src)
        s2_l = jnp.einsum("nhf,hf->nh", Hsg, a_dst)
        s2_h = jnp.einsum("nhf,hf->nh", halo_sg, a_dst)

        # local and remote edge groups share the softmax over the
        # destination row — concatenate the two edge sets
        e_loc = jnp.take(s1_l, rows_loc, axis=0) + jnp.take(
            s2_l, cols_loc, axis=0
        )
        e_rem = jnp.take(s1_l, rows_rem, axis=0) + jnp.take(
            s2_h, cols_halo, axis=0
        )
        e = jnp.concatenate([e_loc, e_rem])
        e = jnp.where(e > 0, e, alpha * e)

        masked = jnp.where(mask, e, _NEG_INF)
        row_max = jax.ops.segment_max(
            masked, rows_all, num_segments=G.n_local
        )
        row_max = jnp.where(jnp.isfinite(row_max), row_max, 0.0)
        ex = jnp.where(
            mask, jnp.exp(masked - jnp.take(row_max, rows_all, axis=0)), 0.0
        )
        denom = jax.ops.segment_sum(ex, rows_all, num_segments=G.n_local)
        att = ex / jnp.take(
            jnp.where(denom > 0, denom, 1.0), rows_all, axis=0
        )

        out = jax.ops.segment_sum(
            jnp.take(H_l.reshape(-1, nheads, F), cols_loc, axis=0)
            * att[:n_loc, :, None],
            rows_loc,
            num_segments=G.n_local,
        ) + jax.ops.segment_sum(
            jnp.take(halo.reshape(-1, nheads, F), cols_halo, axis=0)
            * att[n_loc:, :, None],
            rows_rem,
            num_segments=G.n_local,
        )
        out = out.reshape(-1, FH)
        return relu_hw(out) if relu else out

    return f(
        G.rows_loc, G.cols_loc, G.vals_loc,
        G.rows_rem, G.cols_halo, G.vals_rem,
        G.send_idx, x, W, attention.reshape(-1),
    )
