"""Graph partitioning for multi-device execution.

1D row partition: node i belongs to shard i // (N_pad / S). Each shard owns
the adjacency edges whose *destination row* is local (so aggregation output
is local) with global column indices; per-shard edge lists are padded to a
common static length. This is the equivalent of the reference's
``first_row/row_count`` ADJ-thread split (kernelMatrixmult_all.cpp:3439-3452)
— there the crossbar replicated the XW buffer to every thread; here the
XW activations are all-gathered (or halo-exchanged) across shards.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import numpy as np

from sgracex1_tpu.graph.csr import SparseMatrix


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ShardedGraph:
    """Row-partitioned sparse adjacency, shard-major layout.

    Arrays are [S, E_s]: leading axis maps onto the mesh's 'graph' axis.
    rows_local are 0-based within the shard; cols are global node ids.
    Padding entries have val == 0.
    """

    rows_local: np.ndarray  # int32[S, E_s]
    cols: np.ndarray  # int32[S, E_s]
    vals: np.ndarray  # float[S, E_s]
    n_shards: int = dataclasses.field(metadata=dict(static=True))
    n_local: int = dataclasses.field(metadata=dict(static=True))
    n_pad: int = dataclasses.field(metadata=dict(static=True))

    @property
    def e_shard(self) -> int:
        return self.vals.shape[1]


def partition_graph(
    A: SparseMatrix, n_shards: int, *, pad_to: int = 128
) -> Tuple[ShardedGraph, int]:
    """Partition adjacency rows into n_shards contiguous blocks.

    Returns (sharded graph, n_pad) where n_pad is the padded node count
    (multiple of n_shards * 8 for sublane alignment); callers must pad node
    features to n_pad rows.
    """
    N = A.n_rows
    n_pad = _round_up(N, n_shards * 8)
    n_local = n_pad // n_shards

    r = np.asarray(A.rows[: A.nnz])
    c = np.asarray(A.cols[: A.nnz])
    v = np.asarray(A.vals[: A.nnz])
    shard_of = r // n_local

    counts = np.bincount(shard_of, minlength=n_shards)
    e_shard = max(_round_up(int(counts.max()), pad_to), pad_to)

    rows_l = np.zeros((n_shards, e_shard), np.int32)
    cols = np.zeros((n_shards, e_shard), np.int32)
    vals = np.zeros((n_shards, e_shard), v.dtype)
    for s in range(n_shards):
        m = shard_of == s
        k = int(m.sum())
        rows_l[s, :k] = r[m] - s * n_local
        cols[s, :k] = c[m]
        vals[s, :k] = v[m]
    return (
        ShardedGraph(
            rows_local=rows_l,
            cols=cols,
            vals=vals,
            n_shards=n_shards,
            n_local=n_local,
            n_pad=n_pad,
        ),
        n_pad,
    )


def pad_nodes(x: np.ndarray, n_pad: int) -> np.ndarray:
    """Zero-pad node-wise arrays to the padded node count."""
    if x.shape[0] == n_pad:
        return x
    out = np.zeros((n_pad,) + x.shape[1:], x.dtype)
    out[: x.shape[0]] = x
    return out
