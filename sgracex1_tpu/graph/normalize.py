"""GCN adjacency normalization.

Re-implements the math of the reference's ``sym_norm2``
(``demo/sgrace_lib/sgrace.py:18-51``): add remaining self-loops with a
configurable fill value, then symmetric normalization
``A_hat = D^{-1/2} (A + fill*I) D^{-1/2}``. Host-side (numpy): graph
preprocessing happens once, outside jit, like the reference does it on the
host before programming the accelerator.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from sgracex1_tpu.graph.csr import SparseMatrix


def add_self_loops(
    edge_index: np.ndarray,
    edge_weight: Optional[np.ndarray],
    num_nodes: int,
    fill: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Add a self-loop to every node that lacks one (reference uses torch's
    ``add_remaining_self_loops`` with ``fill`` — sgrace.py:42)."""
    edge_index = np.asarray(edge_index, dtype=np.int64)
    if edge_weight is None:
        edge_weight = np.ones(edge_index.shape[1], dtype=np.float32)
    edge_weight = np.asarray(edge_weight, dtype=np.float32)

    has_loop = np.zeros(num_nodes, dtype=bool)
    loop_mask = edge_index[0] == edge_index[1]
    has_loop[edge_index[0, loop_mask]] = True
    missing = np.nonzero(~has_loop)[0]

    loops = np.stack([missing, missing]).astype(np.int64)
    loop_w = np.full(len(missing), fill, dtype=np.float32)
    edge_index = np.concatenate([edge_index, loops], axis=1)
    edge_weight = np.concatenate([edge_weight, loop_w])

    # sort by (row, col) — reference sorts so self loops are in order
    order = np.lexsort((edge_index[1], edge_index[0]))
    return edge_index[:, order], edge_weight[order]


def sym_norm_edges(
    edge_index: np.ndarray,
    num_nodes: int,
    edge_weight: Optional[np.ndarray] = None,
    fill: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Edge-list form of sym_norm2: returns (edge_index, normalized weights).

    weight'(i,j) = d_i^{-1/2} * w(i,j) * d_j^{-1/2} with d = sum of weights
    per source row (reference computes degree over ``row`` — sgrace.py:46-49).
    """
    from sgracex1_tpu.runtime import native

    fast = native.sym_norm_edges(
        np.asarray(edge_index, dtype=np.int64), num_nodes, edge_weight, fill
    )
    if fast is not None:
        return fast
    edge_index, edge_weight = add_self_loops(edge_index, edge_weight, num_nodes, fill)
    row, col = edge_index
    deg = np.zeros(num_nodes, dtype=np.float64)
    np.add.at(deg, row, edge_weight)
    with np.errstate(divide="ignore"):
        dis = np.power(deg, -0.5)
    dis[~np.isfinite(dis)] = 0.0
    return edge_index, (dis[row] * edge_weight * dis[col]).astype(np.float32)


def sym_norm(
    edge_index: np.ndarray,
    num_nodes: int,
    edge_weight: Optional[np.ndarray] = None,
    fill: float = 0.0,
    *,
    pad_to: int = 128,
) -> SparseMatrix:
    """sym_norm2 returning the normalized adjacency as a SparseMatrix."""
    ei, ew = sym_norm_edges(edge_index, num_nodes, edge_weight, fill)
    return SparseMatrix.from_coo(
        ei[0], ei[1], ew, (num_nodes, num_nodes), pad_to=pad_to, sort=False
    )
