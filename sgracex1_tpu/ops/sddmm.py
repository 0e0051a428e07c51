"""SDDMM edge scores and edge-masked softmax (GAT attention primitives).

The reference computes GAT attention densely in emulation
(``sgrace.py:309-314,634-647``): ``e = Wh@a1 + (Wh@a2)^T``, LeakyReLU, then a
row softmax with non-edges masked to -9e15; the demo bitstream computes the
same sparsely, returning per-edge logits (E buffer) and probabilities
(S buffer) (``sgrace.py:501-539``). The form used here is the sparse one:
scores only on edges (SDDMM) + a segment softmax over each row's edges —
O(nnz) instead of O(N^2).

Because every row has a self-loop after ``sym_norm`` the segment softmax is
exactly equal to the reference's dense masked softmax on edge positions.
Entries whose adjacency value is <= 0 are masked out, matching the
reference's ``adj_d > 0`` mask (sgrace.py:640) — this includes fill=0
self-loops and padding.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sgracex1_tpu.graph.csr import SparseMatrix

_NEG_INF = -9e15  # reference's mask value (sgrace.py:638)


def sddmm(
    A: SparseMatrix, Wh: jax.Array, a_src: jax.Array, a_dst: jax.Array
) -> jax.Array:
    """Per-edge attention logits e[k] = (Wh @ a_src)[row_k] + (Wh @ a_dst)[col_k].

    ``a_src``/``a_dst`` are the two halves of the reference's attention vector
    (``attention[:out_features]`` / ``attention[out_features:]`` —
    sgrace.py:309-314). Reduces to two matvecs + gathers.
    """
    s1 = jnp.dot(Wh, a_src, preferred_element_type=jnp.float32)  # [N]
    s2 = jnp.dot(Wh, a_dst, preferred_element_type=jnp.float32)  # [N]
    return jnp.take(s1, A.rows) + jnp.take(s2, A.cols)


def leaky_relu(x: jax.Array, alpha: float = 0.2) -> jax.Array:
    return jnp.where(x > 0, x, alpha * x)


def edge_softmax(
    A: SparseMatrix, logits: jax.Array, *, mask=None
) -> jax.Array:
    """Softmax of per-edge logits within each row segment.

    ``logits``: [E_pad] or [E_pad, H] (multi-head logits batched as vector
    lanes — one segment pass serves all heads). ``mask`` (bool[E_pad]) marks
    edges participating in the softmax; defaults to ``A.vals > 0``
    (reference's ``adj_d > 0`` edge mask), which also excludes padding
    (padding vals are 0).
    """
    if mask is None:
        mask = A.vals > 0
    if logits.ndim == 2 and mask.ndim == 1:
        mask = mask[:, None]
    masked = jnp.where(mask, logits, _NEG_INF)
    row_max = jax.ops.segment_max(masked, A.rows, num_segments=A.n_rows)
    # Rows with no participating edges have max=-inf; guard the subtraction.
    row_max = jnp.where(jnp.isfinite(row_max), row_max, 0.0)
    ex = jnp.where(
        mask, jnp.exp(masked - jnp.take(row_max, A.rows, axis=0)), 0.0
    )
    denom = jax.ops.segment_sum(ex, A.rows, num_segments=A.n_rows)
    denom = jnp.where(denom > 0, denom, 1.0)
    return ex / jnp.take(denom, A.rows, axis=0)


def gat_attention_agg_ref(
    A: SparseMatrix, s1: jax.Array, s2: jax.Array, Wh: jax.Array,
    alpha: float = 0.2,
) -> jax.Array:
    """Plain attention aggregation on the edge path: the executable spec
    GAT layers are tested against.

    ``out[r] = sum_e softmax_row(LeakyReLU(s1[r] + s2[c_e])) * Wh[c_e]``
    over row r's edges with value > 0. Single head: s1/s2 [N], Wh [N, F];
    multi-head: s1/s2 [N, H], Wh [N, H, F]."""
    e = leaky_relu(
        jnp.take(s1, A.rows, axis=0) + jnp.take(s2, A.cols, axis=0), alpha
    )
    s = edge_softmax(A, e)
    return jax.ops.segment_sum(
        jnp.take(Wh, A.cols, axis=0) * s[..., None],
        A.rows,
        num_segments=A.n_rows,
    )
