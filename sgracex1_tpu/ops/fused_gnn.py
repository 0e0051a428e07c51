"""The fused two-stage GNN layer and GAT attention op.

The reference's single hardware call computes
``D = ReLU?(ADJ_csr x (FEA x W))`` as a two-stage dataflow pipeline with the
intermediate ``XW`` tile kept on-chip (``mmult_wrapper``,
``src/kernelMatrixmult_all.cpp:3629-3752``). Here XLA delivers the same
fusion (matmul + gather/segment-sum through device memory); this module is
the dispatch point and defines the
differentiation semantics that mirror the reference's autograd functions.

Gradient semantics (matching ``FPYNQ_GAT.backward``, sgrace.py:883-1126):

- ``grad_X = att @ (gO @ W^T)``, ``grad_W = X^T @ (att @ gO)`` — the
  attention/adjacency matrix is treated as constant for X/W gradients.
- The attention *parameters* get exact gradients through the softmax Jacobian
  (``dx = att*s; grad_e = dx - att*sum(dx)`` — sgrace.py:979-981) and the
  LeakyReLU derivative (sgrace.py:1011).

Both fall out of standard JAX autodiff by stopping the gradient of ``Wh``
inside the attention-score computation (the score path then only carries
gradient to the attention vector, exactly the reference's approximation),
so no hand-written VJP is needed.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from sgracex1_tpu.graph.csr import SparseMatrix
from sgracex1_tpu.ops.spmm import spmm, spmm_t
from sgracex1_tpu.ops.sddmm import sddmm, leaky_relu, edge_softmax
from sgracex1_tpu.quant.affine import QuantConstants, quantize, dequantize


def relu_hw(x: jax.Array) -> jax.Array:
    """ReLU with the reference's "hardware-style" gradient: the backward
    masks where the *saved output* is zero (``RPYNQ.backward`` masks
    ``input == 0`` on the post-relu tensor — sgrace.py:282-294). For
    ``max(x, 0)`` this is the standard subgradient with g=0 at x=0."""
    return jnp.where(x > 0, x, jnp.zeros_like(x))


def gnn_layer(
    A: SparseMatrix,
    X,
    W: jax.Array,
    *,
    relu: bool = False,
    accum_dtype=jnp.float32,
) -> jax.Array:
    """GCN layer: ``ReLU?(A @ (X @ W))`` — reference gemm_mode 0/1 fused call.

    ``X`` is either a dense array (gemm_mode=1 — the matmul fast path for
    any feature matrix that fits in device memory) or a ``SparseMatrix`` (gemm_mode=0 —
    the reference's sparse-feature streaming, here the same segment-sum
    SpMM as the aggregation stage; use for feature matrices too large or
    too sparse to densify).
    """
    if isinstance(X, SparseMatrix):
        H = spmm(X, W.astype(accum_dtype), accum_dtype=accum_dtype)
    else:
        H = jnp.dot(X, W, preferred_element_type=accum_dtype).astype(X.dtype)
    out = spmm(A, H, accum_dtype=accum_dtype)
    return relu_hw(out) if relu else out


def gat_attention(
    A: SparseMatrix,
    Wh: jax.Array,
    a_src: jax.Array,
    a_dst: jax.Array,
    *,
    alpha: float = 0.2,
    straight_through_scores: bool = True,
) -> tuple[jax.Array, jax.Array]:
    """Per-edge GAT attention: returns (edge_logits e, edge_probs s).

    These are the sparse analogues of the demo bitstream's E (pre-softmax
    logits) and S (softmax probabilities) output buffers (sgrace.py:501-539).

    With ``straight_through_scores`` (the default), ``Wh`` is gradient-stopped
    inside the score computation so X/W receive no gradient through the
    attention weights — matching the reference backward (see module doc).
    """
    Wh_s = jax.lax.stop_gradient(Wh) if straight_through_scores else Wh
    e = leaky_relu(sddmm(A, Wh_s, a_src, a_dst), alpha)
    s = edge_softmax(A, e)
    return e, s


def edges_to_dense(A: SparseMatrix, edge_vals: jax.Array) -> jax.Array:
    """Reassemble per-edge values into a dense [N, N] matrix — the host-side
    COO->dense reassembly the reference performs on the E/S attention
    read-back buffers (sgrace.py:498-539). In-jit (scatter); for host use
    prefer numpy on ``np.asarray`` outputs."""
    out = jnp.zeros((A.n_rows, A.n_cols), edge_vals.dtype)
    vals = jnp.where(A.pad_mask(), edge_vals, 0)
    return out.at[A.rows, A.cols].add(vals)


# --------------------------------------------------------------------------
# quantized backward (the reference's accb=1 hardware-offloaded backward)
# --------------------------------------------------------------------------


@partial(jax.custom_vjp, nondiff_argnums=(0, 1))
def _gnn_layer_qbwd(n_rows, go_c, rows, cols, vals, X, W):
    H = jnp.dot(X, W, preferred_element_type=jnp.float32)
    gathered = jnp.take(H, cols, axis=0) * vals[:, None]
    return jax.ops.segment_sum(gathered, rows, num_segments=n_rows)


def _gnn_layer_qbwd_fwd(n_rows, go_c, rows, cols, vals, X, W):
    return (
        _gnn_layer_qbwd(n_rows, go_c, rows, cols, vals, X, W),
        (rows, cols, vals, X, W),
    )


def _gnn_layer_qbwd_bwd(n_rows, go_c, res, g):
    rows, cols, vals, X, W = res
    # The reference quantizes grad_output to go_qbits (8) before the two
    # backward kernel launches and dequantizes the results with
    # deq_gw / deq_gi (sgrace.py:701-878, 1690-1691). Net effect: the
    # gradient matmuls see the 8-bit-rounded cotangent — a
    # quantize->dequantize round trip here (the reference's separate deq
    # factors exist only because its kernel consumes the raw integer grid).
    gq = dequantize(quantize(g, go_c), go_c)
    AtG = jax.ops.segment_sum(
        jnp.take(gq, rows, axis=0) * vals[:, None],
        cols,
        num_segments=X.shape[0],
    )  # A^T @ gq (the reference reuses A: its normalized adj is symmetric)
    grad_W = jnp.dot(X.T, AtG, preferred_element_type=jnp.float32)
    grad_X = jnp.dot(AtG, W.T, preferred_element_type=jnp.float32)
    f0 = lambda a: np.zeros(a.shape, jax.dtypes.float0)
    return (f0(rows), f0(cols), jnp.zeros_like(vals), grad_X, grad_W)


_gnn_layer_qbwd.defvjp(_gnn_layer_qbwd_fwd, _gnn_layer_qbwd_bwd)


def gnn_layer_quant_backward(
    A: SparseMatrix,
    X: jax.Array,
    W: jax.Array,
    go_c: QuantConstants,
    *,
    relu: bool = False,
) -> jax.Array:
    """GCN layer whose BACKWARD quantizes the output cotangent to
    ``go_c.qbits`` bits before the gradient matmuls — the reference's
    hardware-offloaded backward (``accb=1``, FPYNQ_GAT.backward pass 1/2
    with gemm_mode=2/1 pointer swapping, sgrace.py:701-878). The pointer
    swap is an FPGA artifact; the math is
    ``grad_W = X^T (A^T gq) * deq``, ``grad_X = (A^T gq) W^T * deq``
    with gq the 8-bit-rounded cotangent (the reference uses A for A^T
    since its normalized adjacency is symmetric).
    """
    out = _gnn_layer_qbwd(A.n_rows, go_c, A.rows, A.cols, A.vals, X, W)
    return relu_hw(out) if relu else out


def gat_layer(
    A: SparseMatrix,
    X: jax.Array,
    W: jax.Array,
    attention: jax.Array,
    *,
    alpha: float = 0.2,
    relu: bool = False,
    accum_dtype=jnp.float32,
) -> jax.Array:
    """Full GAT layer: attention-weighted aggregation of ``Wh = X @ W``.

    ``attention`` is the reference's single [2*F, 1]-shaped attention vector
    (``GATConv_SGRACE`` params, sgrace.py:1178): the first F entries score the
    source (row) node, the last F the destination (column) node.
    """
    F = W.shape[1]
    a = attention.reshape(-1)
    Wh = jnp.dot(X, W, preferred_element_type=accum_dtype).astype(X.dtype)
    _, s = gat_attention(A, Wh, a[:F], a[F:], alpha=alpha)
    att_mat = A.with_vals(s.astype(A.vals.dtype))
    out = spmm(att_mat, Wh, accum_dtype=accum_dtype)
    return relu_hw(out) if relu else out
