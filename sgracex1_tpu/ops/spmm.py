"""Sparse x dense matrix products: the edge path.

The replacement for the reference's streaming CSR dot product cores
(``dsp_kernel_wrapper_fea``/``_adj`` —
``src/kernelMatrixmult_all.cpp:1960-2152,1413-1957``). Where the FPGA hides
FP-add latency with partial-sum rotors and row-grouping (SPMM_BLOCK), this
expresses the same computation as a vectorized gather + segment-sum, which
XLA lowers to native gathers and scatter-adds on the GPU. It is the hot
path for sparse graphs (ops/dispatch.py).

All functions take the padded row-sorted COO ``SparseMatrix``; padding entries
carry value 0 so they contribute nothing.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sgracex1_tpu.graph.csr import SparseMatrix


def spmm(A: SparseMatrix, H: jax.Array, *, accum_dtype=jnp.float32) -> jax.Array:
    """out[i, :] = sum_j A[i, j] * H[j, :]   (A @ H).

    The aggregation stage of the reference layer (``loop_adj`` / compute2_N,
    kernelMatrixmult_all.cpp:3339-3627).
    """
    gathered = jnp.take(H, A.cols, axis=0).astype(accum_dtype)
    weighted = gathered * A.vals.astype(accum_dtype)[:, None]
    out = jax.ops.segment_sum(
        weighted,
        A.rows,
        num_segments=A.n_rows,
        indices_are_sorted=A.rows_sorted,
    )
    return out.astype(H.dtype)


def spmm_t(A: SparseMatrix, H: jax.Array, *, accum_dtype=jnp.float32) -> jax.Array:
    """out = A.T @ H without materializing the transpose.

    Segment-sums don't need sorted ids, so the transpose is just swapping the
    gather/scatter roles of rows and cols.
    """
    gathered = jnp.take(H, A.rows, axis=0).astype(accum_dtype)
    weighted = gathered * A.vals.astype(accum_dtype)[:, None]
    out = jax.ops.segment_sum(weighted, A.cols, num_segments=A.n_cols)
    return out.astype(H.dtype)


def spmm_dense_rhs(
    A: SparseMatrix, X_dense: jax.Array, W: jax.Array, *, accum_dtype=jnp.float32
) -> jax.Array:
    """A @ (X_dense @ W) — the reference's ``gemm_mode=1`` dense-feature path
    (readers synthesize dense CSR indices, kernelMatrixmult_all.cpp:847-865,
    986-1014). Here the dense stage is simply a matmul."""
    H = jnp.dot(X_dense, W, preferred_element_type=accum_dtype)
    return spmm(A, H.astype(X_dense.dtype), accum_dtype=accum_dtype)


def spmv(A: SparseMatrix, x: jax.Array) -> jax.Array:
    """Sparse matrix-vector product (utility)."""
    return spmm(A, x[:, None])[:, 0]
