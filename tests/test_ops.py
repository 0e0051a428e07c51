"""Core op tests: SpMM, SDDMM, edge softmax, fused layers, and gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from sgracex1_tpu.graph.csr import SparseMatrix
from sgracex1_tpu.ops.spmm import spmm, spmm_t, spmm_dense_rhs
from sgracex1_tpu.ops.sddmm import sddmm, edge_softmax, leaky_relu
from sgracex1_tpu.ops.fused_gnn import gnn_layer, gat_layer, gat_attention


def _rand_sparse(rng, n, m, density=0.08):
    mat = sp.random(
        n, m, density=density, format="csr", random_state=int(rng.integers(1 << 30))
    )
    return SparseMatrix.from_scipy(mat), mat


def test_spmm_matches_scipy(rng):
    A, mat = _rand_sparse(rng, 50, 70)
    H = rng.standard_normal((70, 16)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(spmm(A, H)), mat @ H, rtol=1e-5, atol=1e-5)


def test_spmm_t_matches_scipy(rng):
    A, mat = _rand_sparse(rng, 50, 70)
    H = rng.standard_normal((50, 16)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(spmm_t(A, H)), mat.T @ H, rtol=1e-5, atol=1e-5
    )


def test_spmm_dense_rhs(rng):
    A, mat = _rand_sparse(rng, 40, 40)
    X = rng.standard_normal((40, 12)).astype(np.float32)
    W = rng.standard_normal((12, 8)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(spmm_dense_rhs(A, X, W)), mat @ X @ W, rtol=1e-4, atol=1e-4
    )


def test_spmm_under_jit(rng):
    A, mat = _rand_sparse(rng, 30, 30)
    H = rng.standard_normal((30, 8)).astype(np.float32)
    out = jax.jit(spmm)(A, H)
    np.testing.assert_allclose(np.asarray(out), mat @ H, rtol=1e-5, atol=1e-5)


def test_spmm_gradients_are_transposed_spmm(rng):
    """d/dH (v . A@H) == A^T @ v — autodiff through gather/segment_sum."""
    A, mat = _rand_sparse(rng, 25, 25)
    H = rng.standard_normal((25, 4)).astype(np.float32)
    v = rng.standard_normal((25, 4)).astype(np.float32)
    g = jax.grad(lambda h: jnp.vdot(spmm(A, h), v))(H)
    np.testing.assert_allclose(np.asarray(g), mat.T @ v, rtol=1e-4, atol=1e-5)


def test_sddmm_matches_dense(rng):
    A, mat = _rand_sparse(rng, 20, 20, density=0.2)
    Wh = rng.standard_normal((20, 8)).astype(np.float32)
    a1 = rng.standard_normal(8).astype(np.float32)
    a2 = rng.standard_normal(8).astype(np.float32)
    e = np.asarray(sddmm(A, jnp.asarray(Wh), jnp.asarray(a1), jnp.asarray(a2)))
    dense_e = (Wh @ a1)[:, None] + (Wh @ a2)[None, :]
    r, c = np.asarray(A.rows[: A.nnz]), np.asarray(A.cols[: A.nnz])
    np.testing.assert_allclose(e[: A.nnz], dense_e[r, c], rtol=1e-5, atol=1e-5)


def test_edge_softmax_matches_dense_masked_softmax(rng):
    """Sparse segment softmax == reference's dense -9e15-masked softmax
    (sgrace.py:634-647) at edge positions."""
    n = 16
    mat = sp.random(n, n, density=0.3, format="csr", random_state=5)
    mat.setdiag(1.0)  # ensure every row has an edge (self-loops)
    A = SparseMatrix.from_scipy(mat)
    Wh = rng.standard_normal((n, 8)).astype(np.float32)
    a1 = rng.standard_normal(8).astype(np.float32)
    a2 = rng.standard_normal(8).astype(np.float32)

    e_edges = leaky_relu(sddmm(A, jnp.asarray(Wh), jnp.asarray(a1), jnp.asarray(a2)))
    s = np.asarray(edge_softmax(A, e_edges))

    dense_e = (Wh @ a1)[:, None] + (Wh @ a2)[None, :]
    dense_e = np.where(dense_e > 0, dense_e, 0.2 * dense_e)
    masked = np.where(mat.toarray() > 0, dense_e, -9e15)
    dense_s = np.exp(masked - masked.max(1, keepdims=True))
    dense_s /= dense_s.sum(1, keepdims=True)

    r, c = np.asarray(A.rows[: A.nnz]), np.asarray(A.cols[: A.nnz])
    np.testing.assert_allclose(s[: A.nnz], dense_s[r, c], rtol=1e-5, atol=1e-6)


def test_gnn_layer_forward(rng):
    A, mat = _rand_sparse(rng, 30, 30)
    X = rng.standard_normal((30, 10)).astype(np.float32)
    W = rng.standard_normal((10, 8)).astype(np.float32)
    out = np.asarray(gnn_layer(A, X, W, relu=True))
    expect = np.maximum(mat @ (X @ W), 0)
    np.testing.assert_allclose(out, expect, rtol=1e-4, atol=1e-4)


def test_gnn_layer_sparse_features(rng):
    """gemm_mode=0 path: X staged as a SparseMatrix matches the dense path."""
    import jax.numpy as jnp
    from sgracex1_tpu.graph.csr import SparseMatrix

    A, mat = _rand_sparse(rng, 30, 30)
    X = (rng.uniform(size=(30, 10)) < 0.2).astype(np.float32)
    W = rng.standard_normal((10, 8)).astype(np.float32)
    X_sp = SparseMatrix.from_dense(X)
    out_sparse = np.asarray(gnn_layer(A, X_sp, jnp.asarray(W), relu=True))
    out_dense = np.asarray(gnn_layer(A, jnp.asarray(X), jnp.asarray(W), relu=True))
    np.testing.assert_allclose(out_sparse, out_dense, rtol=1e-5, atol=1e-5)


def test_gnn_layer_backward_matches_reference_formulas(rng):
    """grad_W = X^T (A^T gO'), grad_X = A^T gO' W^T with relu mask gO'
    (reference formulas sgrace.py:1094-1103 + RPYNQ mask; reference assumes
    symmetric A, we verify with exact transpose)."""
    A, mat = _rand_sparse(rng, 20, 20)
    X = rng.standard_normal((20, 6)).astype(np.float32)
    W = rng.standard_normal((6, 5)).astype(np.float32)
    gO = rng.standard_normal((20, 5)).astype(np.float32)

    def loss(x, w):
        return jnp.vdot(gnn_layer(A, x, w, relu=True), gO)

    gX, gW = jax.grad(loss, argnums=(0, 1))(X, W)
    out = np.maximum(mat @ (X @ W), 0)
    gO_masked = gO * (out > 0)
    np.testing.assert_allclose(
        np.asarray(gW), X.T @ (mat.T @ gO_masked), rtol=1e-4, atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(gX), (mat.T @ gO_masked) @ W.T, rtol=1e-4, atol=1e-4
    )


def test_gat_layer_matches_dense_reference(rng):
    """Full GAT layer forward == the reference emulation math (fp path,
    sgrace.py:599-657 with fake_quantization=0)."""
    n, fin, fout = 18, 7, 6
    mat = sp.random(n, n, density=0.25, format="csr", random_state=9)
    mat.setdiag(0.5)
    A = SparseMatrix.from_scipy(mat)
    X = rng.standard_normal((n, fin)).astype(np.float32)
    W = rng.standard_normal((fin, fout)).astype(np.float32)
    att = rng.standard_normal((2 * fout, 1)).astype(np.float32)

    out = np.asarray(gat_layer(A, X, W, jnp.asarray(att), alpha=0.2, relu=True))

    Wh = X @ W
    e = (Wh @ att[:fout, 0])[:, None] + (Wh @ att[fout:, 0])[None, :]
    e = np.where(e > 0, e, 0.2 * e)
    masked = np.where(mat.toarray() > 0, e, -9e15)
    s = np.exp(masked - masked.max(1, keepdims=True))
    s /= s.sum(1, keepdims=True)
    expect = np.maximum(s @ Wh, 0)
    np.testing.assert_allclose(out, expect, rtol=1e-4, atol=1e-4)


def test_gat_attention_param_gradient_uses_softmax_jacobian(rng):
    """Attention-vector gradient equals the reference's explicit chain
    (sgrace.py:979-1081): softmax Jacobian + leakyrelu' + edge mask."""
    n, f = 12, 5
    mat = sp.random(n, n, density=0.4, format="csr", random_state=11)
    mat.setdiag(1.0)
    A = SparseMatrix.from_scipy(mat)
    Wh = rng.standard_normal((n, f)).astype(np.float32)
    att = rng.standard_normal((2 * f,)).astype(np.float32)
    gO = rng.standard_normal((n, f)).astype(np.float32)

    def loss(a):
        _, s = gat_attention(A, jnp.asarray(Wh), a[:f], a[f:], alpha=0.2)
        att_mat = A.with_vals(s)
        return jnp.vdot(spmm(att_mat, jnp.asarray(Wh)), gO)

    g = np.asarray(jax.grad(loss)(jnp.asarray(att)))

    # reference chain, dense
    adj = mat.toarray()
    e_raw = (Wh @ att[:f])[:, None] + (Wh @ att[f:])[None, :]
    e = np.where(e_raw > 0, e_raw, 0.2 * e_raw)
    masked = np.where(adj > 0, e, -9e15)
    s = np.exp(masked - masked.max(1, keepdims=True))
    s /= s.sum(1, keepdims=True)
    softmax_out = gO @ Wh.T  # dL/ds
    dx = s * softmax_out
    soft_grad = dx - s * dx.sum(1, keepdims=True)  # sgrace.py:979-981
    soft_grad = np.where(adj > 0, soft_grad, 0.0)
    soft_grad = soft_grad * ((e_raw > 0) + 0.2 * (e_raw <= 0))  # sgrace.py:1011
    g1 = Wh.T @ soft_grad.sum(axis=1)
    g2 = Wh.T @ soft_grad.sum(axis=0)
    expect = np.concatenate([g1, g2])
    np.testing.assert_allclose(g, expect, rtol=1e-3, atol=1e-4)


def test_edge_softmax_multihead_matches_per_head(rng):
    """[E, H] logits through one edge_softmax == H separate passes."""
    from sgracex1_tpu.graph.normalize import sym_norm
    from tests.conftest import make_random_graph

    n, H = 60, 3
    A = sym_norm(make_random_graph(rng, n), n)
    e = jnp.asarray(rng.standard_normal((A.e_pad, H)).astype(np.float32))
    s_all = np.asarray(edge_softmax(A, e))
    for h in range(H):
        s_h = np.asarray(edge_softmax(A, e[:, h]))
        np.testing.assert_allclose(s_all[:, h], s_h, rtol=1e-6, atol=1e-7)
