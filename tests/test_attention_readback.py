"""GAT attention read-back (E/S buffers) and the quantized-backward path."""

import numpy as np
import jax
import jax.numpy as jnp

from sgracex1_tpu.graph.csr import SparseMatrix
from sgracex1_tpu.graph.normalize import sym_norm
from sgracex1_tpu.nn.layers import GATConv, GCNConv
from sgracex1_tpu.ops.fused_gnn import (
    edges_to_dense,
    gnn_layer_quant_backward,
)
from sgracex1_tpu.quant.calibration import CalibrationTable
from tests.conftest import make_random_graph


def _graph(rng, n=48):
    ei = make_random_graph(rng, n)
    return sym_norm(ei, n)


def test_gat_attention_readback_shapes_and_softmax(rng):
    A = _graph(rng)
    n = A.n_rows
    x = jnp.asarray(rng.standard_normal((n, 8)).astype(np.float32))
    conv = GATConv(8, 4, nheads=2)
    params = conv.init(jax.random.PRNGKey(0), A, x)
    out, (e, s) = conv.apply(params, A, x, return_attention=True)
    assert out.shape == (n, 8)  # 4 features x 2 heads
    assert e.shape == (2, A.e_pad) and s.shape == (2, A.e_pad)
    # per-row softmax sums to 1 over participating edges
    dense_s = np.asarray(edges_to_dense(A, s[0]))
    mask_rows = np.asarray(
        jax.ops.segment_sum(
            (A.vals > 0).astype(np.float32), A.rows, num_segments=n
        )
    )
    sums = dense_s.sum(axis=1)
    np.testing.assert_allclose(sums[mask_rows > 0], 1.0, rtol=1e-5)


def test_attention_consistent_with_output(rng):
    """out == S_dense @ Wh per head — the read-back attention reproduces
    the aggregation exactly."""
    A = _graph(rng)
    n = A.n_rows
    x = jnp.asarray(rng.standard_normal((n, 8)).astype(np.float32))
    conv = GATConv(8, 4, nheads=1)
    params = conv.init(jax.random.PRNGKey(1), A, x)
    out, (e, s) = conv.apply(params, A, x, return_attention=True)
    W = params["params"]["weight"]
    Wh = np.asarray(x @ W)
    S = np.asarray(edges_to_dense(A, s[0]))
    np.testing.assert_allclose(np.asarray(out), S @ Wh, rtol=1e-4, atol=1e-5)


def test_quant_backward_matches_full_precision_limit(rng):
    """With a fine grad-out grid the quantized backward converges to the
    exact (reference-math) gradients."""
    A = _graph(rng, n=32)
    n = A.n_rows
    X = jnp.asarray(rng.standard_normal((n, 6)).astype(np.float32))
    W = jnp.asarray(rng.standard_normal((6, 5)).astype(np.float32) * 0.3)
    cal = CalibrationTable.for_qbits(8, dict(go_min=-50.0, go_max=50.0))

    def loss_q(X, W):
        return jnp.sum(gnn_layer_quant_backward(A, X, W, cal.grad_out) ** 2)

    def loss_f(X, W):
        from sgracex1_tpu.ops.spmm import spmm

        return jnp.sum(spmm(A, jnp.dot(X, W)) ** 2)

    gq = jax.grad(loss_q, argnums=(0, 1))(X, W)
    gf = jax.grad(loss_f, argnums=(0, 1))(X, W)
    # coarse grid (range 100, 8 bits -> step ~0.4) still tracks direction
    for a, b in zip(gq, gf):
        a, b = np.asarray(a), np.asarray(b)
        denom = np.abs(b).max() + 1e-9
        assert np.abs(a - b).max() / denom < 0.15


def test_quant_backward_actually_quantizes(rng):
    """A very coarse grad grid must produce different (rounded) gradients."""
    A = _graph(rng, n=32)
    n = A.n_rows
    X = jnp.asarray(rng.standard_normal((n, 6)).astype(np.float32))
    W = jnp.asarray(rng.standard_normal((6, 5)).astype(np.float32))
    cal = CalibrationTable.for_qbits(8)  # go range [-0.1, 0.1] — saturates

    def loss_q(W):
        return jnp.sum(gnn_layer_quant_backward(A, X, W, cal.grad_out) ** 2)

    def loss_f(W):
        from sgracex1_tpu.ops.spmm import spmm

        return jnp.sum(spmm(A, jnp.dot(X, W)) ** 2)

    gq = np.asarray(jax.grad(loss_q)(W))
    gf = np.asarray(jax.grad(loss_f)(W))
    assert not np.allclose(gq, gf)


def test_gat_exact_gradients_differ_and_are_finite(rng):
    """exact_gradients=True must route gradient through the attention
    scores (different W-grad than the reference approximation), same fwd."""
    A = _graph(rng)
    x = jnp.asarray(rng.standard_normal((A.n_rows, 8)).astype(np.float32))
    c_ref = GATConv(8, 4)
    c_exact = GATConv(8, 4, exact_gradients=True)
    params = c_ref.init(jax.random.PRNGKey(0), A, x)

    out_ref = np.asarray(c_ref.apply(params, A, x))
    out_exa = np.asarray(c_exact.apply(params, A, x))
    np.testing.assert_allclose(out_ref, out_exa, rtol=1e-6)

    g_ref = jax.grad(lambda p: jnp.sum(c_ref.apply(p, A, x) ** 2))(params)
    g_exa = jax.grad(lambda p: jnp.sum(c_exact.apply(p, A, x) ** 2))(params)
    wr = np.asarray(g_ref["params"]["weight"])
    we = np.asarray(g_exa["params"]["weight"])
    assert np.all(np.isfinite(we))
    assert not np.allclose(wr, we)  # the score path carries gradient now


def test_gcnconv_go_quant_trains(rng):
    """GCNConv with go_quant set still produces finite grads through flax."""
    A = _graph(rng, n=32)
    x = jnp.asarray(rng.standard_normal((32, 6)).astype(np.float32))
    cal = CalibrationTable.for_qbits(8, dict(go_min=-10.0, go_max=10.0))
    conv = GCNConv(6, 4, go_quant=cal.grad_out)
    params = conv.init(jax.random.PRNGKey(0), A, x)

    def loss(p):
        return jnp.sum(conv.apply(p, A, x, relu=True) ** 2)

    g = jax.grad(loss)(params)
    for leaf in jax.tree.leaves(g):
        assert np.all(np.isfinite(np.asarray(leaf)))
