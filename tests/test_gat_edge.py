"""GATConv's batched edge path against a dense reference: every head, both
gradient modes, f32 and bf16 features, and the edge cases the edge softmax
must get right (zero-valued edges, self-loops, rows without edges)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sgracex1_tpu.graph.csr import SparseMatrix
from sgracex1_tpu.graph.normalize import sym_norm
from sgracex1_tpu.nn.layers import GATConv
from sgracex1_tpu.ops.dispatch import prepare_adjacency
from sgracex1_tpu.ops.sddmm import gat_attention_agg_ref
from tests.conftest import make_random_graph

HI = jax.lax.Precision.HIGHEST


def _dense_gat(Ad, x, W, att, heads, F, alpha=0.2, exact=False):
    """Dense masked-softmax GAT (the reference's emulation form,
    sgrace.py:634-657), jnp so it can be differentiated."""
    Wh = jnp.dot(x, W, precision=HI).reshape(-1, heads, F)
    Ws = Wh if exact else jax.lax.stop_gradient(Wh)
    a = att.reshape(-1)
    s1 = jnp.einsum("nhf,hf->nh", Ws, a[: heads * F].reshape(heads, F),
                    precision=HI)
    s2 = jnp.einsum("nhf,hf->nh", Ws, a[heads * F:].reshape(heads, F),
                    precision=HI)
    e = s1[:, None, :] + s2[None, :, :]  # [N, N, H]
    e = jnp.where(e > 0, e, alpha * e)
    mask = (Ad > 0)[:, :, None]
    e = jnp.where(mask, e, -jnp.inf)
    m = jnp.max(e, axis=1, keepdims=True)
    m = jnp.where(jnp.isfinite(m), m, 0.0)
    p = jnp.where(mask, jnp.exp(e - m), 0.0)
    den = jnp.sum(p, axis=1, keepdims=True)
    p = p / jnp.where(den > 0, den, 1.0)
    return jnp.einsum("ijh,jhf->ihf", p, Wh, precision=HI).reshape(
        -1, heads * F
    )


def _graph(rng, n=48, kind="plain"):
    ei = make_random_graph(rng, n, avg_degree=3, self_loops=False)
    if kind == "self_loops":
        return sym_norm(ei, n, fill=1.0)
    if kind == "isolated":
        keep = (ei[0] >= 4) & (ei[1] >= 4)  # rows/cols 0-3 lose every edge
        A = SparseMatrix.from_coo(
            ei[0][keep], ei[1][keep], np.ones(keep.sum(), np.float32), (n, n)
        )
        return A
    A = sym_norm(ei, n)  # fill=0 self-loops: zero-valued edges
    if kind == "zero_vals":
        v = np.asarray(A.vals).copy()
        v[: A.nnz : 3] = 0.0  # every third edge becomes a non-edge
        A = A.with_vals(jnp.asarray(v))
    return A


def _setup(rng, heads, F=4, f_in=6, n=48, kind="plain", dtype=jnp.float32):
    A = _graph(rng, n, kind)
    x = jnp.asarray(rng.standard_normal((n, f_in)).astype(np.float32), dtype)
    conv = GATConv(f_in, F, nheads=heads)
    v = conv.init(jax.random.PRNGKey(heads), A, x)
    Ad = jnp.asarray(A.to_dense())
    return A, Ad, x, conv, v


@pytest.mark.parametrize("heads", [1, 2, 4])
@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_gatconv_forward_matches_dense(rng, heads, exact, dtype):
    A, Ad, x, _, v = _setup(rng, heads, dtype=dtype)
    conv = GATConv(6, 4, nheads=heads, exact_gradients=exact)
    with jax.default_matmul_precision("highest"):
        out = conv.apply(v, A, x)
    p = v["params"]
    ref = _dense_gat(Ad, x.astype(jnp.float32), p["weight"], p["attention"],
                     heads, 4)
    assert out.shape == (48, 4 * heads) and out.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("kind", ["zero_vals", "self_loops", "isolated"])
@pytest.mark.parametrize("heads", [1, 3])
def test_gatconv_edge_cases_match_dense(rng, kind, heads):
    A, Ad, x, conv, v = _setup(rng, heads, kind=kind)
    with jax.default_matmul_precision("highest"):
        out = np.asarray(conv.apply(v, A, x))
    p = v["params"]
    ref = np.asarray(_dense_gat(Ad, x, p["weight"], p["attention"], heads, 4))
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
    if kind == "isolated":
        np.testing.assert_array_equal(out[:4], 0.0)  # no edges, no output


@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("exact", [False, True])
def test_gatconv_gradients_match_dense(rng, heads, exact):
    A, Ad, x, _, v = _setup(rng, heads)
    conv = GATConv(6, 4, nheads=heads, exact_gradients=exact)
    tgt = jnp.asarray(rng.standard_normal((48, 4 * heads)).astype(np.float32))

    def loss_edge(p, x):
        return jnp.sum((conv.apply({"params": p}, A, x) - tgt) ** 2)

    def loss_dense(p, x):
        out = _dense_gat(Ad, x, p["weight"], p["attention"], heads, 4,
                         exact=exact)
        return jnp.sum((out - tgt) ** 2)

    with jax.default_matmul_precision("highest"):
        ge = jax.grad(loss_edge, argnums=(0, 1))(v["params"], x)
        gd = jax.grad(loss_dense, argnums=(0, 1))(v["params"], x)
    for a, b in zip(jax.tree.leaves(ge), jax.tree.leaves(gd)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-4,
                                   atol=2e-5)
    # the attention vector only receives gradient in exact mode... and in
    # both modes through the softmax weights' effect on the output
    assert np.abs(np.asarray(ge[0]["attention"])).sum() > 0


@pytest.mark.parametrize("method", ["xla", "dense"])
def test_gatconv_on_prepared_adjacency(rng, method):
    """GATConv reads the edge list of any prepared backend."""
    A, Ad, x, conv, v = _setup(rng, 2)
    prep = prepare_adjacency(A, method=method)
    with jax.default_matmul_precision("highest"):
        np.testing.assert_allclose(
            np.asarray(conv.apply(v, prep, x)),
            np.asarray(conv.apply(v, A, x)), rtol=1e-6, atol=1e-6,
        )


@pytest.mark.parametrize("heads", [None, 1, 3])
def test_gat_attention_agg_ref_matches_dense(rng, heads):
    """The plain reference (ops/sddmm.py) in its single-head ([N] scores,
    [N, F] features) and multi-head ([N, H], [N, H, F]) forms."""
    A = _graph(rng, 40, "zero_vals")
    Ad = np.asarray(A.to_dense())
    H = heads or 1
    s1 = rng.standard_normal((40, H)).astype(np.float32)
    s2 = rng.standard_normal((40, H)).astype(np.float32)
    wh = rng.standard_normal((40, H, 5)).astype(np.float32)
    e = s1[:, None, :] + s2[None, :, :]
    e = np.where(e > 0, e, 0.2 * e)
    mask = (Ad > 0)[:, :, None]
    p = np.where(mask, np.exp(e - np.where(mask, e, -np.inf).max(1, keepdims=True)), 0)
    p = p / np.maximum(p.sum(1, keepdims=True), 1e-30)
    ref = np.einsum("ijh,jhf->ihf", p, wh)
    if heads is None:
        out = gat_attention_agg_ref(A, jnp.asarray(s1[:, 0]),
                                    jnp.asarray(s2[:, 0]),
                                    jnp.asarray(wh[:, 0]))
        ref = ref[:, 0]
    else:
        out = gat_attention_agg_ref(A, jnp.asarray(s1), jnp.asarray(s2),
                                    jnp.asarray(wh))
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-4, atol=1e-5)
