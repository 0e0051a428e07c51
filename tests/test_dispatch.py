"""Aggregation backend dispatch tests (dense / xla parity, the chooser)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from sgracex1_tpu.graph.csr import SparseMatrix
from sgracex1_tpu.ops.dispatch import prepare_adjacency, agg_matmul


def _graph(rng, n=260, density=0.05):
    mat = sp.random(n, n, density=density, format="csr", random_state=21).astype(
        np.float32
    )
    mat.setdiag(0.5)
    return SparseMatrix.from_scipy(mat), mat


@pytest.mark.parametrize("method", ["dense", "xla"])
def test_agg_matmul_parity(rng, method):
    A, mat = _graph(rng)
    prep = prepare_adjacency(A, method=method)
    H = rng.standard_normal((A.n_cols, 128)).astype(np.float32)
    out = np.asarray(agg_matmul(prep, jnp.asarray(H)))
    np.testing.assert_allclose(out, mat @ H, rtol=5e-2, atol=5e-2)


def test_auto_selects_dense_for_small(rng):
    A, _ = _graph(rng)
    prep = prepare_adjacency(A, method="auto")
    assert prep.kind == "dense"
    assert prep.dense is not None


def test_dense_backward(rng):
    A, mat = _graph(rng)
    prep = prepare_adjacency(A, method="dense", dense_dtype=jnp.float32)
    H = jnp.asarray(rng.standard_normal((A.n_cols, 64)).astype(np.float32))
    v = rng.standard_normal((A.n_rows, 64)).astype(np.float32)
    g = jax.grad(lambda h: jnp.vdot(agg_matmul(prep, h), v))(H)
    np.testing.assert_allclose(np.asarray(g), mat.T @ v, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("method", ["xla", "dense"])
def test_training_through_prepared_backend(rng, method):
    """Full training step through a PreparedAdjacency backend — pins the
    dispatcher's integration with the module system in real training."""
    import optax
    from sgracex1_tpu.graph.normalize import sym_norm
    from sgracex1_tpu.nn.models import GCNModel
    from tests.conftest import make_random_graph

    n = 150
    A = sym_norm(make_random_graph(rng, n), n)
    prep = prepare_adjacency(A, method=method)
    x = jnp.asarray(rng.standard_normal((n, 8)).astype(np.float32))
    y = jnp.asarray(rng.integers(0, 3, n).astype(np.int32))

    model = GCNModel(num_features=8, hidden_channels=8, num_classes=3)
    params = model.init(jax.random.PRNGKey(0), prep, x)
    opt = optax.adam(0.05)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state):
        def loss_fn(p):
            logits = model.apply(p, prep, x)
            return jnp.mean(
                optax.softmax_cross_entropy_with_integer_labels(logits, y)
            )

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    losses = []
    for _ in range(8):
        params, opt_state, loss = step(params, opt_state)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses  # it optimizes


def test_prepared_adjacency_under_jit(rng):
    A, mat = _graph(rng)
    prep = prepare_adjacency(A, method="dense")
    H = jnp.asarray(rng.standard_normal((A.n_cols, 32)).astype(np.float32))
    out = np.asarray(jax.jit(agg_matmul)(prep, H))
    np.testing.assert_allclose(out, mat @ H, rtol=5e-2, atol=5e-2)


def test_auto_cost_model_beyond_dense_budget(rng):
    """Past the dense byte budget the cost model must pick the edge path,
    even where the dense matmul would model cheaper."""
    from sgracex1_tpu.ops.dispatch import _estimate_backend_costs

    A, _ = _graph(rng, n=2048, density=0.02)
    costs = _estimate_backend_costs(A)
    assert set(costs) == {"dense", "xla"}
    assert costs["dense"] < costs["xla"]
    assert prepare_adjacency(A, method="auto").kind == "dense"
    # force the dense budget below this graph's dense bytes (2048^2 * 2)
    prep = prepare_adjacency(A, method="auto", dense_max_bytes=1 << 20)
    assert prep.kind == "xla" and prep.dense is None


@pytest.mark.parametrize(
    "n,density,expect",
    [
        (256, 0.05, "dense"),
        (1024, 0.01, "dense"),
        (2048, 0.001, "xla"),
        (4096, 0.0005, "xla"),
    ],
)
def test_auto_chooser_follows_density(rng, n, density, expect):
    """The measured cost model sends dense-enough graphs to the dense
    matmul and sparse ones to the edge path (break-even density =
    _DENSE_ELT_S / _EDGE_S, about 2.5e-3)."""
    from sgracex1_tpu.ops.dispatch import _DENSE_ELT_S, _EDGE_S

    A, _ = _graph(rng, n=n, density=density)
    assert prepare_adjacency(A, method="auto").kind == expect
    assert (A.nnz / n**2 > _DENSE_ELT_S / _EDGE_S) == (expect == "dense")


def test_unknown_method_raises(rng):
    A, _ = _graph(rng, n=64)
    for method in ("bsr", "hybrid", "pallas", "fused"):
        with pytest.raises(ValueError, match="unknown method"):
            prepare_adjacency(A, method=method)


@pytest.mark.parametrize("method", ["dense", "xla"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_agg_matmul_keeps_feature_dtype(rng, method, dtype):
    A, mat = _graph(rng, n=200)
    prep = prepare_adjacency(A, method=method)
    H = rng.standard_normal((A.n_cols, 48)).astype(np.float32)
    out = agg_matmul(prep, jnp.asarray(H, dtype))
    assert out.dtype == dtype and out.shape == (A.n_rows, 48)
    np.testing.assert_allclose(
        np.asarray(out, np.float32), mat @ H, rtol=5e-2, atol=1e-1
    )


@pytest.mark.parametrize("method", ["dense", "xla"])
def test_agg_matmul_backward_matches_transpose(rng, method):
    A, mat = _graph(rng, n=200)
    prep = prepare_adjacency(A, method=method)
    H = jnp.asarray(rng.standard_normal((A.n_cols, 32)).astype(np.float32))
    v = rng.standard_normal((A.n_rows, 32)).astype(np.float32)
    g = jax.grad(lambda h: jnp.vdot(agg_matmul(prep, h), v))(H)
    np.testing.assert_allclose(np.asarray(g), mat.T @ v, rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("method", ["dense", "xla"])
def test_map_adjacency_vals_remaps_every_representation(rng, method):
    from sgracex1_tpu.ops.dispatch import map_adjacency_vals

    A, mat = _graph(rng, n=150)
    prep = map_adjacency_vals(
        prepare_adjacency(A, method=method, dense_dtype=jnp.float32),
        lambda v: v * 2.0,
    )
    assert prep.kind == method
    H = rng.standard_normal((A.n_cols, 16)).astype(np.float32)
    out = np.asarray(agg_matmul(prep, jnp.asarray(H)))
    np.testing.assert_allclose(out, 2.0 * (mat @ H), rtol=1e-4, atol=1e-4)
