"""The in-repo module system (sgracex1_tpu/nn/module.py) that replaced
flax: init/apply signatures, parameter-tree names, sow, remat, dropout and
the train state."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from sgracex1_tpu.graph.normalize import sym_norm
from sgracex1_tpu.nn import module as M
from sgracex1_tpu.nn.models import GATModel, GCNModel, MoleculeGCN
from tests.conftest import make_random_graph


def _graph(rng, n=40, f=6):
    A = sym_norm(make_random_graph(rng, n), n)
    x = jnp.asarray(rng.standard_normal((n, f)).astype(np.float32))
    return A, x


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield "/".join(prefix), tree.shape


@pytest.mark.parametrize(
    "model,expect",
    [
        (GCNModel(num_features=6, hidden_channels=8, num_classes=3),
         {"conv1/weight": (6, 8), "conv2/weight": (8, 8),
          "Dense_0/kernel": (8, 3), "Dense_0/bias": (3,)}),
        (GCNModel(num_features=6, hidden_channels=8, num_classes=3,
                  num_layers=3),
         {"conv1/weight": (6, 8), "conv2/weight": (8, 8),
          "conv3/weight": (8, 8), "Dense_0/kernel": (8, 3),
          "Dense_0/bias": (3,)}),
        (GATModel(num_features=6, hidden_channels=4, num_classes=3,
                  nheads=2),
         {"conv1/weight": (6, 8), "conv1/attention": (16, 1),
          "conv2/weight": (8, 4), "conv2/attention": (8, 1),
          "Dense_0/kernel": (4, 3), "Dense_0/bias": (3,)}),
    ],
)
def test_init_parameter_tree(rng, model, expect):
    A, x = _graph(rng)
    variables = model.init(jax.random.PRNGKey(0), A, x)
    assert set(variables) == {"params"}
    assert dict(_paths(variables["params"])) == expect


def test_molecule_model_tree(rng):
    A, x = _graph(rng)
    model = MoleculeGCN(num_features=6, hidden_channels=5, num_classes=2)
    gid = jnp.asarray(np.repeat([0, 1], 20))
    variables = model.init(jax.random.PRNGKey(0), A, x, gid, 2)
    assert dict(_paths(variables["params"])) == {
        "conv1/weight": (6, 5), "conv2/weight": (5, 5),
        "Dense_0/kernel": (5, 2), "Dense_0/bias": (2,),
    }
    out = model.apply(variables, A, x, gid, 2)
    assert out.shape == (2, 2)


def test_init_keys_differ_per_parameter(rng):
    A, x = _graph(rng)
    model = GCNModel(num_features=8, hidden_channels=8, num_classes=3)
    p = model.init(jax.random.PRNGKey(0), A, jnp.zeros((40, 8)))["params"]
    assert not np.allclose(p["conv1"]["weight"], p["conv2"]["weight"])
    p2 = model.init(jax.random.PRNGKey(0), A, jnp.zeros((40, 8)))["params"]
    np.testing.assert_array_equal(p["conv1"]["weight"], p2["conv1"]["weight"])


def test_apply_is_deterministic_and_jittable(rng):
    A, x = _graph(rng)
    model = GCNModel(num_features=6, hidden_channels=8, num_classes=3)
    v = model.init(jax.random.PRNGKey(1), A, x)
    a = model.apply(v, A, x)
    b = jax.jit(model.apply)(v, A, x)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                               atol=1e-6)


def test_sow_collects_telemetry_only_when_mutable(rng):
    A, x = _graph(rng)
    model = GCNModel(num_features=6, hidden_channels=8, num_classes=3)
    v = model.init(jax.random.PRNGKey(1), A, x)
    out, col = model.apply(v, A, x, mutable=["telemetry"])
    assert set(col["telemetry"]) == {"conv1", "conv2"}
    tel = col["telemetry"]["conv1"]
    assert set(tel) == {"x_amax", "w_absmax", "wh_absmax"}
    np.testing.assert_allclose(float(tel["x_amax"][0]),
                               float(jnp.max(jnp.abs(x))))
    # without mutable, apply returns the output alone
    np.testing.assert_allclose(np.asarray(model.apply(v, A, x)),
                               np.asarray(out))


def test_mutable_must_be_a_list(rng):
    A, x = _graph(rng)
    model = GCNModel(num_features=6, hidden_channels=8, num_classes=3)
    v = model.init(jax.random.PRNGKey(1), A, x)
    with pytest.raises(TypeError):
        model.apply(v, A, x, mutable=True)


@pytest.mark.parametrize("cls", [GCNModel, GATModel])
def test_remat_matches_plain(rng, cls):
    A, x = _graph(rng)
    kw = dict(num_features=6, hidden_channels=4, num_classes=3)
    plain, remat = cls(**kw), cls(**kw, remat=True)
    v = plain.init(jax.random.PRNGKey(2), A, x)
    assert jax.tree.structure(v) == jax.tree.structure(
        remat.init(jax.random.PRNGKey(2), A, x)
    )

    def loss(m):
        return lambda p: jnp.sum(m.apply(p, A, x) ** 2)

    l0, g0 = jax.value_and_grad(loss(plain))(v)
    l1, g1 = jax.value_and_grad(loss(remat))(v)
    np.testing.assert_allclose(float(l0), float(l1), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(g0), jax.tree.leaves(g1)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)


def test_dropout_needs_rng_and_scales(rng):
    A, x = _graph(rng)
    model = GCNModel(num_features=6, hidden_channels=64, num_classes=3)
    v = model.init(jax.random.PRNGKey(1), A, x)
    with pytest.raises(KeyError, match="rngs"):
        model.apply(v, A, x, training=True)
    a = model.apply(v, A, x, training=True,
                    rngs={"dropout": jax.random.PRNGKey(3)})
    b = model.apply(v, A, x, training=True,
                    rngs={"dropout": jax.random.PRNGKey(4)})
    assert not np.allclose(np.asarray(a), np.asarray(b))


def test_dropout_module_statistics():
    class Wrap(M.Module):
        def __call__(self, x):
            return M.Dropout(0.25)(x)

    x = jnp.ones((200, 50))
    out = Wrap().apply({"params": {}}, x,
                       rngs={"dropout": jax.random.PRNGKey(0)})
    kept = np.asarray(out) != 0
    assert abs(kept.mean() - 0.75) < 0.02
    np.testing.assert_allclose(np.asarray(out)[kept], 1.0 / 0.75, rtol=1e-6)


def test_child_names_count_per_class():
    class Two(M.Module):
        def __call__(self, x):
            return M.Dense(3)(M.Dense(4)(x))

    v = Two().init(jax.random.PRNGKey(0), jnp.ones((2, 5)))
    assert dict(_paths(v["params"])) == {
        "Dense_0/kernel": (5, 4), "Dense_0/bias": (4,),
        "Dense_1/kernel": (4, 3), "Dense_1/bias": (3,),
    }


def test_missing_parameter_raises(rng):
    A, x = _graph(rng)
    model = GCNModel(num_features=6, hidden_channels=8, num_classes=3)
    v = model.init(jax.random.PRNGKey(1), A, x)
    del v["params"]["conv2"]
    with pytest.raises(KeyError):
        model.apply(v, A, x)


def test_module_call_outside_init_apply_raises(rng):
    with pytest.raises(RuntimeError, match="outside init/apply"):
        M.Dense(3)(jnp.ones((2, 2)))


def test_dense_matches_formula():
    v = M.Dense(3).init(jax.random.PRNGKey(0), jnp.ones((2, 4)))
    p = v["params"]
    assert set(p) == {"kernel", "bias"}
    x = jnp.arange(8.0).reshape(2, 4)
    np.testing.assert_allclose(
        np.asarray(M.Dense(3).apply(v, x)),
        np.asarray(x @ p["kernel"] + p["bias"]), rtol=1e-6,
    )


def test_train_state_matches_optax():
    params = {"w": jnp.arange(4.0), "b": jnp.ones(2)}
    tx = optax.adam(0.1)
    st = M.TrainState.create(apply_fn=None, params=params, tx=tx)
    grads = {"w": jnp.ones(4), "b": -jnp.ones(2)}
    st2 = jax.jit(lambda s, g: s.apply_gradients(grads=g))(st, grads)
    upd, _ = tx.update(grads, tx.init(params), params)
    ref = optax.apply_updates(params, upd)
    assert int(st2.step) == 1
    for k in params:
        np.testing.assert_allclose(np.asarray(st2.params[k]),
                                   np.asarray(ref[k]), rtol=1e-6)
    assert st2.replace(step=st2.step + 1).step == 2
