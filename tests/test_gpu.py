"""Tests that need an NVIDIA GPU: the main paths compiled for the card
against host references. They skip elsewhere; on a machine with a card run

    SGRACE_TEST_GPU=1 python -m pytest tests/ -m gpu
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def _graph(n, seed=0):
    from sgracex1_tpu.graph.datasets import powerlaw_node_classification
    from sgracex1_tpu.graph.normalize import sym_norm

    data = powerlaw_node_classification(
        n=n, avg_degree=16, num_features=32, num_classes=5, seed=seed
    )
    return data, sym_norm(data.edge_index, n)


def test_edge_spmm_on_gpu_matches_scipy(gpu):
    import jax
    import jax.numpy as jnp

    from sgracex1_tpu.ops.spmm import spmm

    _, A = _graph(1 << 14)
    H = np.random.default_rng(0).standard_normal((A.n_cols, 64))
    out = jax.jit(spmm)(A.device(), jnp.asarray(H, jnp.float32))
    assert out.devices() == {gpu}
    ref = A.to_scipy().astype(np.float64) @ H
    err = np.abs(np.asarray(out) - ref).max() / np.abs(ref).max()
    assert err < 1e-5, err


def test_int8_dot_on_gpu_is_exact(gpu):
    import jax
    import jax.numpy as jnp

    from sgracex1_tpu.quant import int8 as qi8

    rng = np.random.default_rng(1)
    us = rng.integers(-128, 128, (512, 256)).astype(np.int8)
    sq = rng.integers(-127, 128, (256, 64)).astype(np.int8)
    acc = jax.jit(qi8.matmul_unsigned_x_signed)(jnp.asarray(us),
                                               jnp.asarray(sq))
    ref = (us.astype(np.int64) + 128) @ sq.astype(np.int64)
    np.testing.assert_array_equal(np.asarray(acc), ref)


def test_gatconv_on_gpu_matches_edge_reference(gpu):
    import jax
    import jax.numpy as jnp

    from sgracex1_tpu.nn.layers import GATConv
    from sgracex1_tpu.ops.sddmm import gat_attention_agg_ref

    data, A = _graph(1 << 13, seed=2)
    x = jnp.asarray(data.x)
    conv = GATConv(32, 8, nheads=4)
    v = conv.init(jax.random.PRNGKey(0), A, x)
    with jax.default_matmul_precision("highest"):
        out = np.asarray(jax.jit(conv.apply)(v, A.device(), x))
    p = jax.device_get(v["params"])
    with jax.default_device(jax.devices("cpu")[0]):
        Wh = jnp.asarray(data.x @ np.asarray(p["weight"])).reshape(-1, 4, 8)
        a = np.asarray(p["attention"]).reshape(-1)
        s1 = jnp.einsum("nhf,hf->nh", Wh, a[:32].reshape(4, 8))
        s2 = jnp.einsum("nhf,hf->nh", Wh, a[32:].reshape(4, 8))
        ref = np.asarray(gat_attention_agg_ref(A, s1, s2, Wh)).reshape(-1, 32)
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-4


def test_gcn_training_on_gpu_learns(gpu):
    from sgracex1_tpu.config import SGRACEConfig
    from sgracex1_tpu.nn.models import GCNModel
    from sgracex1_tpu.train.loop import train_node_classifier

    data, _ = _graph(1 << 14, seed=3)
    model = GCNModel(num_features=32, hidden_channels=64, num_classes=5)
    cfg = SGRACEConfig(num_epochs=20, learning_rate=0.01)
    _, hist = train_node_classifier(model, data, cfg)
    assert np.isfinite(hist.loss).all()
    assert hist.loss[-1] < hist.loss[0]
    assert hist.backend == "xla"
