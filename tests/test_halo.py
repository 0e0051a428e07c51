"""Halo-exchange distributed SpMM: parity with single-chip and gradients."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sgracex1_tpu.graph.csr import SparseMatrix
from sgracex1_tpu.graph.normalize import sym_norm
from sgracex1_tpu.ops.spmm import spmm
from sgracex1_tpu.parallel.mesh import make_mesh
from sgracex1_tpu.parallel.halo import (
    build_halo,
    dist_spmm_halo,
    dist_gnn_layer_halo,
    dist_gat_layer_halo,
)
from sgracex1_tpu.parallel.partition import pad_nodes
from tests.conftest import make_random_graph

from jax.sharding import NamedSharding, PartitionSpec as P


def _setup(rng, n, n_dev, f=12):
    ei = make_random_graph(rng, n)
    A = sym_norm(ei, n)
    G, n_pad = build_halo(A, n_dev)
    mesh = make_mesh(n_dev)
    sh = NamedSharding(mesh, P("graph"))
    H = rng.standard_normal((n, f)).astype(np.float32)
    H_d = jax.device_put(pad_nodes(H, n_pad), sh)
    G_d = jax.device_put(G, sh)
    return A, G_d, mesh, H, H_d, n_pad


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_halo_spmm_matches_single(rng, n_dev):
    n = 96
    A, G, mesh, H, H_d, n_pad = _setup(rng, n, n_dev)
    out = np.asarray(jax.jit(
        lambda h: dist_spmm_halo(mesh, G, h)
    )(H_d))[:n]
    expect = np.asarray(spmm(A, jnp.asarray(H)))
    np.testing.assert_allclose(out, expect, rtol=1e-5, atol=1e-5)


def test_halo_comm_is_smaller_than_allgather(rng):
    """The halo buffer must be smaller than replicating all of H."""
    n, n_dev = 512, 8
    ei = make_random_graph(rng, n, avg_degree=4)
    A = sym_norm(ei, n)
    G, n_pad = build_halo(A, n_dev)
    # per shard, all_to_all moves S*L rows; all_gather moves n_pad
    assert G.n_shards * G.halo_len < n_pad


def test_halo_gradients_match(rng):
    n, n_dev, f, h = 64, 4, 8, 6
    A, G, mesh, X, X_d, n_pad = _setup(rng, n, n_dev, f=f)
    W = jnp.asarray(rng.standard_normal((f, h)).astype(np.float32) * 0.3)

    def loss_dist(xv, Wv):
        return jnp.sum(dist_gnn_layer_halo(mesh, G, xv, Wv, relu=True) ** 2)

    def loss_single(xv, Wv):
        Hh = jnp.dot(xv, Wv)
        out = spmm(A, Hh)
        return jnp.sum(jnp.maximum(out, 0.0) ** 2)

    gd = jax.grad(loss_dist, argnums=(0, 1))(X_d, W)
    gs = jax.grad(loss_single, argnums=(0, 1))(jnp.asarray(X), W)
    np.testing.assert_allclose(
        np.asarray(gd[0])[:n], np.asarray(gs[0]), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(gd[1]), np.asarray(gs[1]), rtol=1e-4, atol=1e-5
    )


@pytest.mark.parametrize("n_dev", [2, 8])
def test_halo_gat_matches_single(rng, n_dev):
    from sgracex1_tpu.ops.fused_gnn import gat_layer

    n, f, h = 96, 10, 7
    A, G, mesh, X, X_d, n_pad = _setup(rng, n, n_dev, f=f)
    W = jnp.asarray(rng.standard_normal((f, h)).astype(np.float32) * 0.3)
    att = jnp.asarray(rng.standard_normal((2 * h, 1)).astype(np.float32))

    out = np.asarray(jax.jit(
        lambda xv: dist_gat_layer_halo(mesh, G, xv, W, att, relu=True)
    )(X_d))[:n]
    expect = np.asarray(gat_layer(A, jnp.asarray(X), W, att, relu=True))
    np.testing.assert_allclose(out, expect, rtol=1e-4, atol=1e-5)


def test_halo_gat_multihead_matches_single(rng):
    """2-head distributed GAT == single-chip GATConv (same params)."""
    import jax.numpy as jnp
    from sgracex1_tpu.nn.layers import GATConv

    n, f, F, H, n_dev = 64, 10, 5, 2, 4
    A, G, mesh, X, X_d, n_pad = _setup(rng, n, n_dev, f=f)
    conv = GATConv(f, F, nheads=H)
    params = conv.init(jax.random.PRNGKey(3), A, jnp.asarray(X))
    W = params["params"]["weight"]
    att = params["params"]["attention"]

    expect = np.asarray(conv.apply(params, A, jnp.asarray(X), relu=True))
    out = np.asarray(
        dist_gat_layer_halo(mesh, G, X_d, W, att, relu=True, nheads=H)
    )[:n]
    np.testing.assert_allclose(out, expect, rtol=1e-4, atol=1e-5)


def test_halo_handles_no_remote_edges(rng):
    """Block-diagonal graph: every edge local, halo lists empty."""
    n_dev = 4
    n = 64
    # edges only within 16-node blocks aligned to the shard boundaries
    rows, cols = [], []
    g = np.random.default_rng(0)
    for b in range(n_dev):
        lo = b * 16
        rr = g.integers(lo, lo + 16, 40)
        cc = g.integers(lo, lo + 16, 40)
        rows.extend(rr)
        cols.extend(cc)
    A = SparseMatrix.from_coo(
        np.array(rows), np.array(cols),
        np.ones(len(rows), np.float32), (n, n),
    )
    G, n_pad = build_halo(A, n_dev)
    mesh = make_mesh(n_dev)
    sh = NamedSharding(mesh, P("graph"))
    H = g.standard_normal((n_pad, 8)).astype(np.float32)
    out = np.asarray(
        dist_spmm_halo(mesh, jax.device_put(G, sh), jax.device_put(H, sh))
    )
    expect = np.asarray(spmm(A, jnp.asarray(H[:n])))
    np.testing.assert_allclose(out[:n], expect, rtol=1e-5, atol=1e-5)
