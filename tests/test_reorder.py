"""RCM reordering: bandwidth reduction, SpMM equivariance, plan shrinkage."""

import numpy as np
import jax.numpy as jnp
import pytest

from sgracex1_tpu.graph.csr import SparseMatrix
from sgracex1_tpu.graph.reorder import rcm_order, permute_graph, bandwidth
from sgracex1_tpu.ops.spmm import spmm


def _banded_graph_shuffled(rng, n=400, band=5):
    """A graph that IS low-bandwidth under some order, randomly relabeled."""
    rows, cols = [], []
    for i in range(n):
        for d in range(-band, band + 1):
            j = i + d
            if 0 <= j < n:
                rows.append(i)
                cols.append(j)
    shuffle = rng.permutation(n)
    r = shuffle[np.array(rows)]
    c = shuffle[np.array(cols)]
    v = rng.uniform(0.5, 1.5, len(r)).astype(np.float32)
    return SparseMatrix.from_coo(r, c, v, (n, n))


def test_rcm_reduces_bandwidth(rng):
    A = _banded_graph_shuffled(rng)
    perm = rcm_order(A)
    B, _ = permute_graph(A, perm)
    assert bandwidth(B) < bandwidth(A) / 4
    assert sorted(perm.tolist()) == list(range(A.n_rows))


def test_native_and_scipy_both_reduce(rng):
    import os
    from sgracex1_tpu.runtime import native

    if not native.available():
        pytest.skip("native runtime not built")
    A = _banded_graph_shuffled(rng, n=200)
    p_nat = rcm_order(A)
    os.environ["SGRACE_NATIVE"] = "0"
    try:
        p_sci = rcm_order(A)
    finally:
        os.environ["SGRACE_NATIVE"] = "1"
    b_nat = bandwidth(permute_graph(A, p_nat)[0])
    b_sci = bandwidth(permute_graph(A, p_sci)[0])
    b_orig = bandwidth(A)
    assert b_nat < b_orig / 4 and b_sci < b_orig / 4


def test_spmm_equivariance(rng):
    """(P A P^T)(P X) == P (A X): aggregation commutes with relabeling."""
    A = _banded_graph_shuffled(rng, n=150)
    X = rng.standard_normal((150, 16)).astype(np.float32)
    perm = rcm_order(A)
    B, inv = permute_graph(A, perm)
    out_direct = np.asarray(spmm(A, jnp.asarray(X)))
    out_perm = np.asarray(spmm(B, jnp.asarray(X[perm])))
    np.testing.assert_allclose(out_perm[inv], out_direct, rtol=1e-5, atol=1e-5)


def _occupied_tiles(M, tb):
    r = np.asarray(M.rows[: M.nnz]).astype(np.int64)
    c = np.asarray(M.cols[: M.nnz]).astype(np.int64)
    return len(np.unique((r // tb) << 32 | (c // tb)))


def test_degree_order_densifies_hub_tiles(rng):
    """Degree sort packs power-law hub edges into fewer, denser tiles:
    the same edges touch fewer (tb x tb) blocks of the adjacency, so the
    gathers of one row block hit fewer distinct feature blocks."""
    from sgracex1_tpu.graph.datasets import powerlaw_node_classification
    from sgracex1_tpu.graph.normalize import sym_norm
    from sgracex1_tpu.graph.reorder import degree_order

    data = powerlaw_node_classification(
        n=4096, avg_degree=16, num_features=4, seed=0
    )
    A = sym_norm(data.edge_index, data.num_nodes)
    # the generator numbers hubs first: shuffle so the sort has work to do
    shuffled, _ = permute_graph(A, rng.permutation(A.n_rows))
    perm = degree_order(shuffled)
    assert sorted(perm.tolist()) == list(range(max(A.n_rows, A.n_cols)))
    B, _ = permute_graph(shuffled, perm)
    for tb in (128, 256):
        assert _occupied_tiles(B, tb) < _occupied_tiles(shuffled, tb)


def test_degree_order_spmm_equivariance(rng):
    from sgracex1_tpu.graph.reorder import degree_order

    A = _banded_graph_shuffled(rng, n=150)
    X = rng.standard_normal((150, 16)).astype(np.float32)
    perm = degree_order(A)
    B, inv = permute_graph(A, perm)
    out_direct = np.asarray(spmm(A, jnp.asarray(X)))
    out_perm = np.asarray(spmm(B, jnp.asarray(X[perm])))
    np.testing.assert_allclose(out_perm[inv], out_direct, rtol=1e-5, atol=1e-5)


def test_plan_shrinks_after_rcm(rng):
    """RCM cuts the number of occupied (256 x 256) adjacency blocks of a
    shuffled banded graph: the edge path's gathers regain locality."""
    A = _banded_graph_shuffled(rng, n=2000, band=3)
    perm = rcm_order(A)
    B, _ = permute_graph(A, perm)
    before, after = _occupied_tiles(A, 256), _occupied_tiles(B, 256)
    assert after < before, (before, after)


@pytest.mark.parametrize("order", ["degree", "random"])
def test_permute_node_data_relabels_consistently(rng, order):
    """Training on the relabelled data is training on the same graph: the
    permuted adjacency from permute_node_data's edges equals permute_graph
    of the original, and features/labels/masks follow their nodes."""
    from sgracex1_tpu.graph.datasets import sbm_node_classification
    from sgracex1_tpu.graph.normalize import sym_norm
    from sgracex1_tpu.graph.reorder import degree_order, permute_node_data

    data = sbm_node_classification(n=120, num_classes=3, seed=1)
    A = sym_norm(data.edge_index, 120)
    perm = degree_order(A) if order == "degree" else rng.permutation(120)
    d2 = permute_node_data(data, perm)
    B, _ = permute_graph(A, perm)
    np.testing.assert_allclose(
        sym_norm(d2.edge_index, 120).to_dense(), B.to_dense(), rtol=1e-6
    )
    np.testing.assert_array_equal(d2.x, data.x[perm])
    np.testing.assert_array_equal(d2.y, data.y[perm])
    for m in ("train_mask", "val_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(d2, m), getattr(data, m)[perm])
