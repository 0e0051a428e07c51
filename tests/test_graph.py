"""Graph container, normalization, and loader tests."""

import numpy as np
import pytest
import scipy.sparse as sp

from sgracex1_tpu.graph.csr import SparseMatrix
from sgracex1_tpu.graph.normalize import sym_norm, sym_norm_edges
from sgracex1_tpu.graph import io


def test_sparse_roundtrip(rng):
    dense = (rng.random((37, 53)) < 0.1) * rng.standard_normal((37, 53))
    A = SparseMatrix.from_dense(dense.astype(np.float32))
    np.testing.assert_allclose(np.asarray(A.to_dense()), dense, atol=1e-6)
    assert A.nnz == np.count_nonzero(dense)
    assert A.e_pad % 128 == 0


def test_from_scipy_and_back(rng):
    m = sp.random(40, 60, density=0.05, format="csr", random_state=7)
    A = SparseMatrix.from_scipy(m)
    got = A.to_scipy().toarray()
    np.testing.assert_allclose(got, m.toarray(), atol=1e-6)


def test_transpose(rng):
    dense = (rng.random((20, 30)) < 0.2) * rng.standard_normal((20, 30))
    A = SparseMatrix.from_dense(dense.astype(np.float32))
    np.testing.assert_allclose(
        np.asarray(A.transpose().to_dense()), dense.T, atol=1e-6
    )


def test_rowptr(rng):
    m = sp.random(25, 25, density=0.1, format="csr", random_state=3)
    A = SparseMatrix.from_scipy(m)
    np.testing.assert_array_equal(A.rowptr(), m.indptr)


def test_sym_norm_matches_formula(random_graph):
    n = 64
    ei, w = sym_norm_edges(random_graph, n)
    # rebuild dense and check D^-1/2 (A + I·fill) D^-1/2 with fill=0
    A = np.zeros((n, n))
    A[random_graph[0], random_graph[1]] = 1.0
    # self loops added with fill 0 don't change values
    deg = A.sum(axis=1)
    dis = np.where(deg > 0, deg**-0.5, 0.0)
    expect = dis[:, None] * A * dis[None, :]
    got = np.zeros((n, n))
    np.add.at(got, (ei[0], ei[1]), w)
    np.testing.assert_allclose(got, expect, atol=1e-6)
    # every node has a self-loop entry present (possibly zero-valued)
    loops = ei[0] == ei[1]
    assert len(np.unique(ei[0, loops])) == n


def test_sym_norm_sparse_container(random_graph):
    A = sym_norm(random_graph, 64)
    assert A.shape == (64, 64)
    assert A.nnz >= random_graph.shape[1]


def test_load_csr_text(tmp_path):
    p = tmp_path / "m.txt"
    p.write_text("0,2,3,3\n0,2,1\n1.5,2.5,3.5\n")
    A = io.load_csr_text(str(p), 3)
    expect = np.array([[1.5, 0, 2.5], [0, 3.5, 0], [0, 0, 0]], np.float32)
    np.testing.assert_allclose(np.asarray(A.to_dense()), expect)


def test_load_csr_text_no_values(tmp_path):
    p = tmp_path / "m.txt"
    p.write_text("0,2,2\n0,1\n")
    A = io.load_csr_text(str(p), 2)
    np.testing.assert_allclose(
        np.asarray(A.to_dense()), np.array([[1, 1], [0, 0]], np.float32)
    )


def test_load_dense_text(tmp_path):
    p = tmp_path / "w.txt"
    p.write_text("1.0,2.0\n3.0,4.0\n")
    np.testing.assert_allclose(io.load_dense_text(str(p)), [[1, 2], [3, 4]])


@pytest.mark.skipif(
    io.reference_data_dir() is None, reason="reference datasets not mounted"
)
def test_load_reference_mol():
    adj, fea, w = io.load_reference_dataset("mol")
    assert adj.shape == (2273, 2273)
    assert fea.shape == (2273, 7)
    assert w.shape[0] == 7  # hidden width comes from the file (64 for mol)
    assert adj.nnz == 5028
    # features are one-hot (dense file cross-check)
    ddir = io.reference_data_dir()
    dense = io.load_dense_text(f"{ddir}/mol_feat_dense.txt")
    np.testing.assert_allclose(np.asarray(fea.to_dense()), dense)
