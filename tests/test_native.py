"""Native C++ host runtime vs pure-Python spec parity.

The Python implementations in graph/io.py, graph/normalize.py and
graph/reorder.py are the spec; csrc/sgrace_host.cpp must match them
bit-for-bit on integers and to float32 rounding on values.
"""

import os

import numpy as np
import pytest

from sgracex1_tpu.runtime import native


pytestmark = pytest.mark.skipif(
    not native.available(), reason="native runtime not built"
)


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def test_csr_text_parity(tmp_path):
    path = _write(
        tmp_path,
        "m.txt",
        "0,2,3,6,\n1,2,0,0,1,2,\n1.5,2.5,3.5,4.5,5.5,6.5,\n",
    )
    rowptr, cols, vals = native.load_csr_text(path)
    assert rowptr.tolist() == [0, 2, 3, 6]
    assert cols.tolist() == [1, 2, 0, 0, 1, 2]
    assert vals.tolist() == [1.5, 2.5, 3.5, 4.5, 5.5, 6.5]


def test_csr_text_missing_values_line(tmp_path):
    path = _write(tmp_path, "m.txt", "0,1,3\n0,1,2\n")
    rowptr, cols, vals = native.load_csr_text(path)
    assert vals.tolist() == [1.0, 1.0, 1.0]


def test_csr_text_truncated_values(tmp_path):
    # some reference files truncate the values line — pad with 1.0
    path = _write(tmp_path, "m.txt", "0,1,3\n0,1,2\n0.5\n")
    _, _, vals = native.load_csr_text(path)
    assert vals.tolist() == [0.5, 1.0, 1.0]


def test_dense_text_parity(tmp_path):
    from sgracex1_tpu.graph.io import load_dense_text

    path = _write(tmp_path, "d.txt", "1,2,3\n4,5\n\n6,7,8\n")
    out = native.load_dense_text(path)
    np.testing.assert_array_equal(
        out, [[1, 2, 3], [4, 5, 0], [6, 7, 8]]
    )
    np.testing.assert_array_equal(out, load_dense_text(path))


def test_reference_dataset_native_vs_python(tmp_path):
    """End-to-end: native and python parses of a reference file agree."""
    from sgracex1_tpu.graph import io

    data_dir = io.reference_data_dir()
    if data_dir is None:
        pytest.skip("reference data not mounted")
    path = os.path.join(data_dir, "mol_adj.txt")
    os.environ["SGRACE_NATIVE"] = "1"
    a_native = io.load_csr_text(path)
    os.environ["SGRACE_NATIVE"] = "0"
    try:
        a_py = io.load_csr_text(path)
    finally:
        os.environ["SGRACE_NATIVE"] = "1"
    np.testing.assert_array_equal(a_native.rows, a_py.rows)
    np.testing.assert_array_equal(a_native.cols, a_py.cols)
    np.testing.assert_allclose(a_native.vals, a_py.vals)
    assert a_native.shape == a_py.shape and a_native.nnz == a_py.nnz


def test_coo_sort_matches_lexsort():
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 50, 1000).astype(np.int32)
    cols = rng.integers(0, 50, 1000).astype(np.int32)
    perm = native.coo_sort_perm(rows, cols)
    np.testing.assert_array_equal(perm, np.lexsort((cols, rows)))


def test_sym_norm_parity():
    from sgracex1_tpu.graph import normalize

    rng = np.random.default_rng(1)
    n, e = 64, 400
    ei = rng.integers(0, n, (2, e)).astype(np.int64)
    w = rng.uniform(0.1, 2.0, e).astype(np.float32)

    ei_n, w_n = native.sym_norm_edges(ei, n, w, 1.0)
    # pure-python path
    ei2, w2 = normalize.add_self_loops(ei, w, n, 1.0)
    deg = np.zeros(n)
    np.add.at(deg, ei2[0], w2)
    dis = np.where(deg > 0, deg**-0.5, 0.0)
    expect = (dis[ei2[0]] * w2 * dis[ei2[1]]).astype(np.float32)

    np.testing.assert_array_equal(ei_n, ei2)
    np.testing.assert_allclose(w_n, expect, rtol=1e-6)


def test_sym_norm_no_weights():
    from sgracex1_tpu.graph import normalize

    ei = np.array([[0, 1, 2, 2], [1, 2, 0, 2]], np.int64)
    ei_n, w_n = native.sym_norm_edges(ei, 3, None, 1.0)
    ei_p, w_p = normalize.sym_norm_edges(ei, 3, None, 1.0)
    np.testing.assert_array_equal(ei_n, ei_p)
    np.testing.assert_allclose(w_n, w_p, rtol=1e-6)


def test_partition_balance():
    rowptr = np.array([0, 10, 10, 12, 30, 31, 40], np.int64)
    bounds = native.partition_balance(rowptr, 3)
    assert bounds[0] == 0 and bounds[-1] == 6
    assert np.all(np.diff(bounds) >= 0)
    # each part's nnz should be near total/3 = 13.3 given row granularity
    nnz = [rowptr[bounds[i + 1]] - rowptr[bounds[i]] for i in range(3)]
    assert sum(nnz) == 40
