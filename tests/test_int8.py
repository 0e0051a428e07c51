"""Integer int8 inference path: exactness of the corrected int8 matmuls and
end-to-end closeness to the float reference."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sgracex1_tpu.quant.affine import QuantConstants, generate_constants
from sgracex1_tpu.quant.calibration import CalibrationTable
from sgracex1_tpu.quant import int8 as qi8


def _uc(beta=1.0, qbits=8):
    return generate_constants(0.0, beta, qbits, signed=False, w_qbits=qbits)


def _sc(absmax=1.0, qbits=8):
    return generate_constants(-absmax, absmax, qbits, signed=True, w_qbits=qbits)


def test_unsigned_x_signed_matmul_exact():
    """Shifted-int8 matmul + correction == exact integer product."""
    rng = np.random.default_rng(0)
    uq = rng.integers(0, 256, (37, 53)).astype(np.int64)  # unsigned grid
    sq = rng.integers(-127, 128, (53, 17)).astype(np.int64)
    us = jnp.asarray((uq - 128).astype(np.int8))
    acc = np.asarray(qi8.matmul_unsigned_x_signed(us, jnp.asarray(sq.astype(np.int8))))
    np.testing.assert_array_equal(acc, uq @ sq)


def test_quantize_roundtrip():
    c = _uc(beta=2.0)
    x = jnp.asarray(np.linspace(0, 2, 100, dtype=np.float32))
    xs = qi8.quantize_unsigned_shifted(x, c)
    xq = xs.astype(np.int32) + 128
    back = xq * c.s
    np.testing.assert_allclose(back, np.asarray(x), atol=c.s / 2 + 1e-7)


def test_int8_layer_close_to_float():
    """Integer layer output tracks the float GCN layer within quant error."""
    rng = np.random.default_rng(1)
    n, f, p = 64, 32, 16
    X = rng.uniform(0, 1, (n, f)).astype(np.float32)
    W = rng.uniform(-0.5, 0.5, (f, p)).astype(np.float32)
    A = (rng.uniform(size=(n, n)) < 0.1).astype(np.float32)
    A /= np.maximum(A.sum(1, keepdims=True), 1)

    c_x, c_w = _uc(1.0), _sc(0.5)
    c_a = _uc(1.0)
    h_absmax = float(np.abs(X @ W).max())
    layer = qi8.freeze_gcn_layer(W, c_x, c_w, c_a, h_absmax=h_absmax)

    xs = qi8.quantize_unsigned_shifted(jnp.asarray(X), c_x)
    a_s = qi8.dense_adjacency_int8(A, c_a)
    acc, scale = jax.jit(qi8.int8_gcn_layer)(layer, a_s, xs)
    out = np.asarray(qi8.dequantize_acc(acc, scale))

    expect = A @ (X @ W)
    err = np.abs(out - expect).max()
    scale_err = np.abs(expect).max()
    assert err < 0.05 * scale_err + 0.01, f"int8 err {err} vs range {scale_err}"


@pytest.mark.parametrize("qbits", [4, 2])
def test_subbyte_layer_close_to_float(qbits):
    """True integer inference at 4/2 bits: operands are constrained to the
    2^qbits grid (the reference's adaptive-quantization widths,
    matrix_mult.h:166-183 / sgrace.py:70-92) and the arithmetic runs on the
    int8 dot — sub-byte values are exact in int8, so this IS the q-bit
    integer datapath. Looser closeness bound at narrower widths."""
    rng = np.random.default_rng(2)
    n, f, p = 64, 32, 16
    X = rng.uniform(0, 1, (n, f)).astype(np.float32)
    W = rng.uniform(-0.5, 0.5, (f, p)).astype(np.float32)
    A = (rng.uniform(size=(n, n)) < 0.1).astype(np.float32)
    A /= np.maximum(A.sum(1, keepdims=True), 1)

    c_x, c_w = _uc(1.0, qbits=qbits), _sc(0.5, qbits=qbits)
    c_a = _uc(1.0, qbits=qbits)
    h_absmax = float(np.abs(X @ W).max())
    layer = qi8.freeze_gcn_layer(W, c_x, c_w, c_a, h_absmax=h_absmax)

    xs = qi8.quantize_unsigned_shifted(jnp.asarray(X), c_x)
    # quantized operands must live on the q-bit grid
    assert int(xs.astype(np.int32).max()) + 128 <= 2**qbits - 1
    assert int(np.abs(np.asarray(layer.wq)).max()) <= 2 ** (qbits - 1) - 1
    a_s = qi8.dense_adjacency_int8(A, c_a)
    acc, scale = jax.jit(qi8.int8_gcn_layer)(layer, a_s, xs)

    # exact integer self-consistency: the int8 pipeline must equal a numpy
    # simulation over the same q-bit integer operands at any width
    Xq = np.asarray(xs).astype(np.int64) + 128
    Aq = np.asarray(a_s).astype(np.int64) + 128
    Wq = np.asarray(layer.wq).astype(np.int64)
    acc1 = Xq @ Wq
    hq = np.clip(
        np.round(acc1 * (layer.s_x * layer.s_w / layer.s_h)), -127, 127
    ).astype(np.int64)
    np.testing.assert_array_equal(np.asarray(acc), Aq @ hq)

    if qbits == 4:
        # float closeness only where post-training quantization is sane;
        # the reference reaches <=2-bit accuracy via QAT, not PTQ
        out = np.asarray(qi8.dequantize_acc(acc, scale))
        expect = A @ (X @ W)
        err = np.abs(out - expect).max()
        rng_err = np.abs(expect).max()
        assert err < 0.35 * rng_err + 0.05, f"4-bit err {err} vs {rng_err}"


def test_relu_is_lower_clamp():
    """Requantize-to-unsigned zeroes negatives exactly like float ReLU."""
    acc = jnp.asarray(np.array([[-100, -1, 0, 1, 100]], np.int32))
    out = np.asarray(qi8.requantize_unsigned_shifted(acc, 1.0)).astype(np.int32) + 128
    np.testing.assert_array_equal(out[0], [0, 0, 0, 1, 100])


def test_int8_gat_layer_close_to_float():
    """Integer GAT layer tracks the float GAT within quantization error."""
    import jax.numpy as jnp
    from sgracex1_tpu.graph.csr import SparseMatrix
    from sgracex1_tpu.graph.normalize import sym_norm
    from sgracex1_tpu.ops.fused_gnn import gat_layer

    rng = np.random.default_rng(3)
    n, f, h = 48, 16, 8
    ei = np.unique(
        np.stack([rng.integers(0, n, 300), rng.integers(0, n, 300)]), axis=1
    )
    A = sym_norm(ei, n)
    X = rng.uniform(0, 1, (n, f)).astype(np.float32)
    W = rng.uniform(-0.5, 0.5, (f, h)).astype(np.float32)
    att = rng.uniform(-0.5, 0.5, (2 * h, 1)).astype(np.float32)

    expect = np.asarray(
        gat_layer(A, jnp.asarray(X), jnp.asarray(W), jnp.asarray(att),
                  relu=False)
    )

    c_x, c_w = _uc(1.0), _sc(0.5)
    layer = qi8.freeze_gat_layer(
        W, att, c_x, c_w, h_absmax=float(np.abs(X @ W).max())
    )
    xs = qi8.quantize_unsigned_shifted(jnp.asarray(X), c_x)
    acc, scale = jax.jit(
        qi8.int8_gat_layer, static_argnames="n_nodes"
    )(layer, A.rows, A.cols, A.vals > 0, n, xs)
    out = np.asarray(qi8.dequantize_acc(acc, scale))

    rel = np.abs(out - expect).max() / (np.abs(expect).max() + 1e-9)
    assert rel < 0.08, f"int8 GAT relative err {rel}"


def test_gcn2_forward_close_to_float():
    rng = np.random.default_rng(2)
    n, f, h = 48, 24, 12
    X = rng.uniform(0, 1, (n, f)).astype(np.float32)
    W1 = rng.uniform(-0.5, 0.5, (f, h)).astype(np.float32)
    W2 = rng.uniform(-0.5, 0.5, (h, h)).astype(np.float32)
    A = (rng.uniform(size=(n, n)) < 0.15).astype(np.float32)
    A /= np.maximum(A.sum(1, keepdims=True), 1)

    # float reference
    h1 = np.maximum(A @ (X @ W1), 0.0)
    expect = A @ (h1 @ W2)

    cal = CalibrationTable.for_qbits(
        8,
        dict(w_min=-0.5, w_max=0.5, w_min2=-0.5, w_max2=0.5,
             f_min=0.0, f_max=1.0, a_min=0.0, a_max=float(A.max())),
    )
    net = qi8.freeze_gcn2(
        W1, W2, A, cal,
        h1_absmax=float(np.abs(X @ W1).max()),
        x2_absmax=float(h1.max()),
        h2_absmax=float(np.abs(h1 @ W2).max()),
    )
    xs = qi8.quantize_unsigned_shifted(jnp.asarray(X), cal.features)
    out = np.asarray(jax.jit(qi8.int8_gcn2_forward)(net, xs))

    rel = np.abs(out - expect).max() / (np.abs(expect).max() + 1e-9)
    assert rel < 0.08, f"2-layer int8 relative err {rel}"


def _banded_graph(rng, n, extra=2000):
    """Sym-normalized banded + random graph (tile-friendly, pubmed-shaped)."""
    import scipy.sparse as sp
    from sgracex1_tpu.graph.csr import SparseMatrix
    from sgracex1_tpu.graph.normalize import sym_norm

    rows, cols = [], []
    for d in (-2, -1, 1, 2):
        i = np.arange(max(0, -d), min(n, n - d))
        rows.append(i)
        cols.append(i + d)
    rows.append(rng.integers(0, n, extra))
    cols.append(rng.integers(0, n, extra))
    r = np.concatenate(rows)
    c = np.concatenate(cols)
    k = np.unique(r.astype(np.int64) * n + c)
    ei = np.stack([k // n, k % n])
    return sym_norm(ei, n)


def _exact_int_ref(A, c_a, hq):
    """Exact integer Aq @ Hq on the quantized adjacency (scipy, int64)."""
    import scipy.sparse as sp

    n = A.n_rows
    v = np.asarray(A.vals[: A.nnz])
    aq = np.clip(np.round(v / c_a.s + c_a.z), 0, c_a.beta_q)
    r = np.asarray(A.rows[: A.nnz])
    c = np.asarray(A.cols[: A.nnz])
    mat = sp.coo_matrix((aq, (r, c)), shape=(n, A.n_cols)).tocsr()
    return mat @ np.asarray(hq, np.int64)


@pytest.mark.parametrize("n,P,extra", [(700, 32, 400), (1500, 8, 3000),
                                        (300, 128, 0)])
def test_int8_spmm_exact(n, P, extra):
    """int8_spmm == the exact integer product of the quantized grids."""
    rng = np.random.default_rng(3)
    A = _banded_graph(rng, n, extra=extra)
    c_a = _uc(float(np.asarray(A.vals).max()) or 1.0)
    Aq = qi8.sparse_adjacency_int8(A, c_a)
    hq = rng.integers(-128, 128, (n, P)).astype(np.int8)
    acc = jax.jit(qi8.int8_spmm)(Aq, jnp.asarray(hq))
    assert acc.dtype == jnp.int32
    np.testing.assert_array_equal(np.asarray(acc), _exact_int_ref(A, c_a, hq))


def test_int8_spmm_ignores_padding_edges():
    """Padding edges carry value 0 and must add nothing."""
    from sgracex1_tpu.graph.csr import SparseMatrix

    rng = np.random.default_rng(5)
    r = np.array([0, 1, 2, 2])
    c = np.array([1, 2, 0, 2])
    A = SparseMatrix.from_coo(r, c, np.ones(4, np.float32), (3, 3),
                              pad_to=128)
    assert A.e_pad > A.nnz
    Aq = qi8.sparse_adjacency_int8(A, _uc(1.0))
    hq = rng.integers(-128, 128, (3, 4)).astype(np.int8)
    np.testing.assert_array_equal(
        np.asarray(qi8.int8_spmm(Aq, jnp.asarray(hq))),
        _exact_int_ref(A, _uc(1.0), hq),
    )


def test_int8_gcn2_sparse_matches_dense_and_float():
    """Sparse full-integer 2-layer GCN == the dense int8 form exactly,
    and both track the float forward — at a size past nothing, but the
    same code path runs at pubmed/1M scale (no dense N x N)."""
    rng = np.random.default_rng(4)
    n, f, h, p = 1500, 16, 12, 8
    A = _banded_graph(rng, n)
    mat = A.to_scipy()
    X = rng.uniform(0, 1, (n, f)).astype(np.float32)
    W1 = rng.uniform(-0.5, 0.5, (f, h)).astype(np.float32)
    W2 = rng.uniform(-0.5, 0.5, (h, p)).astype(np.float32)

    amax = qi8.collect_amax_gcn2_sparse(A, X, W1, W2)
    cal = CalibrationTable.for_qbits(
        8,
        dict(w_min=-0.5, w_max=0.5, w_min2=-0.5, w_max2=0.5,
             f_min=0.0, f_max=1.0, a_min=0.0,
             a_max=float(np.asarray(A.vals).max()) or 1.0),
    )
    net_s = qi8.freeze_gcn2_sparse(W1, W2, A, cal, **amax)
    out_s = np.asarray(qi8.int8_gcn2_sparse_forward(net_s, jnp.asarray(
        np.asarray(qi8.quantize_unsigned_shifted(jnp.asarray(X), cal.features))
    )))[:n]

    net_d = qi8.freeze_gcn2(W1, W2, mat.toarray(), cal, **amax)
    xs = qi8.quantize_unsigned_shifted(jnp.asarray(X), cal.features)
    out_d = np.asarray(qi8.int8_gcn2_forward(net_d, xs))

    np.testing.assert_allclose(out_s, out_d, rtol=1e-5, atol=1e-5)
    # float reference
    h1 = np.maximum(mat @ (X @ W1), 0)
    ref = mat @ (h1 @ W2)
    err = np.abs(out_s - ref).max() / (np.abs(ref).max() + 1e-9)
    assert err < 0.08, err


def test_int8_hybrid_fused_exact(rng):
    """Full-integer aggregation of a hub-and-tail graph (a dense 256-node
    hub block plus a scattered tail) is EXACT integer math on the edge
    path — the shape that needed a tile+remainder schedule before."""
    import scipy.sparse as sp

    from sgracex1_tpu.graph.csr import SparseMatrix

    n, f = 1600, 64
    mat = sp.random(n, n, density=0.001, format="lil",
                    random_state=11).astype(np.float32)
    mat[:256, :256] = rng.uniform(0.1, 1.0, (256, 256)).astype(np.float32)
    A = SparseMatrix.from_scipy(mat.tocsr())
    c_a = _uc(1.0)
    X = rng.uniform(0, 1, (n, f)).astype(np.float32)
    xs = qi8.quantize_unsigned_shifted(jnp.asarray(X), _uc(1.0))
    acc = np.asarray(qi8.int8_spmm(qi8.sparse_adjacency_int8(A, c_a), xs))
    np.testing.assert_array_equal(acc, _exact_int_ref(A, c_a, xs))


@pytest.mark.parametrize("shape", [(7, 5, 3), (64, 128, 32), (300, 17, 9)])
def test_matmul_unsigned_x_signed_exact_shapes(shape):
    """The shift identity Uq @ S = Us @ S + 128 * colsum(S) is exact int32
    at any shape (XLA's integer dot, no float rounding anywhere)."""
    m, k, n = shape
    rng = np.random.default_rng(m)
    us = rng.integers(-128, 128, (m, k)).astype(np.int8)
    sq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    acc = jax.jit(qi8.matmul_unsigned_x_signed)(jnp.asarray(us),
                                               jnp.asarray(sq))
    assert acc.dtype == jnp.int32
    ref = (us.astype(np.int64) + 128) @ sq.astype(np.int64)
    np.testing.assert_array_equal(np.asarray(acc), ref)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_gcn_layer_sparse_equals_dense(seed):
    """One full-integer layer: the sparse edge-path aggregation and the
    dense int8 dot give the identical int32 accumulator and scale."""
    rng = np.random.default_rng(seed)
    n, f, h = 200, 12, 6
    A = _banded_graph(rng, n, extra=300)
    c_a = _uc(float(np.asarray(A.vals).max()))
    W = rng.uniform(-0.5, 0.5, (f, h)).astype(np.float32)
    layer = qi8.freeze_gcn_layer(W, _uc(1.0), _sc(0.5), c_a, h_absmax=3.0)
    xs = qi8.quantize_unsigned_shifted(
        jnp.asarray(rng.uniform(0, 1, (n, f)).astype(np.float32)), _uc(1.0)
    )
    acc_s, sc_s = qi8.int8_gcn_layer_sparse(
        layer, qi8.sparse_adjacency_int8(A, c_a), xs
    )
    acc_d, sc_d = qi8.int8_gcn_layer(
        layer, qi8.dense_adjacency_int8(A.to_dense(), c_a), xs
    )
    assert sc_s == sc_d
    np.testing.assert_array_equal(np.asarray(acc_s), np.asarray(acc_d))
