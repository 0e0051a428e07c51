"""True-integer int8 inference path.

The reference has two integer datapaths: a gemmlowp-style requantize stage in
the HLS engine (``scale``, kernelMatrixmult_all.cpp:2155-2259 — compiled out
by default) and the demo bitstream's on-chip quantize/dequantize pipeline
driven by the ``quantization_scale_*`` / ``deq_factor`` registers
(sgrace.py:334-365). The QAT path (quant/affine.py) *emulates* those with
float fake-quant; this module is the real thing for inference: both layer
matmuls run as int8 x int8 -> int32 (XLA's integer dot), with
requantization between stages.

int8 convention: the integer dot consumes signed int8. Unsigned-grid tensors
(input features and adjacency: z = 0, range [0, 2^qbits - 1]) are stored
shifted by -128 into int8, and the matmul is corrected with the identity

    Uq @ S = (Us + 128) @ S = Us @ S + 128 * colsum(S)

where the correction is a per-output-column constant — the analogue of
the reference's zero-point bias preload (``bias_start``,
kernelMatrixmult_all.cpp:3876-3888). The hidden XW grid is *signed*
symmetric, matching the reference's signed internal fixed-point pipeline
(ITYPE, matrix_mult.h:80): negative pre-aggregation values must survive
until the post-aggregation ReLU (fused at write-out,
kernelMatrixmult_all.cpp:798-805).

Requantization computes ``round(acc * m)`` in float32 rather than the
reference's Q31 fixed-point ``(acc * mult) >> (31 - shift)``: f32 holds
integers exactly up to 2^24, far above int8 GNN accumulators, so the results
match the integer formula.

Sparse graphs aggregate on the edge path: the quantized adjacency stays a
COO edge list whose values are unsigned-grid integers, and ``Aq @ Hq`` is an
exact int32 gather + segment sum (``int8_spmm``) — no dense N x N, usable at
any N.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sgracex1_tpu.quant.affine import QuantConstants
from sgracex1_tpu.quant.calibration import CalibrationTable

_SHIFT = 128  # unsigned-grid -> int8 storage shift


# --------------------------------------------------------------------- quant


def quantize_unsigned_shifted(x: jax.Array, c: QuantConstants) -> jax.Array:
    """Quantize to the unsigned grid [0, beta_q] (z = 0 for [0, beta] ranges)
    and store shifted into int8."""
    xq = jnp.clip(jnp.round(x / c.s + c.z), 0, c.beta_q)
    return (xq - _SHIFT).astype(jnp.int8)


def quantize_signed(x: jax.Array, c: QuantConstants) -> jax.Array:
    """Quantize to the signed grid [alpha_q, beta_q] as int8."""
    xq = jnp.clip(jnp.round(x / c.s + c.z), c.alpha_q, c.beta_q)
    return xq.astype(jnp.int8)


def _int8_matmul(a: jax.Array, b: jax.Array) -> jax.Array:
    """int8 x int8 -> int32 (exact)."""
    return jax.lax.dot_general(
        a,
        b,
        (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )


def matmul_unsigned_x_signed(us: jax.Array, sq: jax.Array) -> jax.Array:
    """acc = Uq @ Sq where ``us`` stores Uq - 128 (unsigned grid, shifted)
    and ``sq`` is signed int8. Exact int32."""
    acc = _int8_matmul(us, sq)
    corr = _SHIFT * jnp.sum(sq.astype(jnp.int32), axis=0)
    return acc + corr[None, :]


# ---------------------------------------------------------------- requantize


def requantize_signed(acc: jax.Array, multiplier: float, beta_q: int = 127):
    """int32 accumulator -> signed int8 grid: clamp(round(acc * m))."""
    q = jnp.round(acc.astype(jnp.float32) * jnp.float32(multiplier))
    return jnp.clip(q, -float(beta_q), float(beta_q)).astype(jnp.int8)


def requantize_unsigned_shifted(
    acc: jax.Array, multiplier: float, beta_q: int = 255
) -> jax.Array:
    """int32 accumulator -> unsigned grid (z = 0), stored shifted int8.

    The lower clamp at 0 IS the integer-domain ReLU (z = 0), exactly how the
    reference fuses ReLU into the quantized write-out stage."""
    q = jnp.round(acc.astype(jnp.float32) * jnp.float32(multiplier))
    q = jnp.clip(q, 0.0, float(beta_q))
    return (q - _SHIFT).astype(jnp.int8)


def dequantize_acc(acc: jax.Array, scale: float) -> jax.Array:
    return acc.astype(jnp.float32) * jnp.float32(scale)


# ------------------------------------------------------------ prepared layer


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Int8GCNLayer:
    """One GCN layer frozen for integer inference.

    wq: int8 [F_in, F_out] signed weights. s_x/s_w/s_a are the input /
    weight / adjacency scales; s_h is the signed hidden (XW) grid scale
    derived from amax telemetry. All scales are static floats baked into the
    compiled program (the reference writes them to AXI registers per layer,
    sgrace.py:334-365).
    """

    wq: jax.Array
    s_x: float = dataclasses.field(metadata=dict(static=True))
    s_w: float = dataclasses.field(metadata=dict(static=True))
    s_a: float = dataclasses.field(metadata=dict(static=True))
    s_h: float = dataclasses.field(metadata=dict(static=True))


def freeze_gcn_layer(
    W: np.ndarray,
    c_x: QuantConstants,
    c_w: QuantConstants,
    c_a: QuantConstants,
    *,
    h_absmax: float,
) -> Int8GCNLayer:
    """Quantize layer weights and derive the hidden-activation grid from an
    observed |XW| amax (the framework's analogue of the reference's max_fea
    calibration telemetry, sgrace.py:506-520)."""
    wq = np.clip(
        np.round(np.asarray(W) / c_w.s + c_w.z), c_w.alpha_q, c_w.beta_q
    ).astype(np.int8)
    s_h = max(float(h_absmax), 1e-8) / 127.0
    return Int8GCNLayer(
        wq=jnp.asarray(wq), s_x=c_x.s, s_w=c_w.s, s_a=c_a.s, s_h=s_h
    )


def int8_gcn_layer(
    layer: Int8GCNLayer, a_s: jax.Array, xs: jax.Array
) -> Tuple[jax.Array, float]:
    """Full-integer GCN layer: acc = Aq @ requant(Xq @ Wq), both matmuls
    int8 x int8 -> int32.

    a_s: dense adjacency on the unsigned grid, shifted int8 [N, N].
    xs: features on the unsigned grid, shifted int8 [N, F].
    Returns (int32 accumulator, its dequant scale); ReLU is applied by the
    caller at the next requantize (post-aggregation, like the reference's
    fused write-out ReLU).
    """
    acc1 = matmul_unsigned_x_signed(xs, layer.wq)  # Xq @ Wq, exact int32
    # real(acc1) = s_x * s_w * acc1 -> requantize onto the signed hidden grid
    h_q = requantize_signed(acc1, layer.s_x * layer.s_w / layer.s_h)
    acc2 = matmul_unsigned_x_signed(a_s, h_q)  # Aq @ Hq, exact int32
    return acc2, layer.s_a * layer.s_h


def dense_adjacency_int8(A_dense: np.ndarray, c_a: QuantConstants) -> jax.Array:
    """Quantize a dense adjacency onto the unsigned grid, shifted int8."""
    aq = np.clip(np.round(np.asarray(A_dense) / c_a.s + c_a.z), 0, c_a.beta_q)
    return jnp.asarray((aq - _SHIFT).astype(np.int8))


def sparse_adjacency_int8(A, c_a: QuantConstants):
    """Quantize a SPARSE adjacency's edge values onto the unsigned grid
    [0, beta_q] — the sparse-scale replacement for
    ``dense_adjacency_int8``'s N x N matrix. Returns a SparseMatrix whose
    values are the grid integers (held in float32, exact)."""
    v = np.asarray(A.vals)
    aq = np.clip(np.round(v / c_a.s + c_a.z), 0, c_a.beta_q)
    return A.with_vals(jnp.asarray(aq.astype(np.float32)))


def int8_spmm(Aq, hq: jax.Array) -> jax.Array:
    """Exact int32 ``Aq @ Hq`` on the edge path: ``Aq`` holds unsigned-grid
    integer edge values (sparse_adjacency_int8; padding edges are 0),
    ``hq`` signed int8 [N, P]. Every product and sum is int32."""
    contrib = jnp.take(hq, Aq.cols, axis=0).astype(jnp.int32) * Aq.vals.astype(
        jnp.int32
    )[:, None]
    return jax.ops.segment_sum(
        contrib, Aq.rows, num_segments=Aq.n_rows,
        indices_are_sorted=Aq.rows_sorted,
    )


def int8_gcn_layer_sparse(
    layer: Int8GCNLayer, a_q, xs: jax.Array
) -> Tuple[jax.Array, float]:
    """Full-integer GCN layer on a sparse quantized adjacency: X@W as an
    int8 dot, aggregation as the exact int32 edge sum — the reference's
    quantized engine capability (sgrace.py:334-365) at sparse scale."""
    acc1 = matmul_unsigned_x_signed(xs, layer.wq)
    h_q = requantize_signed(acc1, layer.s_x * layer.s_w / layer.s_h)
    return int8_spmm(a_q, h_q), layer.s_a * layer.s_h


# --------------------------------------------------------- two-layer network


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Int8GCN2:
    """The reference's 2-layer GCN frozen for full-integer inference
    (dense quantized adjacency — small graphs; see Int8GCN2Sparse for the
    sparse form that scales past the dense N x N cap)."""

    layer1: Int8GCNLayer
    layer2: Int8GCNLayer
    a_s: jax.Array  # shared quantized adjacency


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Int8GCN2Sparse:
    """2-layer GCN frozen for full-integer inference on a sparse quantized
    adjacency (sparse_adjacency_int8): aggregation is the exact int32 edge
    sum, with NO dense N x N, so full-integer inference runs at pubmed/1M
    scale (the reference's quantized engine runs at its full supported
    size, sgrace.py:334-365,1296-1845; the dense Int8GCN2 caps at ~16k
    nodes)."""

    layer1: Int8GCNLayer
    layer2: Int8GCNLayer
    a_q: object  # graph.csr.SparseMatrix of unsigned-grid edge values


def freeze_gcn2(
    W1: np.ndarray,
    W2: np.ndarray,
    A_dense: np.ndarray,
    cal: CalibrationTable,
    *,
    h1_absmax: float,
    x2_absmax: float,
    h2_absmax: float,
) -> Int8GCN2:
    """Freeze a trained 2-layer GCN (weights + calibration table + activation
    amax telemetry) into the integer inference form.

    h1/h2_absmax: observed |X W| amax per layer; x2_absmax: observed amax of
    the layer-1 output (layer 2's input range).
    """
    c_x2 = QuantConstants(
        s_o=1.0, s=max(float(x2_absmax), 1e-8) / 255.0, z=0, qbits=8,
        signed=False,
    )
    l1 = freeze_gcn_layer(
        W1, cal.features, cal.weights, cal.adjacency, h_absmax=h1_absmax
    )
    l2 = freeze_gcn_layer(
        W2, c_x2, cal.weights2, cal.adjacency, h_absmax=h2_absmax
    )
    return Int8GCN2(
        layer1=l1,
        layer2=l2,
        a_s=dense_adjacency_int8(A_dense, cal.adjacency),
    )


def freeze_gcn2_sparse(
    W1: np.ndarray,
    W2: np.ndarray,
    A,
    cal: CalibrationTable,
    *,
    h1_absmax: float,
    x2_absmax: float,
    h2_absmax: float,
) -> Int8GCN2Sparse:
    """freeze_gcn2 with a SPARSE adjacency (SparseMatrix) quantized edge by
    edge instead of into a dense N x N matrix."""
    c_x2 = QuantConstants(
        s_o=1.0, s=max(float(x2_absmax), 1e-8) / 255.0, z=0, qbits=8,
        signed=False,
    )
    l1 = freeze_gcn_layer(
        W1, cal.features, cal.weights, cal.adjacency, h_absmax=h1_absmax
    )
    l2 = freeze_gcn_layer(
        W2, c_x2, cal.weights2, cal.adjacency, h_absmax=h2_absmax
    )
    return Int8GCN2Sparse(
        layer1=l1,
        layer2=l2,
        a_q=sparse_adjacency_int8(A, cal.adjacency),
    )


# ------------------------------------------------------------------ int8 GAT


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Int8GATLayer:
    """GAT layer frozen for integer inference (single head).

    X@W runs int8 x int8 -> int32; attention scores are int8
    matvecs. The edge softmax is float (O(E) transcendentals — the demo
    bitstream likewise computes the softmax in its float pipeline stage,
    reading back S, sgrace.py:501-539), and the attention-weighted
    aggregation is an exact-integer segment-sum carried in f32 (quantized
    255-grid attention x int8 hidden stays far below f32's 2^24 exact-int
    range) — O(E) memory, no dense N x N intermediate.
    """

    wq: jax.Array  # int8 [F_in, F_out]
    aq_src: jax.Array  # int8 [F_out]
    aq_dst: jax.Array  # int8 [F_out]
    s_x: float = dataclasses.field(metadata=dict(static=True))
    s_w: float = dataclasses.field(metadata=dict(static=True))
    s_a: float = dataclasses.field(metadata=dict(static=True))  # attention vec
    s_h: float = dataclasses.field(metadata=dict(static=True))
    alpha: float = dataclasses.field(metadata=dict(static=True))


def freeze_gat_layer(
    W: np.ndarray,
    attention: np.ndarray,
    c_x: QuantConstants,
    c_w: QuantConstants,
    *,
    h_absmax: float,
    alpha: float = 0.2,
) -> Int8GATLayer:
    """Quantize GAT weights + the [2F, 1] attention vector (sgrace.py:1178)."""
    F = W.shape[1]
    a = np.asarray(attention).reshape(-1)
    a_absmax = max(float(np.abs(a).max()), 1e-8)
    s_a = a_absmax / 127.0
    aq = np.clip(np.round(a / s_a), -127, 127).astype(np.int8)
    wq = np.clip(
        np.round(np.asarray(W) / c_w.s + c_w.z), c_w.alpha_q, c_w.beta_q
    ).astype(np.int8)
    s_h = max(float(h_absmax), 1e-8) / 127.0
    return Int8GATLayer(
        wq=jnp.asarray(wq),
        aq_src=jnp.asarray(aq[:F]),
        aq_dst=jnp.asarray(aq[F:]),
        s_x=c_x.s,
        s_w=c_w.s,
        s_a=s_a,
        s_h=s_h,
        alpha=alpha,
    )


def int8_gat_layer(
    layer: Int8GATLayer,
    rows: jax.Array,
    cols: jax.Array,
    edge_mask: jax.Array,
    n_nodes: int,
    xs: jax.Array,
) -> Tuple[jax.Array, float]:
    """Full GAT layer with integer matmuls, aggregated on the edge path.

    rows/cols/edge_mask: padded COO edges of the adjacency (mask = real edge
    with positive weight). Returns (int32 accumulator, dequant scale).
    """
    acc1 = matmul_unsigned_x_signed(xs, layer.wq)  # Xq @ Wq exact
    h_q = requantize_signed(acc1, layer.s_x * layer.s_w / layer.s_h)

    # attention scores: int8 matvecs, dequantized per edge (O(E) float)
    s1 = jnp.dot(
        h_q, layer.aq_src, preferred_element_type=jnp.int32
    ).astype(jnp.float32)
    s2 = jnp.dot(
        h_q, layer.aq_dst, preferred_element_type=jnp.int32
    ).astype(jnp.float32)
    sc = layer.s_h * layer.s_a
    e = (jnp.take(s1, rows) + jnp.take(s2, cols)) * sc
    e = jnp.where(e > 0, e, layer.alpha * e)

    # edge softmax (float)
    masked = jnp.where(edge_mask, e, -9e15)
    row_max = jax.ops.segment_max(masked, rows, num_segments=n_nodes)
    row_max = jnp.where(jnp.isfinite(row_max), row_max, 0.0)
    ex = jnp.where(edge_mask, jnp.exp(masked - jnp.take(row_max, rows)), 0.0)
    denom = jax.ops.segment_sum(ex, rows, num_segments=n_nodes)
    att = ex / jnp.take(jnp.where(denom > 0, denom, 1.0), rows)

    # attention weights on the unsigned [0,255] grid, kept SPARSE per edge —
    # the demo bitstream likewise keeps attention in sparse E/S edge buffers
    # (sgrace.py:498-539). Aggregation is an exact integer segment-sum in
    # f32: |att_q * h_q| <= 255*127 per edge and each row's att_q sums to
    # ~255 (softmax), so accumulators stay far below f32's 2^24 exact-int
    # range. O(E) memory — no dense N x N intermediate, usable at any N.
    att_q = jnp.round(att * 255.0)
    contrib = jnp.take(h_q, cols, axis=0).astype(jnp.float32) * att_q[:, None]
    acc2 = jax.ops.segment_sum(contrib, rows, num_segments=n_nodes)
    return acc2.astype(jnp.int32), (1.0 / 255.0) * layer.s_h


def collect_amax_gcn2(
    A_dense: np.ndarray, X: np.ndarray, W1: np.ndarray, W2: np.ndarray
) -> dict:
    """One float forward pass recording the activation ranges freeze_gcn2
    needs — the framework's analogue of reading back the max_fea telemetry
    register per layer (sgrace.py:506-520)."""
    h1_pre = X @ W1
    h1 = np.maximum(A_dense @ h1_pre, 0.0)
    h2_pre = h1 @ W2
    return dict(
        h1_absmax=float(np.abs(h1_pre).max()),
        x2_absmax=float(h1.max()),
        h2_absmax=float(np.abs(h2_pre).max()),
    )


def int8_gcn2_forward(net: Int8GCN2, xs: jax.Array) -> jax.Array:
    """Integer forward through both layers; returns float hidden [N, F2].

    The layer-1 accumulator is ReLU'd and requantized onto layer 2's
    unsigned input grid in one step (lower clamp at z = 0 == ReLU) — the
    integer analogue of the reference's dense=1 restaging of layer-1 output
    (sgrace.py:1217-1237) with relu fused in the write-out.
    """
    acc1, scale1 = int8_gcn_layer(net.layer1, net.a_s, xs)
    x2 = requantize_unsigned_shifted(acc1, scale1 / net.layer2.s_x)
    acc2, scale2 = int8_gcn_layer(net.layer2, net.a_s, x2)
    return dequantize_acc(acc2, scale2)


def int8_gcn2_sparse_forward(net: Int8GCN2Sparse, xs: jax.Array) -> jax.Array:
    """int8_gcn2_forward on the sparse adjacency (same math; sparse scale)."""
    acc1, scale1 = int8_gcn_layer_sparse(net.layer1, net.a_q, xs)
    x2 = requantize_unsigned_shifted(acc1, scale1 / net.layer2.s_x)
    acc2, scale2 = int8_gcn_layer_sparse(net.layer2, net.a_q, x2)
    return dequantize_acc(acc2, scale2)


def collect_amax_gcn2_sparse(A_sp, X: np.ndarray, W1, W2) -> dict:
    """collect_amax_gcn2 for a scipy/SparseMatrix adjacency (no dense)."""
    mat = A_sp.to_scipy() if hasattr(A_sp, "to_scipy") else A_sp
    h1_pre = X @ np.asarray(W1)
    h1 = np.maximum(mat @ h1_pre, 0.0)
    h2_pre = h1 @ np.asarray(W2)
    return dict(
        h1_absmax=float(np.abs(h1_pre).max()),
        x2_absmax=float(h1.max()),
        h2_absmax=float(np.abs(h2_pre).max()),
    )
