"""Neural-net layers: GCN / GAT convolutions with optional quantized datapath.

Re-design of the reference's ``GATConv_SGRACE`` / ``Relu_SGRACE``
modules (``demo/sgrace_lib/sgrace.py:1146-1265``) and the forward math of
``FPYNQ_GAT`` (``sgrace.py:301-681``). One layer = one fused
``ReLU?(agg @ (X @ W))`` where agg is the normalized adjacency (GCN) or the
attention matrix (GAT) — the reference's single accelerator call.

Quantized mode reproduces the emulation datapath (``sgrace.py:563-681``):
fake-quantize features (unsigned) and weights/attention (signed), emulate the
internal fixed-point pipeline after X@W, quantize the adjacency values, and
dequantize the output by ``deq_o``. All quantization uses straight-through
gradients; the reference gets the same effect by wrapping the layer in a
custom autograd Function whose backward ignores quantization entirely
(``FPYNQ_GAT.backward``). One documented deviation: our gradients contract
against the *quantized* operands (standard STE-QAT), while the reference
saves pre-quantization tensors for its handwritten backward; the two agree
as quantization error -> 0 and are validated against the same accuracy
anchors.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from sgracex1_tpu.graph.csr import SparseMatrix
from sgracex1_tpu.ops.spmm import spmm
from sgracex1_tpu.ops.sddmm import sddmm, leaky_relu, edge_softmax
from sgracex1_tpu.ops.fused_gnn import relu_hw, gnn_layer_quant_backward
from sgracex1_tpu.nn.module import Module, zeros
from sgracex1_tpu.ops.dispatch import (
    PreparedAdjacency,
    agg_matmul,
    map_adjacency_vals,
)
from sgracex1_tpu.quant.affine import (
    fake_quant_signed,
    fake_quant_unsigned,
    internal_fixed_point,
    ste,
)
from sgracex1_tpu.quant.calibration import LayerQuantParams


Adjacency = object  # SparseMatrix | PreparedAdjacency (duck-typed dispatch)


def _agg(A, H):
    """A @ H for either container."""
    if isinstance(A, PreparedAdjacency):
        return agg_matmul(A, H)
    return spmm(A, H)


def _edges(A) -> SparseMatrix:
    return A.A if isinstance(A, PreparedAdjacency) else A


def _quantize_adj(A, fn):
    """Apply an elementwise quantizer to adjacency values (fn(0) == 0)."""
    if isinstance(A, PreparedAdjacency):
        return map_adjacency_vals(A, fn)
    return A.with_vals(fn(A.vals))


class _AmaxMixin:
    """Range telemetry: every layer records |x|/|W|/|XW| maxima into the
    'telemetry' collection — the framework's analogue of the reference's
    ``max_fea`` register read-back used for quantization calibration
    (sgrace.py:506-520). Retrieve with
    ``model.apply(params, ..., mutable=['telemetry'])``; feed the result to
    ``CalibrationTable.calibrate_from_amax`` (see quant/autocal.py)."""

    def _sow_amax(self, x, W, Wh):
        # sow is a no-op unless the caller made 'telemetry' mutable
        self.sow("telemetry", "x_amax", jnp.max(jnp.abs(x)))
        self.sow("telemetry", "w_absmax", jnp.max(jnp.abs(W)))
        self.sow("telemetry", "wh_absmax", jnp.max(jnp.abs(Wh)))


def _xavier_gain(gain: float = 1.414):
    """Xavier uniform with the reference's gain (init.xavier_uniform_ with
    gain=1.414, sgrace.py:1177-1179)."""

    def init(key, shape, dtype=jnp.float32):
        fan_in, fan_out = shape[0], shape[-1]
        a = gain * (6.0 / (fan_in + fan_out)) ** 0.5
        return jax.random.uniform(key, shape, dtype, -a, a)

    return init


class ReluHW(Module):
    """Standalone ReLU module (``Relu_SGRACE``). On the accelerator the relu
    is fused into the previous layer's write-out; here it's the same fused
    ``relu_hw`` the layers use — kept as a module for API parity."""

    def __call__(self, x):
        return relu_hw(x)


class GCNConv(Module, _AmaxMixin):
    """GCN convolution: ``ReLU?(A_hat @ (X @ W))``.

    Equivalent to the reference layer with ``compute_attention=0``
    (``gat_mode=0`` register). ``quant`` enables the fake-quant datapath.
    """

    in_features: int
    out_features: int
    quant: Optional[LayerQuantParams] = None
    use_bias: bool = False
    # quantize the backward cotangent to these constants (the reference's
    # accb=1 hardware-offloaded backward, go_qbits=8 — sgrace.py:701-878)
    go_quant: Optional[object] = None

    def __call__(self, A, x: jax.Array, *, relu: bool = False):
        W = self.param(
            "weight", _xavier_gain(), (self.in_features, self.out_features)
        )
        q = self.quant
        if q is not None:
            x = fake_quant_unsigned(x, q.features, q.w_qbits)
            W = fake_quant_signed(W, q.weights, q.w_qbits)
        if self.go_quant is not None:
            # fused fwd with 8-bit-quantized backward; the fake-quant
            # emulation of the internal pipeline does not apply on this path
            # (the reference's accb path skips it too — it reuses the raw
            # engine for the gradient matmuls)
            out = gnn_layer_quant_backward(_edges(A), x, W, self.go_quant)
            if self.use_bias:
                out = out + self.param(
                    "bias", zeros, (self.out_features,)
                )
            return relu_hw(out) if relu else out
        Wh = jnp.dot(x, W, preferred_element_type=jnp.float32)
        self._sow_amax(x, W, Wh)
        if q is not None:
            Wh = internal_fixed_point(Wh, q.scale_fea, q.internal_quantization)
            A = _quantize_adj(
                A, lambda v: fake_quant_unsigned(v, q.adjacency, q.w_qbits)
            )
        out = _agg(A, Wh)
        if self.use_bias:
            out = out + self.param("bias", zeros, (self.out_features,))
        if relu:
            out = relu_hw(out)
        if q is not None:
            out = ste(out, out * q.deq_o)
        return out


class GATConv(Module, _AmaxMixin):
    """GAT convolution (``GATConv_SGRACE``): multi-head attention aggregation.

    Parameters mirror the reference: one weight ``[in, out*nheads]`` and one
    attention vector ``[2*out*nheads, 1]`` (sgrace.py:1176-1179). Heads are
    computed batched via reshape (the reference's head_count is declared "not
    in use" — demo/emulation/config.py:18 — we implement it for real) and
    concatenated.
    """

    in_features: int
    out_features: int
    nheads: int = 1
    alpha: float = 0.2
    quant: Optional[LayerQuantParams] = None
    # False (default) mirrors the reference's backward: X/W receive no
    # gradient through the attention weights (sgrace.py:1094-1103 treats
    # att as constant). True enables full autodiff through the scores —
    # the exact GAT gradient, a capability the reference lacks.
    exact_gradients: bool = False

    def __call__(
        self,
        A,
        x: jax.Array,
        *,
        relu: bool = False,
        return_attention: bool = False,
    ):
        F, H = self.out_features, self.nheads
        W = self.param("weight", _xavier_gain(), (self.in_features, F * H))
        att = self.param("attention", _xavier_gain(), (2 * F * H, 1))

        q = self.quant
        if q is not None:
            x = fake_quant_unsigned(x, q.features, q.w_qbits)
            W = fake_quant_signed(W, q.weights, q.w_qbits)
            att = fake_quant_signed(att, q.weights, q.w_qbits)
            A = _quantize_adj(
                A, lambda v: fake_quant_unsigned(v, q.adjacency, q.w_qbits)
            )
        A_e = _edges(A)

        Wh = jnp.dot(x, W, preferred_element_type=jnp.float32)  # [N, F*H]
        self._sow_amax(x, W, Wh)
        if q is not None:
            Wh = internal_fixed_point(Wh, q.scale_fea, q.internal_quantization)

        # per-head attention: a = [a_src (F*H), a_dst (F*H)]
        a = att.reshape(-1)
        Wh_heads = Wh.reshape(-1, H, F)  # [N, H, F]
        a_src = a[: F * H].reshape(H, F)
        a_dst = a[F * H :].reshape(H, F)

        Wh_sg = (
            Wh_heads
            if self.exact_gradients
            else jax.lax.stop_gradient(Wh_heads)
        )
        # per-node score halves, ALL heads batched (no Python head loop)
        S1 = jnp.einsum("nhf,hf->nh", Wh_sg, a_src)  # [N, H]
        S2 = jnp.einsum("nhf,hf->nh", Wh_sg, a_dst)
        # batched edge path: heads ride the last axis ([E, H])
        e_all = leaky_relu(
            jnp.take(S1, A_e.rows, axis=0) + jnp.take(S2, A_e.cols, axis=0),
            self.alpha,
        )
        s_all = edge_softmax(A_e, e_all)
        out = jax.ops.segment_sum(
            jnp.take(Wh_heads, A_e.cols, axis=0) * s_all[:, :, None],
            A_e.rows,
            num_segments=A_e.n_rows,
        ).reshape(-1, F * H)

        if relu:
            out = relu_hw(out)
        if q is not None:
            out = ste(out, out * q.deq_o)
        if return_attention:
            # per-edge logits / probabilities [H, E_pad] — the demo
            # bitstream's E / S read-back buffers (sgrace.py:498-539);
            # reassemble densely with ops.fused_gnn.edges_to_dense
            return out, (e_all.T, s_all.T)
        return out
