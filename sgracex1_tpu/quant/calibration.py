"""Per-bit-width calibration tables and per-layer quantization parameters.

Mirrors the calibration logic of ``init_SGRACE`` (sgrace.py:1271-1845): for
each weight bit-width the reference selects tensor ranges (w/a/f/go min/max),
the fixed-point alignment ``f_align``, the unsigned clamp ``beta_qu``, the
internal pipeline width ``internal_quantization``, the post-matmul shift
``scale_fea`` and dequantization adjustments. Two layers get separate feature
and weight constants (the reference alternates a global ``layern`` flag —
sgrace.py:334-365; here each layer owns its params explicitly).

The default ranges are the reference's active (uncommented) values, i.e. its
Cora/planetoid calibration. ``CalibrationTable.calibrate_from_amax`` replaces
them from observed activation ranges — the analogue of the
``max_fea`` telemetry register (sgrace.py:506-520).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from sgracex1_tpu.quant.affine import QuantConstants, generate_constants

# Active table values per w_qbits from init_SGRACE (sgrace.py:1296-1845).
_TABLES: Dict[int, dict] = {
    8: dict(
        f_align=0, beta_qu=255, internal_quantization=16,
        scale_fea=4, scale_fea2=4, deq_pow2=1,
        w_min=-1.0, w_max=1.0, w_min2=-1.0, w_max2=1.0,
        a_min=0.0, a_max=1.0,
        f_min=0.0, f_max=1.0, f_min2=0.0, f_max2=1.0,
        go_min=-0.10, go_max=0.10,
    ),
    4: dict(
        f_align=4, beta_qu=15, internal_quantization=8,
        scale_fea=3, scale_fea2=3, deq_pow2=1,
        w_min=-1.0, w_max=1.0, w_min2=-1.0, w_max2=1.0,
        a_min=0.0, a_max=1.0,
        f_min=0.0, f_max=1.0, f_min2=0.0, f_max2=1.0,
        go_min=-0.10, go_max=0.10,
    ),
    2: dict(
        f_align=6, beta_qu=2, internal_quantization=4,
        scale_fea=3, scale_fea2=3, deq_pow2=1,
        w_min=-0.1, w_max=0.1, w_min2=-0.1, w_max2=0.1,
        a_min=0.0, a_max=0.1,
        f_min=0.0, f_max=1.0, f_min2=0.0, f_max2=1.0,
        go_min=-0.10, go_max=0.10,
    ),
    1: dict(
        f_align=7, beta_qu=1, internal_quantization=4,
        scale_fea=2, scale_fea2=2, deq_pow2=1,
        w_min=-0.1, w_max=0.1, w_min2=-0.1, w_max2=0.1,
        a_min=0.0, a_max=0.1,
        f_min=0.0, f_max=1.0, f_min2=0.0, f_max2=1.0,
        go_min=-0.10, go_max=0.10,
    ),
}

GO_QBITS = 8  # gradient-output quantization is always 8-bit (sgrace.py:1647)


@dataclasses.dataclass(frozen=True)
class LayerQuantParams:
    """Everything one layer's forward pass needs (per-layer registers the
    reference programs at sgrace.py:334-365)."""

    w_qbits: int
    weights: QuantConstants  # signed (w_s, w_z)
    features: QuantConstants  # unsigned (f_s, f_z)
    adjacency: QuantConstants  # unsigned (a_s, a_z)
    scale_fea: int
    internal_quantization: int
    deq_o: float


@dataclasses.dataclass(frozen=True)
class CalibrationTable:
    """Full calibration for a 2-layer quantized model."""

    w_qbits: int
    raw: dict
    weights: QuantConstants
    weights2: QuantConstants
    features: QuantConstants
    features2: QuantConstants
    adjacency: QuantConstants
    grad_out: QuantConstants
    deq_o: float
    deq_o2: float
    deq_gw: float
    deq_gi: float

    @staticmethod
    def for_qbits(w_qbits: int, overrides: Optional[dict] = None) -> "CalibrationTable":
        if w_qbits not in _TABLES:
            raise ValueError(f"unsupported w_qbits={w_qbits}; use 1/2/4/8")
        t = dict(_TABLES[w_qbits])
        if overrides:
            t.update(overrides)

        gen = lambda lo, hi, qb, signed: generate_constants(
            lo, hi, qb, signed=signed, w_qbits=w_qbits
        )
        w = gen(t["w_min"], t["w_max"], w_qbits, True)
        w2 = gen(t["w_min2"], t["w_max2"], w_qbits, True)
        f = gen(t["f_min"], t["f_max"], w_qbits, False)
        f2 = gen(t["f_min2"], t["f_max2"], w_qbits, False)
        a = gen(t["a_min"], t["a_max"], w_qbits, False)
        go = gen(t["go_min"], t["go_max"], GO_QBITS, False)

        deq_mult = 2.0 ** t["deq_pow2"]
        return CalibrationTable(
            w_qbits=w_qbits,
            raw=t,
            weights=w,
            weights2=w2,
            features=f,
            features2=f2,
            adjacency=a,
            grad_out=go,
            # deq_o = w_s_o * f_s_o * a_s_o (sgrace.py:1681), qbits-adjusted
            deq_o=w.s_o * f.s_o * a.s_o * deq_mult,
            deq_o2=w2.s_o * f2.s_o * a.s_o * deq_mult,
            deq_gw=f.s_o * a.s_o * go.s_o,  # sgrace.py:1690
            deq_gi=a.s_o * go.s_o * w.s_o,  # sgrace.py:1691
        )

    def layer_params(self, layer_index: int) -> LayerQuantParams:
        """Layer 1 vs layer 2+ constants (the reference's layern toggle)."""
        first = layer_index == 0
        return LayerQuantParams(
            w_qbits=self.w_qbits,
            weights=self.weights if first else self.weights2,
            features=self.features if first else self.features2,
            adjacency=self.adjacency,
            scale_fea=self.raw["scale_fea" if first else "scale_fea2"],
            internal_quantization=self.raw["internal_quantization"],
            deq_o=self.deq_o if first else self.deq_o2,
        )

    def calibrate_from_amax(
        self,
        *,
        f_max: Optional[float] = None,
        f_max2: Optional[float] = None,
        w_absmax: Optional[float] = None,
        w_absmax2: Optional[float] = None,
        a_max: Optional[float] = None,
    ) -> "CalibrationTable":
        """Rebuild the table from observed ranges (amax telemetry)."""
        o = {}
        if f_max is not None:
            o.update(f_min=0.0, f_max=float(f_max))
        if f_max2 is not None:
            o.update(f_min2=0.0, f_max2=float(f_max2))
        if w_absmax is not None:
            o.update(w_min=-float(w_absmax), w_max=float(w_absmax))
        if w_absmax2 is not None:
            o.update(w_min2=-float(w_absmax2), w_max2=float(w_absmax2))
        if a_max is not None:
            o.update(a_min=0.0, a_max=float(a_max))
        return CalibrationTable.for_qbits(self.w_qbits, {**self.raw, **o})
