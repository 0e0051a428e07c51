"""Typed configuration for SGRACEx1-TPU.

The reference uses three config tiers (SURVEY.md §5 "Config / flag system"):
compile-time ``#define``s (``src/matrix_mult.h:80,166-196``), a per-board
``config.py`` module (``demo/emulation/config.py``), and per-call runtime
registers (``sgrace.py:1211-1249``). Here all three collapse into one frozen
dataclass; the "recompile" tier becomes static jit arguments and the
aggregation backend chosen at prepare time (ops/dispatch.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class SGRACEConfig:
    """Framework-wide configuration.

    Mirrors the capability surface of the reference's ``config.py``
    (``demo/emulation/config.py:1-49``).
    """

    # --- model (reference: hidden_channels, head_count, compute_attention) ---
    hidden_channels: int = 16
    head_count: int = 1
    compute_attention: bool = False  # True => GAT, False => GCN
    leaky_relu_alpha: float = 0.2
    dropout: float = 0.5

    # --- quantization (reference: w_qbits, fake_quantization) ---
    w_qbits: int = 8  # 1 / 2 / 4 / 8
    fake_quantization: bool = False  # QAT emulation of the quantized datapath

    # --- numerics ---
    # The reference hardware computes in fp16 (HALF, matrix_mult.h:80); the
    # default here is f32 features with f32 accumulation.
    dtype: jnp.dtype = jnp.float32
    accum_dtype: jnp.dtype = jnp.float32

    # --- distribution (replaces FEA_THREADS/ADJ_THREADS spatial sharding) ---
    mesh_axis: str = "graph"
    num_shards: Optional[int] = None  # None => all local devices

    # --- training loop ---
    learning_rate: Optional[float] = None  # None => reference's qbits rule
    num_epochs: int = 100
    # Checkpoint path to preload before training (the reference's .ptx
    # preload flow, demo_sgrace.py:42,422-435): fine-tune a pretrained
    # model at a very low learning rate.
    preload: Optional[str] = None

    # --- observability (reference: profiling flag + max_fea telemetry) ---
    profiling: bool = False
    track_amax: bool = True  # activation-range telemetry for calibration

    def resolved_learning_rate(self) -> float:
        """Reference's qbits-dependent LR rule (demo_sgrace.py:433-443):
        preload fine-tuning => 1e-4 ("very low"), 8/4-bit => 0.01,
        2/1-bit => 0.1."""
        if self.learning_rate is not None:
            return self.learning_rate
        if self.preload is not None:
            return 0.0001
        return 0.01 if self.w_qbits > 2 else 0.1

    def replace(self, **kw) -> "SGRACEConfig":
        return dataclasses.replace(self, **kw)
