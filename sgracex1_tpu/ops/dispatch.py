"""Aggregation backend dispatch.

One adjacency, two execution strategies — the analogue of the reference's
compile-time datatype/thread configs (matrix_mult.h), chosen at prepare time
instead of synthesis time:

- 'dense': the adjacency is materialized as a dense bf16 matrix once and
  aggregation is a single matmul on the tensor cores. It wins only on small,
  dense graphs — the reference's own regime, which is capped at N <= 6144
  on-chip (matrix_mult.h:43-45).
- 'xla': gather + segment_sum (ops/spmm.py) — the edge path. Always
  correct, differentiates natively, and on the GPU the fastest path for
  sparse graphs: a gather and a scatter-add per edge are native there.

prepare_adjacency runs on the host once per graph; agg_matmul is the in-jit
dispatch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from sgracex1_tpu.graph.csr import SparseMatrix
from sgracex1_tpu.ops.spmm import spmm

DENSE_MAX_BYTES = 512 << 20  # dense bf16 adjacency budget (~16k nodes)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PreparedAdjacency:
    """An adjacency prepared for a specific aggregation backend.

    Always carries the COO arrays (edge-level ops — GAT attention — need
    them regardless of the matmul backend)."""

    A: SparseMatrix
    dense: Optional[jax.Array] = None
    kind: str = dataclasses.field(default="xla", metadata=dict(static=True))

    @property
    def n_rows(self) -> int:
        return self.A.n_rows


# Backend-choice cost constants, measured on one NVIDIA H100 80GB HBM3
# (power limit 400 W) with the fwd+bwd of one aggregation at P=256 f32
# features (PERF.md, "chooser calibration"): the edge path costs ~2.6 ns
# per edge from 2^16 to 2^20 nodes (14.1 ms for 5.5M edges at 2^20), the
# dense bf16 matmul ~6.4 ps per adjacency element (1.73 ms at 16384
# nodes). Both pay a similar ~0.1 ms fixed cost, which cancels.
_EDGE_S = 2.6e-9
_DENSE_ELT_S = 6.4e-12


def _estimate_backend_costs(A: SparseMatrix) -> dict:
    """Modelled seconds of one training aggregation per backend."""
    n = max(A.n_rows, A.n_cols)
    return {"dense": n * n * _DENSE_ELT_S, "xla": A.nnz * _EDGE_S}


def prepare_adjacency(
    A: SparseMatrix,
    *,
    method: str = "auto",
    dense_max_bytes: int = DENSE_MAX_BYTES,
    dense_dtype=jnp.bfloat16,
) -> PreparedAdjacency:
    """Choose and precompute the aggregation backend for a graph.

    ``auto`` picks the cheaper backend by the measured cost model above;
    the dense backend is a candidate only while its matrix fits
    ``dense_max_bytes``."""
    from sgracex1_tpu.utils.compcache import enable_persistent_cache

    enable_persistent_cache()
    if method == "auto":
        n = max(A.n_rows, A.n_cols)
        costs = _estimate_backend_costs(A)
        if n * n * jnp.dtype(dense_dtype).itemsize > dense_max_bytes:
            costs.pop("dense")
        method = min(costs, key=costs.get)
    if method == "dense":
        d = A.to_dense().astype(np.float32)  # host build, one upload
        return PreparedAdjacency(
            A=A, dense=jax.device_put(d.astype(dense_dtype)), kind="dense"
        )
    if method == "xla":
        return PreparedAdjacency(A=A, kind="xla")
    raise ValueError(f"unknown method {method!r}")


def agg_matmul(prep: PreparedAdjacency, H: jax.Array) -> jax.Array:
    """out = A @ H via the prepared backend (differentiable)."""
    if prep.kind == "dense":
        out = jnp.dot(
            prep.dense,
            H.astype(prep.dense.dtype),
            preferred_element_type=jnp.float32,
        )
        return out[: prep.A.n_rows].astype(H.dtype)
    return spmm(prep.A, H)


def map_adjacency_vals(prep: PreparedAdjacency, fn) -> PreparedAdjacency:
    """Apply an elementwise function to the adjacency values of every
    backend representation (used for fake-quantizing the adjacency; fn must
    map 0 -> 0 so dense zeros and padding stay zero)."""
    return dataclasses.replace(
        prep,
        A=prep.A.with_vals(fn(prep.A.vals)),
        dense=fn(prep.dense) if prep.dense is not None else None,
    )
