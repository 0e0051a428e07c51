"""Sparse matrix container for graph computations on the device.

The reference streams CSR triples (rowPtr / colIdx / values) through AXI FIFOs
(``src/kernelMatrixmult_all.cpp:815-1015``); the demo bitstream actually takes
COO (``sgrace.py:1244-1249``). Here the natural format is **row-sorted COO
padded to a static length**: segment reductions and jit both want a flat
edge list with static shape, and transposition is free (swap the roles of
rows/cols — no re-sort needed for unsorted segment sums).

``SparseMatrix`` is a registered pytree: arrays (rows/cols/vals) are leaves and
flow through jit/vmap/shard_map; shape and true-nnz are static metadata.
Padding entries carry ``val == 0`` (so they contribute nothing to any
matmul), ``col == 0``, and ``row == n_rows - 1`` — the last row id, so that
row-sortedness survives padding and segment reductions can take XLA's
sorted-indices fast path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SparseMatrix:
    """A row-sorted, zero-padded COO sparse matrix.

    Attributes:
      rows: int32[E_pad] — row index per nonzero (segment ids).
      cols: int32[E_pad] — column index per nonzero.
      vals: float[E_pad] — values; padding entries are exactly 0.
      shape: static (n_rows, n_cols).
      nnz: static true number of nonzeros (<= E_pad).
    """

    rows: jax.Array
    cols: jax.Array
    vals: jax.Array
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))
    # True when rows are non-decreasing (the from_coo default) — lets
    # segment reductions take XLA's sorted-scatter fast path
    rows_sorted: bool = dataclasses.field(
        default=False, metadata=dict(static=True)
    )

    # ------------------------------------------------------------- properties
    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def e_pad(self) -> int:
        return self.vals.shape[0]

    @property
    def dtype(self):
        return self.vals.dtype

    # ----------------------------------------------------------- constructors
    @staticmethod
    def from_coo(
        rows,
        cols,
        vals,
        shape: Tuple[int, int],
        *,
        pad_to: int = 128,
        sort: bool = True,
    ) -> "SparseMatrix":
        """Build from host COO arrays; sorts by (row, col) and zero-pads."""
        rows = np.asarray(rows, dtype=np.int32)
        cols = np.asarray(cols, dtype=np.int32)
        vals = np.asarray(vals)
        nnz = int(vals.shape[0])
        if sort and nnz:
            order = np.lexsort((cols, rows))
            rows, cols, vals = rows[order], cols[order], vals[order]
        e_pad = max(_round_up(max(nnz, 1), pad_to), pad_to)
        # padding rows carry the LAST row id so row-sortedness survives
        # padding (vals are 0, so they contribute nothing anywhere)
        pr = np.full(e_pad, max(0, int(shape[0]) - 1), dtype=np.int32)
        pc = np.zeros(e_pad, dtype=np.int32)
        pv = np.zeros(e_pad, dtype=vals.dtype if vals.size else np.float32)
        pr[:nnz], pc[:nnz], pv[:nnz] = rows, cols, vals
        # Deliberately host (numpy) arrays: graph preprocessing is host-side,
        # and host<->device transfers are expensive — move to the device once,
        # explicitly, via .device() / jax.device_put.
        return SparseMatrix(
            rows=pr,
            cols=pc,
            vals=pv,
            shape=(int(shape[0]), int(shape[1])),
            nnz=nnz,
            rows_sorted=bool(np.all(np.diff(pr) >= 0)),
        )

    @staticmethod
    def from_dense(dense, *, pad_to: int = 128) -> "SparseMatrix":
        dense = np.asarray(dense)
        rows, cols = np.nonzero(dense)
        return SparseMatrix.from_coo(
            rows, cols, dense[rows, cols], dense.shape, pad_to=pad_to
        )

    @staticmethod
    def from_scipy(mat, *, pad_to: int = 128) -> "SparseMatrix":
        coo = mat.tocoo()
        return SparseMatrix.from_coo(
            coo.row, coo.col, coo.data, coo.shape, pad_to=pad_to
        )

    @staticmethod
    def from_csr_arrays(
        rowptr, cols, vals, n_cols: int, *, pad_to: int = 128
    ) -> "SparseMatrix":
        """Build from classic CSR (the reference's on-disk format)."""
        rowptr = np.asarray(rowptr, dtype=np.int64)
        n_rows = len(rowptr) - 1
        rows = np.repeat(np.arange(n_rows, dtype=np.int32), np.diff(rowptr))
        return SparseMatrix.from_coo(
            rows, cols, vals, (n_rows, n_cols), pad_to=pad_to, sort=False
        )

    # ------------------------------------------------------------ conversions
    def to_dense(self) -> np.ndarray:
        """Densify on the host (numpy): densification is a host-side
        preprocessing step, uploaded once."""
        out = np.zeros(self.shape, dtype=self.vals.dtype)
        r, c, v = (np.asarray(x) for x in (self.rows, self.cols, self.vals))
        np.add.at(out, (r[: self.nnz], c[: self.nnz]), v[: self.nnz])
        return out

    def to_dense_jax(self) -> jax.Array:
        """In-jit densification (for fused compute paths only)."""
        out = jnp.zeros(self.shape, dtype=self.vals.dtype)
        return out.at[self.rows, self.cols].add(self.vals)

    def to_scipy(self):
        import scipy.sparse as sp

        r, c, v = (np.asarray(x[: self.nnz]) for x in (self.rows, self.cols, self.vals))
        return sp.coo_matrix((v, (r, c)), shape=self.shape).tocsr()

    def rowptr(self) -> np.ndarray:
        """Host-side CSR row pointer (for preprocessing / kernels)."""
        counts = np.bincount(
            np.asarray(self.rows[: self.nnz]), minlength=self.n_rows
        )
        return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)

    # ------------------------------------------------------------- operations
    def transpose(self) -> "SparseMatrix":
        """Swap rows/cols. The result is NOT row-sorted; all framework ops
        (segment-sum based) accept unsorted COO."""
        return SparseMatrix(
            rows=self.cols,
            cols=self.rows,
            vals=self.vals,
            shape=(self.shape[1], self.shape[0]),
            nnz=self.nnz,
            rows_sorted=False,
        )

    def astype(self, dtype) -> "SparseMatrix":
        return dataclasses.replace(self, vals=self.vals.astype(dtype))

    def pad_edges_to(self, e_pad: int) -> "SparseMatrix":
        """Re-pad the edge arrays to a larger static length (so batches of
        different sizes share one compiled program)."""
        assert e_pad >= self.e_pad
        pad = e_pad - self.e_pad
        if pad == 0:
            return self
        fill = lambda a, v: np.concatenate(
            [np.asarray(a), np.full(pad, v, a.dtype)]
        )
        return dataclasses.replace(
            self,
            rows=fill(self.rows, max(0, self.n_rows - 1)),
            cols=fill(self.cols, 0),
            vals=fill(self.vals, 0),
        )

    def device(self, device=None) -> "SparseMatrix":
        """Move all arrays to a device in one explicit step."""
        if device is None:
            return jax.device_put(self)
        return jax.device_put(self, device)

    def with_vals(self, vals: jax.Array) -> "SparseMatrix":
        assert vals.shape == self.vals.shape
        return dataclasses.replace(self, vals=vals)

    def with_uniform_nnz(self) -> "SparseMatrix":
        """Set the static nnz to e_pad so differently-filled batches share
        one jit specialization (padding entries have val == 0, so every
        computation is unchanged; only nnz-dependent host utilities like
        to_scipy/pad_mask would see the padding as real edges)."""
        return dataclasses.replace(self, nnz=self.e_pad)

    def pad_mask(self) -> jax.Array:
        """bool[E_pad] — True for real edges, False for padding."""
        idx = jnp.arange(self.e_pad)
        return idx < self.nnz

    def density(self) -> float:
        return self.nnz / float(self.shape[0] * self.shape[1])
