"""ctypes bindings for the native host runtime (csrc/sgrace_host.cpp).

The shared library is built on demand with g++ (no pip deps) and cached next
to the source; set ``SGRACE_NATIVE=0`` to force the pure-Python fallbacks.
Every binding has a numpy twin in the package (graph/io.py,
graph/normalize.py, graph/reorder.py) — the Python versions are the spec,
the native versions are the fast path, and tests/test_native.py pins them
equal.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from typing import Optional, Tuple

import numpy as np

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
_SRC = os.path.join(_REPO, "csrc", "sgrace_host.cpp")
_BUILD_DIR = os.path.join(_REPO, "csrc", "build")
_LIB = os.path.join(_BUILD_DIR, "libsgrace_host.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_i64 = ctypes.c_int64
_i32 = ctypes.c_int32
_f32 = ctypes.c_float
_p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_p_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")


def _build() -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = _LIB + f".tmp{os.getpid()}"
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC",
        "-o", tmp, _SRC,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp, _LIB)  # atomic under concurrent builders
        return True
    except (subprocess.SubprocessError, OSError) as e:
        print(f"sgrace native build failed: {e}", file=sys.stderr)
        if os.path.exists(tmp):
            os.unlink(tmp)
        return False


def _declare(lib: ctypes.CDLL) -> None:
    h = ctypes.c_void_p
    lib.sg_csr_load.restype = h
    lib.sg_csr_load.argtypes = [ctypes.c_char_p]
    lib.sg_csr_nrows.restype = _i64
    lib.sg_csr_nrows.argtypes = [h]
    lib.sg_csr_nnz.restype = _i64
    lib.sg_csr_nnz.argtypes = [h]
    lib.sg_csr_copy.argtypes = [h, _p_i64, _p_i32, _p_f32]
    lib.sg_csr_free.argtypes = [h]

    lib.sg_dense_load.restype = h
    lib.sg_dense_load.argtypes = [ctypes.c_char_p]
    lib.sg_dense_rows.restype = _i64
    lib.sg_dense_rows.argtypes = [h]
    lib.sg_dense_cols.restype = _i64
    lib.sg_dense_cols.argtypes = [h]
    lib.sg_dense_copy.argtypes = [h, _p_f32]
    lib.sg_dense_free.argtypes = [h]

    lib.sg_coo_sort.argtypes = [_i64, _p_i32, _p_i32, _p_i64]

    lib.sg_sym_norm.restype = h
    lib.sg_sym_norm.argtypes = [_i64, _i64, _p_i64, _p_i64,
                                ctypes.c_void_p, _f32]
    lib.sg_sym_nnz.restype = _i64
    lib.sg_sym_nnz.argtypes = [h]
    lib.sg_sym_copy.argtypes = [h, _p_i64, _p_i64, _p_f32]
    lib.sg_sym_free.argtypes = [h]

    lib.sg_partition_balance.argtypes = [_i64, _p_i64, _i32, _p_i64]

    lib.sg_rcm_order.argtypes = [_i64, _i64, _p_i32, _p_i32, _p_i32]


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None when unavailable."""
    global _lib, _tried
    if _lib is not None:
        return _lib
    if os.environ.get("SGRACE_NATIVE", "1") == "0":
        return None
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        stale = not os.path.exists(_LIB) or (
            os.path.exists(_SRC)
            and os.path.getmtime(_SRC) > os.path.getmtime(_LIB)
        )
        if stale and not _build():
            return None
        try:
            lib = ctypes.CDLL(_LIB)
            _declare(lib)
            _lib = lib
        except OSError as e:
            print(f"sgrace native load failed: {e}", file=sys.stderr)
        return _lib


def available() -> bool:
    return get_lib() is not None


# ------------------------------------------------------------------- wrappers

def load_csr_text(path: str) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """(rowptr i64, cols i32, vals f32) or None if unavailable/parse error."""
    lib = get_lib()
    if lib is None:
        return None
    h = lib.sg_csr_load(path.encode())
    if not h:
        return None
    try:
        n_rows = lib.sg_csr_nrows(h)
        nnz = lib.sg_csr_nnz(h)
        rowptr = np.empty(n_rows + 1, np.int64)
        cols = np.empty(nnz, np.int32)
        vals = np.empty(nnz, np.float32)
        lib.sg_csr_copy(h, rowptr, cols, vals)
        return rowptr, cols, vals
    finally:
        lib.sg_csr_free(h)


def load_dense_text(path: str) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    h = lib.sg_dense_load(path.encode())
    if not h:
        return None
    try:
        r, c = lib.sg_dense_rows(h), lib.sg_dense_cols(h)
        out = np.empty(r * c, np.float32)
        lib.sg_dense_copy(h, out)
        return out.reshape(r, c)
    finally:
        lib.sg_dense_free(h)


def coo_sort_perm(rows: np.ndarray, cols: np.ndarray) -> Optional[np.ndarray]:
    """Stable (row, col) sort permutation — np.lexsort((cols, rows))."""
    lib = get_lib()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, np.int32)
    cols = np.ascontiguousarray(cols, np.int32)
    perm = np.empty(rows.shape[0], np.int64)
    lib.sg_coo_sort(rows.shape[0], rows, cols, perm)
    return perm


def sym_norm_edges(
    edge_index: np.ndarray,
    num_nodes: int,
    edge_weight: Optional[np.ndarray],
    fill: float,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Native sym_norm2; returns (edge_index [2, E'], weights) or None."""
    lib = get_lib()
    if lib is None:
        return None
    row = np.ascontiguousarray(edge_index[0], np.int64)
    col = np.ascontiguousarray(edge_index[1], np.int64)
    if edge_weight is not None:
        w = np.ascontiguousarray(edge_weight, np.float32)
        wp = w.ctypes.data_as(ctypes.c_void_p)
    else:
        wp = None
    h = lib.sg_sym_norm(num_nodes, row.shape[0], row, col, wp,
                        np.float32(fill))
    if not h:
        return None
    try:
        total = lib.sg_sym_nnz(h)
        ro = np.empty(total, np.int64)
        co = np.empty(total, np.int64)
        wo = np.empty(total, np.float32)
        lib.sg_sym_copy(h, ro, co, wo)
        return np.stack([ro, co]), wo
    finally:
        lib.sg_sym_free(h)


def rcm_order(
    n: int, rows: np.ndarray, cols: np.ndarray
) -> Optional[np.ndarray]:
    """Reverse Cuthill-McKee permutation (perm[new] = old) over the
    symmetrized pattern; None when the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, np.int32)
    cols = np.ascontiguousarray(cols, np.int32)
    perm = np.empty(n, np.int32)
    lib.sg_rcm_order(n, rows.shape[0], rows, cols, perm)
    return perm


def partition_balance(rowptr: np.ndarray, n_parts: int) -> Optional[np.ndarray]:
    """nnz-balanced contiguous row-range bounds [n_parts + 1]."""
    lib = get_lib()
    if lib is None:
        return None
    rowptr = np.ascontiguousarray(rowptr, np.int64)
    bounds = np.empty(n_parts + 1, np.int64)
    lib.sg_partition_balance(rowptr.shape[0] - 1, rowptr, n_parts, bounds)
    return bounds
