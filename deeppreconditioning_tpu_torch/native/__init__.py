"""ctypes bindings of the port's host runtime (``csrc/host_runtime.cpp``).

Counterpart of ``deeppreconditioning_tpu/native/__init__.py``, with the
same names and contracts: ``conv_plan``, ``ic0``, ``ict``, ``levels`` and
``fvm_assemble``.  The library is the port's own, built with ``g++`` on
first use (``_backend.host_library``); the reference's prebuilt
``native/libdptpu.so`` is never loaded.  ``available()`` is true when it
builds and loads, false only where there is no C++ compiler; a failed
build raises with the compiler's output.  ``require()`` returns the
library or raises.

Every entry point counts its call (``_backend.count_host_call``).  The
callers (``ops/ic0.py``, ``ops/trisolve.py``, ``ops/sparse_conv.py``) take
the native route whenever ``available()``, keep their numpy version as
the fallback and the oracle, and count a call that took it
(``_backend.count_host_fallback``).
"""

from __future__ import annotations

import ctypes

import numpy as np

from deeppreconditioning_tpu_torch import _backend

_configured: ctypes.CDLL | None = None


def _configure(lib) -> None:
    i64 = ctypes.c_int64
    i32 = ctypes.c_int32
    p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    p_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")

    lib.dptpu_conv_plan.restype = i64
    lib.dptpu_conv_plan.argtypes = [
        i64, p_i32, p_i32, i32, i32, i32, i32, i32, i32,
        p_i32, p_i32, p_i32,
    ]
    lib.dptpu_ic0.restype = i64
    lib.dptpu_ic0.argtypes = [i64, p_i64, p_i32, p_f64]
    lib.dptpu_ict.restype = i64
    lib.dptpu_ict.argtypes = [
        i64, p_i64, p_i32, p_f64, i32, ctypes.c_double,
        p_i64, p_i32, p_f64, i64,
    ]
    lib.dptpu_levels.restype = None
    lib.dptpu_levels.argtypes = [i64, p_i64, p_i32, p_i32]
    lib.dptpu_fvm_assemble.restype = i64
    lib.dptpu_fvm_assemble.argtypes = [
        i32, i32, p_f64, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, i32, p_i32, p_i32, p_f64, p_f64,
    ]


def available() -> bool:
    """True when the host runtime builds and loads; False only without a
    C++ compiler.  A failed build raises."""
    if _configured is None and _backend.host_compiler() is None:
        return False
    require()
    return True


def require() -> ctypes.CDLL:
    """The configured host runtime; builds it on first use, or raises."""
    global _configured
    if _configured is None:
        lib = _backend.host_library()
        _configure(lib)
        _configured = lib
    return _configured


def conv_plan(rows: np.ndarray, cols: np.ndarray, h_in: int, w_in: int,
              kh: int, kw: int, ph: int, pw: int):
    """Output sites and gather maps of a sorted, stride-1, ordinary conv
    layer: (out_rows, out_cols, gather (kh * kw, nnz_out)), -1 where the
    input site is absent (``ops.sparse_conv.build_conv_maps``'s
    contract)."""
    lib = require()
    nnz = rows.shape[0]
    cap = max(nnz * kh * kw, 1)
    out_rows = np.empty(cap, np.int32)
    out_cols = np.empty(cap, np.int32)
    gather = np.empty(kh * kw * cap, np.int32)
    nnz_out = lib.dptpu_conv_plan(
        nnz, np.ascontiguousarray(rows, np.int32),
        np.ascontiguousarray(cols, np.int32), h_in, w_in, kh, kw, ph, pw,
        out_rows, out_cols, gather,
    )
    _backend.count_host_call("conv_plan")
    g = gather[:kh * kw * nnz_out].reshape(kh * kw, nnz_out).copy()
    return out_rows[:nnz_out].copy(), out_cols[:nnz_out].copy(), g


def ic0(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray) -> int:
    """In-place IC(0) of ``data`` on a tril CSR pattern (diagonal last per
    row).  Returns 0, or the 1-based row of the first non-positive
    pivot."""
    lib = require()
    out = int(lib.dptpu_ic0(
        indptr.shape[0] - 1,
        np.ascontiguousarray(indptr, np.int64),
        np.ascontiguousarray(indices, np.int32),
        data,
    ))
    _backend.count_host_call("ic0")
    return out


def ict(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
        add_fill_in: int, threshold: float):
    """ICT of a full symmetric CSR matrix (sorted indices); returns the
    tril CSR triple (indptr, indices, data), diagonal last per row."""
    lib = require()
    n = indptr.shape[0] - 1
    capacity = indices.shape[0] + n * (add_fill_in + 1) + n
    l_indptr = np.empty(n + 1, np.int64)
    l_indices = np.empty(capacity, np.int32)
    l_data = np.empty(capacity, np.float64)
    nnz = lib.dptpu_ict(
        n,
        np.ascontiguousarray(indptr, np.int64),
        np.ascontiguousarray(indices, np.int32),
        np.ascontiguousarray(data, np.float64),
        add_fill_in, threshold,
        l_indptr, l_indices, l_data, capacity,
    )
    _backend.count_host_call("ict")
    if nnz < 0:
        raise RuntimeError("ICT capacity overflow")
    return l_indptr, l_indices[:nnz].copy(), l_data[:nnz].copy()


def levels(indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Dependency levels of a tril CSR factor (int32, 0 for a row with no
    strictly-lower entry)."""
    lib = require()
    n = indptr.shape[0] - 1
    out = np.zeros(n, np.int32)
    lib.dptpu_levels(
        n,
        np.ascontiguousarray(indptr, np.int64),
        np.ascontiguousarray(indices, np.int32),
        out,
    )
    _backend.count_host_call("levels")
    return out


def fvm_assemble(ny: int, nx: int, rho: np.ndarray, dx: float,
                 dy: float, dt: float, dirichlet_top: bool):
    """The FVM pressure-Poisson assembly as COO triplets (rows, cols,
    vals, with duplicates) and the Dirichlet diagonal contribution."""
    lib = require()
    n = ny * nx
    cap = 5 * n
    rows = np.empty(cap, np.int32)
    cols = np.empty(cap, np.int32)
    vals = np.empty(cap, np.float64)
    diag_extra = np.empty(n, np.float64)
    nnz = lib.dptpu_fvm_assemble(
        ny, nx, np.ascontiguousarray(rho, np.float64).ravel(),
        dx, dy, dt, int(dirichlet_top), rows, cols, vals, diag_extra,
    )
    _backend.count_host_call("fvm_assemble")
    return (rows[:nnz].copy(), cols[:nnz].copy(), vals[:nnz].copy(),
            diag_extra)
