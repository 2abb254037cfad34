"""Banded SpMV: kernel B2 and its dispatch.

``dia_matvec(a, x)`` computes ``y = A x`` for a ``DIAMatrix``, keeping the
interface of the reference's ``ops/pallas_spmv.py::dia_matvec``.

Dispatch follows the tensor: a CPU tensor takes the plain PyTorch version
(``DIAMatrix.matvec``); a CUDA tensor launches the hand-written kernel
``csrc/dia_spmv.cu`` (which replaces the TPU kernel
``ops/pallas_spmv.py::_dia_kernel``) or raises.  There is no fallback
from the kernel to the plain version and no size crossover: every CUDA
matvec, coarse multigrid levels included, is a kernel launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from deeppreconditioning_tpu_torch import _backend
from deeppreconditioning_tpu_torch.sparse.dia import DIAMatrix

MAX_DIAGS = 32  # the offsets travel by value in the kernel's parameters
MAX_ROWS = 1 << 30  # int row index plus the grid stride stays in range


@functools.lru_cache(maxsize=256)
def _offsets_array(offsets: tuple[int, ...]):
    return (ctypes.c_int * len(offsets))(*offsets)


def dia_spmv_cuda(a: DIAMatrix, x: torch.Tensor) -> torch.Tensor:
    """Launch kernel B2 on the current stream; raises on anything it does
    not take (device, dtype, shape, contiguity, more than 32 bands) and
    on a refused launch."""
    lib = _backend.kernel_library()
    vals = a.vals
    if vals.device.type != "cuda" or x.device != vals.device:
        raise ValueError("dia_spmv_cuda needs vals and x on one CUDA "
                         f"device, got {vals.device} and {x.device}")
    if vals.dtype != torch.float32 or x.dtype != torch.float32:
        raise ValueError(f"float32 only, got {vals.dtype} and {x.dtype}")
    n_diag, n_pad = vals.shape
    if n_diag != len(a.offsets) or not 1 <= n_diag <= MAX_DIAGS:
        raise ValueError(f"{n_diag} bands for {len(a.offsets)} offsets; "
                         f"the kernel takes 1..{MAX_DIAGS}")
    if tuple(x.shape) != (n_pad,):
        raise ValueError(f"x must be ({n_pad},), got {tuple(x.shape)}")
    if not 1 <= n_pad <= MAX_ROWS:
        raise ValueError(f"n_pad {n_pad} outside 1..{MAX_ROWS}")
    if not (vals.is_contiguous() and x.is_contiguous()):
        raise ValueError("vals and x must be contiguous")
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.dp_dia_spmv_f32(
        vals.data_ptr(), x.data_ptr(), y.data_ptr(),
        _offsets_array(tuple(a.offsets)), n_diag, n_pad, stream,
    )
    if rc != 0:
        raise RuntimeError(f"dia_spmv kernel launch failed: cuda error {rc}")
    _backend.count_launch("dia_spmv")
    return y


def dia_matvec(a: DIAMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A x.  CPU: plain version; otherwise the CUDA kernel, or
    raise."""
    if x.device.type == "cpu":
        return a.matvec(x)
    return dia_spmv_cuda(a, x)
