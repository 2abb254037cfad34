"""Banded SpMV: kernel B2, its dispatch and its backward.

``dia_matvec(a, x)`` computes ``y = A x`` for a ``DIAMatrix``, keeping the
interface of the reference's ``ops/pallas_spmv.py::dia_matvec``; batched
values (S, n_diag, n_pad) take x (S, n_pad), all S products in one launch.

Dispatch follows the tensor: a CPU tensor takes the plain PyTorch version
(``DIAMatrix.matvec``); a CUDA tensor launches the hand-written kernel
``csrc/dia_spmv.cu`` (which replaces the TPU kernel
``ops/pallas_spmv.py::_dia_kernel``) or raises.  There is no fallback
from the kernel to the plain version and no size crossover: every CUDA
matvec, coarse multigrid levels included, is a kernel launch.

Where x needs a gradient, the product goes through ``DIAMatvec``, an
autograd function whose forward is that dispatch and whose backward is
the same dispatch on A^T (``DIAMatrix.transpose``: offsets negated, bands
re-based), so on the card both directions are B2 launches.  The reference
has no such kernel: XLA differentiates its plain product.  A gradient for
the values is not provided: on the card a ``vals`` that needs one raises,
as B1 does; on the CPU the plain product carries it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from deeppreconditioning_tpu_torch import _backend
from deeppreconditioning_tpu_torch.sparse.dia import DIAMatrix

MAX_DIAGS = 32  # the offsets travel by value in the kernel's parameters
MAX_ROWS = 1 << 30  # int row index plus the grid stride stays in range
MAX_BATCH = 65535  # the sample is the launch grid's y index


@functools.lru_cache(maxsize=256)
def _offsets_array(offsets: tuple[int, ...]):
    return (ctypes.c_int * len(offsets))(*offsets)


def dia_spmv_cuda(a: DIAMatrix, x: torch.Tensor) -> torch.Tensor:
    """Launch kernel B2 on the current stream; raises on anything it does
    not take (device, dtype, shape, contiguity, more than 32 bands), on
    operands that need a gradient (the launch has none: ``dia_matvec``
    routes such an x through ``DIAMatvec``) and on a refused launch."""
    lib = _backend.kernel_library()
    vals = a.vals
    if torch.is_grad_enabled() and (vals.requires_grad or x.requires_grad):
        raise ValueError("dia_spmv_cuda has no backward: its operands must "
                         "not require a gradient")
    if vals.device.type != "cuda" or x.device != vals.device:
        raise ValueError("dia_spmv_cuda needs vals and x on one CUDA "
                         f"device, got {vals.device} and {x.device}")
    if vals.dtype != torch.float32 or x.dtype != torch.float32:
        raise ValueError(f"float32 only, got {vals.dtype} and {x.dtype}")
    if vals.dim() not in (2, 3):
        raise ValueError(f"vals must be (n_diag, n_pad) or (S, n_diag, "
                         f"n_pad), got {tuple(vals.shape)}")
    n_diag, n_pad = vals.shape[-2:]
    batch = vals.shape[0] if vals.dim() == 3 else 1
    if n_diag != len(a.offsets) or not 1 <= n_diag <= MAX_DIAGS:
        raise ValueError(f"{n_diag} bands for {len(a.offsets)} offsets; "
                         f"the kernel takes 1..{MAX_DIAGS}")
    if tuple(x.shape) != tuple(vals.shape[:-2]) + (n_pad,):
        raise ValueError(f"x must be {tuple(vals.shape[:-2]) + (n_pad,)}, "
                         f"got {tuple(x.shape)}")
    if not 1 <= n_pad <= MAX_ROWS or not 1 <= batch <= MAX_BATCH:
        raise ValueError(f"n_pad {n_pad} outside 1..{MAX_ROWS} or batch "
                         f"{batch} outside 1..{MAX_BATCH}")
    if not (vals.is_contiguous() and x.is_contiguous()):
        raise ValueError("vals and x must be contiguous")
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.dp_dia_spmv_f32(
        vals.data_ptr(), x.data_ptr(), y.data_ptr(),
        _offsets_array(tuple(a.offsets)), n_diag, n_pad, batch, stream,
    )
    if rc != 0:
        raise RuntimeError(f"dia_spmv kernel launch failed: cuda error {rc}")
    _backend.count_launch("dia_spmv")
    return y


def _dispatch(a: DIAMatrix, x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return a.matvec(x)
    return dia_spmv_cuda(a, x)


class DIAMatvec(torch.autograd.Function):
    """y = A x with dL/dx = A^T dL/dy, both through ``dia_matvec``'s
    dispatch (B2 on the card).  A^T is ``a.transpose()``, or the operator
    passed as ``a_t`` (built once by a caller that reuses A)."""

    @staticmethod
    def forward(ctx, x, a, a_t):
        if a.vals.requires_grad:
            raise ValueError("DIAMatvec has no gradient for the values")
        ctx.a, ctx.a_t = a, a_t
        return _dispatch(a, x.contiguous())

    @staticmethod
    def backward(ctx, grad):
        a_t = ctx.a_t if ctx.a_t is not None else ctx.a.transpose()
        return _dispatch(a_t, grad.contiguous()), None, None


def dia_matvec(a: DIAMatrix, x: torch.Tensor,
               a_t: DIAMatrix | None = None) -> torch.Tensor:
    """y = A x.  CPU: plain version; otherwise the CUDA kernel, or raise.
    An x that needs a gradient goes through ``DIAMatvec`` (``a_t``, if
    given, is A^T for its backward)."""
    if x.device.type != "cpu":
        _backend.kernel_library()  # the kernel or raise, before anything
    if torch.is_grad_enabled() and x.requires_grad:
        if a.vals.requires_grad and x.device.type == "cpu":
            return a.matvec(x)
        return DIAMatvec.apply(x, a, a_t)
    return _dispatch(a, x)
