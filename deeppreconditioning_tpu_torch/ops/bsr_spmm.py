"""Block-sparse SpMV / SpMM: kernel B3 and its dispatch.

``bsr_matmat(a, X)`` computes ``Y = A X`` for a ``BSRMatrix`` and X of
shape (n_pad, m); ``bsr_matvec(a, x)`` computes ``y = A x`` for x of
shape (n_pad,).  They replace the reference's
``ops/pallas_bsr.py::bsr_matmat_pallas`` / ``bsr_matvec_pallas``; the
matvec is a real m = 1 path (the reference's 128-lane replication of x
fed the TPU's matrix unit and is not kept).

Dispatch follows the tensor: a CPU tensor takes the plain PyTorch version
(``BSRMatrix.matmat`` / ``matvec``); a CUDA tensor launches the
hand-written kernel ``csrc/bsr_spmm.cu`` or raises.  There is no fallback
from the kernel to the plain version.
"""

from __future__ import annotations

import torch

from deeppreconditioning_tpu_torch import _backend
from deeppreconditioning_tpu_torch.sparse.bsr import BSRMatrix

BLOCK_SIZES = (16, 32, 64, 128)  # the kernel's template instances
MAX_INT = 2**31 - 1


def check_bsr_args(a: BSRMatrix, x: torch.Tensor) -> int:
    """Raise ValueError on anything kernel B3 does not take (device,
    dtype, shapes, block size, contiguity, alignment); return m, the
    number of columns of x (1 for a vector)."""
    blocks, cols = a.blocks, a.block_cols
    if blocks.device.type != "cuda" or x.device != blocks.device or (
            cols.device != blocks.device):
        raise ValueError("bsr_spmm_cuda needs blocks, block_cols and x on "
                         f"one CUDA device, got {blocks.device}, "
                         f"{cols.device} and {x.device}")
    if blocks.dtype != torch.float32 or x.dtype != torch.float32:
        raise ValueError(f"float32 only, got {blocks.dtype} and {x.dtype}")
    if cols.dtype != torch.int32:
        raise ValueError(f"block_cols must be int32, got {cols.dtype}")
    if blocks.dim() != 4 or blocks.shape[2] != blocks.shape[3]:
        raise ValueError(
            f"blocks must be (R, S, bs, bs), got {tuple(blocks.shape)}")
    r, s, bs = blocks.shape[0], blocks.shape[1], blocks.shape[2]
    if bs not in BLOCK_SIZES:
        raise ValueError(f"block size {bs} not in {BLOCK_SIZES}")
    if tuple(cols.shape) != (r, s) or r < 1 or s < 1:
        raise ValueError(f"block_cols must be ({r}, {s}) with R, S >= 1, "
                         f"got {tuple(cols.shape)}")
    if x.dim() not in (1, 2) or x.shape[0] != r * bs or (
            x.dim() == 2 and x.shape[1] < 1):
        raise ValueError(f"x must be ({r * bs},) or ({r * bs}, m >= 1), got "
                         f"{tuple(x.shape)}")
    m = 1 if x.dim() == 1 else x.shape[1]
    if r * bs * m > MAX_INT or r * s > MAX_INT:
        raise ValueError("operator too large for the kernel's int sizes")
    if not (blocks.is_contiguous() and cols.is_contiguous()
            and x.is_contiguous()):
        raise ValueError("blocks, block_cols and x must be contiguous")
    if blocks.data_ptr() % 16:
        raise ValueError("blocks must be 16-byte aligned")
    if m == 1 and x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned for m = 1")
    return m


def bsr_spmm_cuda(a: BSRMatrix, x: torch.Tensor) -> torch.Tensor:
    """Launch kernel B3 on the current stream for x of shape (n_pad,) or
    (n_pad, m); y has x's shape.  Raises on anything the kernel does not
    take (``check_bsr_args``) and on a refused launch."""
    lib = _backend.kernel_library()
    m = check_bsr_args(a, x)
    r, s, bs = a.blocks.shape[:3]
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.dp_bsr_spmm_f32(
        a.blocks.data_ptr(), a.block_cols.data_ptr(), x.data_ptr(),
        y.data_ptr(), r, s, bs, m, stream,
    )
    if rc != 0:
        raise RuntimeError(f"bsr_spmm kernel launch failed: cuda error {rc}")
    _backend.count_launch("bsr_spmm")
    return y


def bsr_matmat(a: BSRMatrix, x: torch.Tensor) -> torch.Tensor:
    """Y = A X for X (n_pad, m).  CPU: plain version; otherwise the CUDA
    kernel, or raise."""
    if x.device.type == "cpu":
        return a.matmat(x)
    return bsr_spmm_cuda(a, x)


def bsr_matvec(a: BSRMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A x for x (n_pad,).  CPU: plain version; otherwise the CUDA
    kernel's m = 1 path, or raise."""
    if x.device.type == "cpu":
        return a.matvec(x)
    return bsr_spmm_cuda(a, x)
