"""Batched Gauss–Jordan local solves: kernel B1 and its plain version.

``masked_gauss_jordan(sub, e)`` solves ``sub[i] @ y[i] = e[i]`` for a
batch of small systems, keeping the ``(T, w, w)`` interface of the
reference's ``ops/fsai.py::_masked_gauss_jordan``.

Dispatch follows the tensor: a CPU tensor takes the plain PyTorch version
(``masked_gauss_jordan_torch``); a CUDA tensor launches the hand-written
kernel ``csrc/gauss_jordan.cu`` (which replaces the TPU kernel
``ops/fsai.py::_gj_kernel``) or raises.  There is no fallback from the
kernel to the plain version, and no width gate: 1 <= w <= 63.  The
kernel is built for the widths ``INSTANCE_WIDTHS`` and runs a call of
width w on ``instance_width(w)``, padding inside the kernel (identity rows,
zero right-hand side), which leaves y[:, :w] exactly as at width w.
"""

from __future__ import annotations

import torch

from deeppreconditioning_tpu_torch import _backend

MAX_WIDTH = 63
INSTANCE_WIDTHS = (4, 8, 16, 24, 32, 42, 48, 64)  # the kernel's widths


def instance_width(w: int) -> int:
    """The built width a call of width w (1..MAX_WIDTH) runs on: the
    smallest instance width >= w (``dp_gauss_jordan_f32``'s dispatch)."""
    if not 1 <= w <= MAX_WIDTH:
        raise ValueError(f"width {w} outside 1..{MAX_WIDTH}")
    return next(width for width in INSTANCE_WIDTHS if width >= w)


def masked_gauss_jordan_torch(sub: torch.Tensor,
                              e: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch form of ``_masked_gauss_jordan_xla``: unpivoted
    Gauss–Jordan on ``[sub | e]`` with the same step order (row k divided
    by the pivot, column k zeroed in row k, eliminate, replace row k).
    Any dtype and device; the kernel's oracle."""
    _backend.count_plain("gauss_jordan", sub)
    w = sub.shape[-1]
    aug = torch.cat([sub, e.unsqueeze(-1)], dim=-1)  # (..., w, w+1)
    row_iota = torch.arange(w, device=sub.device)
    for k in range(w):
        pivot = aug[..., k, k].unsqueeze(-1)
        row_k = aug[..., k, :] / pivot  # (..., w+1)
        is_k = row_iota == k
        col_k = torch.where(is_k, 0.0, aug[..., :, k])  # (..., w)
        aug = aug - col_k.unsqueeze(-1) * row_k.unsqueeze(-2)
        aug = torch.where(is_k.unsqueeze(-1), row_k.unsqueeze(-2), aug)
    return aug[..., :, w]


def check_gauss_jordan_args(sub: torch.Tensor, e: torch.Tensor) -> None:
    """Raise ValueError on anything kernel B1 does not take: device,
    dtype, shape, contiguity, 16-byte alignment (its copies), w outside
    1..MAX_WIDTH."""
    if sub.device.type != "cuda" or e.device != sub.device:
        raise ValueError("gauss_jordan_cuda needs sub and e on one CUDA "
                         f"device, got {sub.device} and {e.device}")
    if sub.dtype != torch.float32 or e.dtype != torch.float32:
        raise ValueError(f"float32 only, got {sub.dtype} and {e.dtype}")
    if sub.dim() != 3 or sub.shape[1] != sub.shape[2]:
        raise ValueError(f"sub must be (N, w, w), got {tuple(sub.shape)}")
    n, w = sub.shape[0], sub.shape[1]
    if tuple(e.shape) != (n, w):
        raise ValueError(f"e must be ({n}, {w}), got {tuple(e.shape)}")
    if not 1 <= w <= MAX_WIDTH:
        raise ValueError(f"width {w} outside 1..{MAX_WIDTH}")
    if not (sub.is_contiguous() and e.is_contiguous()):
        raise ValueError("sub and e must be contiguous")
    if sub.data_ptr() % 16 or e.data_ptr() % 16:
        raise ValueError("sub and e must be 16-byte aligned")
    if n >= 2**31:
        raise ValueError(f"{n} systems exceed the kernel's int count")


def gauss_jordan_cuda(sub: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """Launch kernel B1 on the current stream; raises on anything it does
    not take (``check_gauss_jordan_args``) and on a refused launch."""
    lib = _backend.kernel_library()
    check_gauss_jordan_args(sub, e)
    n, w = sub.shape[0], sub.shape[1]
    y = torch.empty((n, w), dtype=sub.dtype, device=sub.device)
    if n == 0:
        return y
    stream = torch.cuda.current_stream(sub.device).cuda_stream
    rc = lib.dp_gauss_jordan_f32(
        sub.data_ptr(), e.data_ptr(), y.data_ptr(), n, w, stream
    )
    if rc != 0:
        raise RuntimeError(f"gauss_jordan kernel launch failed: cuda error {rc}")
    _backend.count_launch("gauss_jordan")
    return y


def masked_gauss_jordan(sub: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """(T, w, w), (T, w) -> (T, w).  CPU: plain version; otherwise the
    CUDA kernel, or raise."""
    if sub.device.type == "cpu":
        return masked_gauss_jordan_torch(sub, e)
    return gauss_jordan_cuda(sub, e)
