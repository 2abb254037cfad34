"""Assembly of dense M from overlapping Gram slabs, and its plain version.

``gram_assembly(g, lo, n_pad)`` adds the B slabs g_b (H, H) of ``g`` into
a fresh (n_pad, n_pad) M at (lo_b, lo_b), in ascending b:

    M[lo_b + p, lo_b + q] += g_b[p, q]

It is the Gram form's assembly of the range-blocked FSAI setup on a
per-case plan (``ops/fsai.py::range_m_from_strips``), where the window
starts ``lo`` live on the device.  Dispatch follows the tensor: a CPU
tensor takes the plain PyTorch version (``gram_assembly_torch``); a CUDA
tensor launches the hand-written kernel ``csrc/gram_assembly.cu`` (which
replaces no TPU kernel; it replaces PyTorch's sorted
``index_put_(accumulate=True)``) or raises.  There is no fallback from the
kernel to the plain version.  Both add in the same order, so on one
device they give the same bits.  The kernel reads ``lo`` on the device
and checks each start there (0 <= lo_b <= n_pad - H: a device-side
assert), so a call neither waits for the card nor reads from it, and can
be captured in a CUDA graph.
"""

from __future__ import annotations

import torch

from deeppreconditioning_tpu_torch import _backend

KERNEL_DTYPES = (torch.float32, torch.float64)  # its two instances
MAX_N_PAD = 32 * 65535  # the kernel's grid: 32-row tiles, 65535 rows of them


def gram_assembly_torch(g: torch.Tensor, lo: torch.Tensor,
                        n_pad: int) -> torch.Tensor:
    """Plain PyTorch form: a zero M, then one slab add per b in ascending
    order (the JAX reference's loop of slab adds).  Any dtype and device;
    the kernel's oracle.  Raises ValueError on a start outside
    0..n_pad - H (read on the host)."""
    _backend.count_plain("gram_assembly", g)
    h = g.shape[-1]
    m = g.new_zeros(n_pad, n_pad)
    for b, start in enumerate(lo.tolist()):
        if not 0 <= start <= n_pad - h:
            raise ValueError(f"window start {start} outside 0..{n_pad - h}")
        m[start:start + h, start:start + h] += g[b]
    return m


def check_gram_assembly_args(g: torch.Tensor, lo: torch.Tensor,
                             n_pad: int) -> None:
    """Raise ValueError on anything the kernel does not take: device,
    dtype, shape, contiguity, 16-byte alignment (its vector loads), sizes.
    The starts' values are checked by the kernel on the device."""
    if g.device.type != "cuda" or lo.device != g.device:
        raise ValueError("gram_assembly_cuda needs g and lo on one CUDA "
                         f"device, got {g.device} and {lo.device}")
    if g.dtype not in KERNEL_DTYPES:
        raise ValueError(f"g must be float32 or float64, got {g.dtype}")
    if lo.dtype != torch.int64:
        raise ValueError(f"lo must be int64, got {lo.dtype}")
    if g.dim() != 3 or g.shape[1] != g.shape[2]:
        raise ValueError(f"g must be (B, H, H), got {tuple(g.shape)}")
    b, h = g.shape[0], g.shape[1]
    if tuple(lo.shape) != (b,):
        raise ValueError(f"lo must be ({b},), got {tuple(lo.shape)}")
    if b < 1 or not 1 <= h <= n_pad:
        raise ValueError(f"B {b} and H {h} need B >= 1 and 1 <= H <= "
                         f"n_pad {n_pad}")
    if n_pad % 4 or n_pad > MAX_N_PAD:
        raise ValueError(f"n_pad {n_pad} must be a multiple of 4 and at "
                         f"most {MAX_N_PAD}")
    if not (g.is_contiguous() and lo.is_contiguous()):
        raise ValueError("g and lo must be contiguous")
    if g.data_ptr() % 16:
        raise ValueError("g must be 16-byte aligned")


def gram_assembly_cuda(g: torch.Tensor, lo: torch.Tensor,
                       n_pad: int) -> torch.Tensor:
    """Launch the kernel on the current stream into a fresh M (every
    entry written); raises on anything it does not take
    (``check_gram_assembly_args``), on a refused launch, and on a ``g``
    that needs a gradient: the kernel has no backward, and its result
    would silently carry none where the plain version's does."""
    lib = _backend.kernel_library()
    if torch.is_grad_enabled() and g.requires_grad:
        raise ValueError("gram_assembly_cuda has no backward: g must not "
                         "require a gradient")
    check_gram_assembly_args(g, lo, n_pad)
    m = torch.empty((n_pad, n_pad), dtype=g.dtype, device=g.device)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    entry = (lib.dp_gram_assembly_f64 if g.dtype == torch.float64
             else lib.dp_gram_assembly_f32)
    rc = entry(g.data_ptr(), lo.data_ptr(), m.data_ptr(), g.shape[0],
               g.shape[1], n_pad, stream)
    if rc != 0:
        raise RuntimeError(f"gram_assembly kernel launch failed: cuda error "
                           f"{rc}")
    _backend.count_launch("gram_assembly", g.dtype)
    return m


def gram_assembly(g: torch.Tensor, lo: torch.Tensor,
                  n_pad: int) -> torch.Tensor:
    """(B, H, H), (B,) window starts -> (n_pad, n_pad) M.  CPU: plain
    version; otherwise the CUDA kernel, or raise."""
    if g.device.type == "cpu":
        return gram_assembly_torch(g, lo, n_pad)
    return gram_assembly_cuda(g, lo, n_pad)
