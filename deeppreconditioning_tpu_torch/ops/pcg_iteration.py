"""The masked PCG iteration's vector and scalar work, fused, and its plain
version.

The single-system chunked PCG (``solvers/cg.py``) runs an iteration around
its own operator product and preconditioner apply as

    update_xr(state, matvec(A, state.p), rtol, max_iter)
    update_p(state, apply_m(M, state.r), max_iter)

on a ``PCGState``: x, r and p (the kernels update them in place), and the
scalars on the device (``vals`` in the vectors' dtype: rz, alpha, beta,
b.b and the residual (r.r) / (b.b); ``flags``, int32: k, done, frozen,
stop and the kernels' ticket).

* ``update_xr``: frozen = done | k >= max_iter, kept for the iteration;
  alpha = 0 if frozen else rz / (Ap.p); x = x + alpha p and, where not
  frozen, r = r - alpha Ap; the residual (r.r) / (b.b), and done once it
  is below ``rtol``.
* ``update_p``: where not frozen, rz' = r.z, beta = rz' / rz,
  p = z + beta p, rz = rz' and k += 1; stop = done | k >= max_iter, which
  the solver reads on the host.

This is the update order of the module docstring of ``solvers/cg.py``,
with r.z carried from one iteration to the next rather than taken twice.

Dispatch follows the tensor: a CPU tensor, and a call autograd has to
follow (``needs_autograd``: grad mode on and the state or the operand
needing a gradient), take the plain PyTorch version (``update_xr_torch``,
``update_p_torch``: the solver's ops as they were, which give its CPU
results their bits; they bind the state to fresh tensors, so autograd
follows them); any other CUDA tensor launches the hand-written kernels of
``csrc/pcg_iteration.cu`` (which replace no TPU kernel: they fuse
PyTorch's ~31 small kernels an iteration), which update the state in
place, or raises.  There is no fallback from the kernels to the plain
version.  Above ``SINGLE_BLOCK_MAX_N`` entries each half is two launches
of ``grid_for(n)`` blocks, at or below it one launch of one block; each
launch is counted under ``pcg_iteration``.  The kernels sum their dots in
the vectors' precision (as the reference and cuBLAS do) in an order fixed
by n, so a call gives the same bits every time, eagerly or replayed from
a CUDA graph; they read no device value on the host.
"""

from __future__ import annotations

import torch

from deeppreconditioning_tpu_torch import _backend

KERNEL = "pcg_iteration"
KERNEL_DTYPES = (torch.float32, torch.float64)  # its two instances
SINGLE_BLOCK_MAX_N = 16384  # at or below: one block, two launches an iteration
BLOCK, UNROLL, MAX_GRID = 256, 4, 1024  # the multi-block kernels' grid
MAX_N = 2 ** 30  # int32 indexing with the grid's stride to spare
RZ, ALPHA, BETA, BB, RES = range(5)  # slots of ``vals``
K, DONE, FROZEN, STOP, TICKET = range(5)  # slots of ``flags``


def grid_for(n: int) -> int:
    """The kernels' blocks for an n-vector: 1 (the one-block kernels) at or
    below ``SINGLE_BLOCK_MAX_N``, else one block a 1024 entries, at most
    ``MAX_GRID``.  A function of n alone, so a solve's sums keep their
    order."""
    if n <= SINGLE_BLOCK_MAX_N:
        return 1
    return min(-(-n // (BLOCK * UNROLL)), MAX_GRID)


class PCGState:
    """x, r, p (n,), the scalars ``vals`` (b's dtype) and ``flags`` (int32),
    and ``work``, the multi-block kernels' partial sums (b's dtype), of one
    solve, on b's device; filled by ``start``, then updated in place by the
    kernels or bound to fresh tensors by the plain versions."""

    def __init__(self, b: torch.Tensor) -> None:
        self.x, self.r, self.p = (torch.empty_like(b) for _ in range(3))
        self.vals = torch.zeros(RES + 1, dtype=b.dtype, device=b.device)
        self.flags = torch.zeros(TICKET + 1, dtype=torch.int32,
                                 device=b.device)
        self.grid = grid_for(b.shape[0])
        self.work = torch.empty(self.grid, dtype=b.dtype, device=b.device)

    def start(self, r: torch.Tensor, z: torch.Tensor, bb: torch.Tensor,
              done: torch.Tensor, max_iter: int) -> None:
        """Take the start of a solve: x = 0, r, p = z, rz = r.z, b.b, the
        residual (r.r) / (b.b), k = 0, ``done``; no host read."""
        self.x.zero_()
        self.r.copy_(r)
        self.p.copy_(z)
        zero = torch.zeros_like(bb)
        self.vals.copy_(torch.stack(
            (torch.dot(r, z), zero, zero, bb, torch.dot(r, r) / bb)))
        done = done.to(torch.int32)
        stop = done if max_iter > 0 else torch.ones_like(done)
        nought = torch.zeros_like(done)
        self.flags.copy_(torch.stack((nought, done, nought, stop, nought)))

    @property
    def stop(self) -> torch.Tensor:
        """done | k >= max_iter, as the last half-iteration left it."""
        return self.flags[STOP]

    @property
    def k(self) -> torch.Tensor:
        """The iterations taken (int32)."""
        return self.flags[K]

    @property
    def residual(self) -> torch.Tensor:
        """(r.r) / (b.b), as the last half-iteration left it."""
        return self.vals[RES]


def update_xr_torch(s: PCGState, ap: torch.Tensor, rtol: float,
                    max_iter: int) -> None:
    """Plain PyTorch form of ``update_xr``: the solver's ops as they were,
    on fresh tensors bound into the state.  Any dtype and device; the
    kernels' oracle, and the route autograd follows."""
    _backend.count_plain(KERNEL, ap)
    rz, _, beta, bb, _ = s.vals.unbind()
    k, done, _, stop, ticket = s.flags.unbind()
    frozen = (done != 0) | (k >= max_iter)
    alpha = torch.where(frozen, torch.zeros_like(rz),
                        rz / torch.dot(ap, s.p))
    s.x = s.x + alpha * s.p
    s.r = torch.where(frozen, s.r, s.r - alpha * ap)
    res = torch.dot(s.r, s.r) / bb
    s.vals = torch.stack((rz, alpha, beta, bb, res))
    s.flags = torch.stack((k, ((done != 0) | (res < rtol)).int(),
                           frozen.int(), stop, ticket))


def update_p_torch(s: PCGState, z: torch.Tensor, max_iter: int) -> None:
    """Plain PyTorch form of ``update_p``, as ``update_xr_torch``."""
    _backend.count_plain(KERNEL, z)
    rz, alpha, _, bb, res = s.vals.unbind()
    k, done, frozen, _, ticket = s.flags.unbind()
    held = frozen != 0
    rz_new = torch.dot(s.r, z)
    beta = torch.where(held, torch.zeros_like(rz_new), rz_new / rz)
    s.p = torch.where(held, s.p, z + beta * s.p)
    k = torch.where(held, k, k + 1)
    s.vals = torch.stack((torch.where(held, rz, rz_new), alpha, beta, bb,
                          res))
    s.flags = torch.stack((k, done, frozen,
                           ((done != 0) | (k >= max_iter)).int(), ticket))


def needs_autograd(s: PCGState, *operands: torch.Tensor) -> bool:
    """Whether autograd has to follow a call on ``s``: grad mode on, and
    r, p or an operand needing a gradient (as they do through the rest of
    a solve whose start needed one)."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in (s.r, s.p, *operands))


def _span(t: torch.Tensor) -> tuple[int, int]:
    start = t.data_ptr()
    return start, start + t.numel() * t.element_size()


def check_pcg_args(s: PCGState, v: torch.Tensor, written=()) -> None:
    """Raise ValueError on anything the kernels do not take: device, dtype,
    shape, contiguity, the size of n, the state's scalars and grid, a
    ``v`` (Ap or z) that overlaps a vector of ``written`` (those the call
    updates in place), and a ``v`` that needs a gradient under grad mode
    (the kernels have no backward)."""
    vectors = (s.x, s.r, s.p, v)
    if any(t.device.type != "cuda" or t.device != v.device
           for t in (*vectors, s.vals, s.flags, s.work)):
        raise ValueError("pcg_iteration needs every tensor on one CUDA "
                         "device")
    if v.dtype not in KERNEL_DTYPES:
        raise ValueError(f"the vectors must be float32 or float64, got "
                         f"{v.dtype}")
    if any(t.dtype != v.dtype for t in (*vectors, s.vals, s.work)):
        raise ValueError("x, r, p, the operand, vals and work must share a "
                         "dtype")
    n = v.shape[0] if v.dim() == 1 else -1
    if any(tuple(t.shape) != (n,) for t in vectors):
        raise ValueError(f"x, r, p and the operand must be one (n,) shape, "
                         f"got {[tuple(t.shape) for t in vectors]}")
    if not all(t.is_contiguous() for t in vectors):
        raise ValueError("x, r, p and the operand must be contiguous")
    if not 1 <= n <= MAX_N:
        raise ValueError(f"n {n} must lie in 1..{MAX_N}")
    if (s.flags.dtype != torch.int32 or s.vals.numel() <= RES
            or s.flags.numel() <= TICKET
            or s.grid != grid_for(n) or s.work.numel() < s.grid):
        raise ValueError("the state's scalars, scratch or grid do not fit "
                         f"n {n}")
    lo, hi = _span(v)
    if any(lo < end and start < hi for start, end in map(_span, written)):
        raise ValueError("the operand overlaps a vector the call updates")
    if torch.is_grad_enabled() and v.requires_grad:
        raise ValueError("pcg_iteration has no backward: the operand must "
                         "not require a gradient")


def _launched(rc: int, s: PCGState, dtype: torch.dtype) -> None:
    if rc != 0:
        raise RuntimeError(f"pcg_iteration launch failed: cuda error {rc}")
    for _ in range(1 if s.grid == 1 else 2):
        _backend.count_launch(KERNEL, dtype)


def _args(s: PCGState, max_iter: int) -> tuple:
    if not 0 <= max_iter < 2 ** 31:
        raise ValueError(f"max_iter {max_iter} must fit an int32")
    return (s.vals.data_ptr(), s.flags.data_ptr(), s.work.data_ptr(),
            s.x.shape[0], s.grid, max_iter)


def update_xr_cuda(s: PCGState, ap: torch.Tensor, rtol: float,
                   max_iter: int) -> None:
    """Launch the p.Ap dot and the x and r update on the current stream;
    raises on anything they do not take (``check_pcg_args``) and on a
    refused launch."""
    lib = _backend.kernel_library()
    check_pcg_args(s, ap, written=(s.x, s.r))
    entry = (lib.dp_pcg_xr_f64 if ap.dtype == torch.float64
             else lib.dp_pcg_xr_f32)
    stream = torch.cuda.current_stream(ap.device).cuda_stream
    _launched(entry(s.x.data_ptr(), s.r.data_ptr(), s.p.data_ptr(),
                    ap.data_ptr(), *_args(s, max_iter), float(rtol), stream),
              s, ap.dtype)


def update_p_cuda(s: PCGState, z: torch.Tensor, max_iter: int) -> None:
    """Launch the r.z dot and the p update on the current stream; raises
    as ``update_xr_cuda``."""
    lib = _backend.kernel_library()
    check_pcg_args(s, z, written=(s.p,))
    entry = (lib.dp_pcg_p_f64 if z.dtype == torch.float64
             else lib.dp_pcg_p_f32)
    stream = torch.cuda.current_stream(z.device).cuda_stream
    _launched(entry(s.r.data_ptr(), z.data_ptr(), s.p.data_ptr(),
                    *_args(s, max_iter), stream), s, z.dtype)


def update_xr(s: PCGState, ap: torch.Tensor, rtol: float,
              max_iter: int) -> None:
    """The iteration's first half, after Ap = matvec(A, p).  CPU, or a
    call autograd follows: plain version; otherwise the CUDA kernels, or
    raise."""
    if ap.device.type == "cpu" or needs_autograd(s, ap):
        update_xr_torch(s, ap, rtol, max_iter)
    else:
        update_xr_cuda(s, ap, rtol, max_iter)


def update_p(s: PCGState, z: torch.Tensor, max_iter: int) -> None:
    """The iteration's second half, after z = apply_m(M, r).  CPU, or a
    call autograd follows: plain version; otherwise the CUDA kernels, or
    raise."""
    if z.device.type == "cpu" or needs_autograd(s, z):
        update_p_torch(s, z, max_iter)
    else:
        update_p_cuda(s, z, max_iter)
