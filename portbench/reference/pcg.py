"""Plain preconditioned conjugate gradient, for the control's solve.

Systems along a leading axis (b: (B, n)); each stops when its squared
relative residual (r.r) / (b.b) falls under ``rtol``, or at ``max_iter``.
``rnd`` rounds every vector the iteration stores (``neural_fsai.rounder``),
so the control solves in the precision below the configuration's.
"""

from __future__ import annotations

import torch


def pcg(matvec, apply_m, b: torch.Tensor, rtol: float, max_iter: int,
        rnd=lambda t: t) -> torch.Tensor:
    b = rnd(b)
    bb = (b * b).sum(-1)
    x = torch.zeros_like(b)
    r = b
    z = rnd(apply_m(r))
    p = z
    rz = (r * z).sum(-1)
    for _ in range(max_iter):
        running = (r * r).sum(-1) / bb >= rtol
        if not bool(running.any()):
            break
        ap = rnd(matvec(p))
        alpha = torch.where(running, rz / (ap * p).sum(-1), 0.0)[..., None]
        x = rnd(x + alpha * p)
        r = rnd(r - alpha * ap)
        z = rnd(apply_m(r))
        rz_new = (r * z).sum(-1)
        p = rnd(z + (rz_new / rz)[..., None] * p)
        rz = rz_new
    return x


def squared_residual(matvec, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(b - A x).(b - A x) / (b.b) per system, in float64."""
    r = b.double() - matvec(x.double())
    return (r * r).sum(-1) / (b.double() * b.double()).sum(-1)
