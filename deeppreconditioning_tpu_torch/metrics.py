"""Training losses and quality metrics for learned preconditioners.

Counterpart of ``deeppreconditioning_tpu/metrics.py``: the six losses over
batched dense (B, n, n) operands (``frobenius_loss`` over a
``BatchedCOO``), each differentiable by autograd.  Dense products are full
float32 on the card (TF32 off, ``_backend``), as the reference runs them
at ``Precision.HIGHEST``.
"""

from __future__ import annotations

import torch

from deeppreconditioning_tpu_torch.sparse.coo import (
    BatchedCOO,
    batched_coo_matvec,
)


def scatter_tril_dense(
    values: torch.Tensor,  # (B, nnz_pad)
    rows: torch.Tensor,  # (B, nnz_pad)
    cols: torch.Tensor,
    valid: torch.Tensor,
    n: int,
) -> torch.Tensor:
    """Scatter batched sparse tril values into dense (B, n, n); sites
    outside [0, n) and padded sites are dropped."""
    ok = valid & (rows < n) & (cols < n) & (rows >= 0) & (cols >= 0)
    vals = torch.where(ok, values, 0.0)
    lin = rows.clamp(0, n - 1) * n + cols.clamp(0, n - 1)
    out = values.new_zeros(values.shape[0], n * n)
    return out.scatter_add(1, lin.long(), vals).reshape(-1, n, n)


def symmetrize_tril(a_tril: torch.Tensor) -> torch.Tensor:
    """(B, n, n) tril -> full symmetric A."""
    return a_tril + torch.tril(a_tril, -1).mT


def _eye_like(a: torch.Tensor) -> torch.Tensor:
    return torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)[None]


def inverse_loss(
    systems_tril_dense: torch.Tensor,  # (B, n, n) lower-triangular A part
    l_dense: torch.Tensor,  # (B, n, n) lower-triangular factor L
) -> torch.Tensor:
    """Mean over the batch of ||(L L^T) A - I||_F."""
    m = l_dense @ l_dense.mT
    a = symmetrize_tril(systems_tril_dense)
    ma = m @ a
    return torch.sqrt(((ma - _eye_like(a)) ** 2).sum(dim=(1, 2))).mean()


def frobenius_loss(
    l_coo: BatchedCOO,
    solutions: torch.Tensor,  # (B, n)
    right_hand_sides: torch.Tensor,  # (B, n)
) -> torch.Tensor:
    """||L (L^T x) - b||_2 summed over the batch: two sparse matvecs, no
    densification."""
    interim = batched_coo_matvec(l_coo, solutions, transpose=True)
    interim = batched_coo_matvec(l_coo, interim, transpose=False)
    return torch.linalg.vector_norm(interim - right_hand_sides, dim=1).sum()


def hutchinson_trace(
    systems_tril_dense: torch.Tensor,
    l_dense: torch.Tensor,
    generator: torch.Generator | None = None,
    probes: torch.Tensor | None = None,
) -> torch.Tensor:
    """Stochastic ||(L L^T - A) v|| estimate, mean over the batch.

    The probes v (B, n) are ``probes`` when given (the parity tests pass
    the reference's ``jax.random.normal`` draws), else standard normal
    draws from ``generator``."""
    a = symmetrize_tril(systems_tril_dense)
    b, n, _ = a.shape
    if probes is None:
        probes = torch.randn((b, n), generator=generator, dtype=a.dtype,
                             device=a.device)
    v = probes.to(a.dtype)[..., None]
    lv = l_dense @ (l_dense.mT @ v)
    return torch.linalg.vector_norm((lv - a @ v)[..., 0], dim=1).mean()


def condition_loss(
    systems_tril_dense: torch.Tensor,
    l_dense: torch.Tensor,
) -> torch.Tensor:
    """Mean condition number of M A (M = L L^T) from its singular
    values."""
    m = l_dense @ l_dense.mT
    ma = m @ symmetrize_tril(systems_tril_dense)
    sigmas = torch.linalg.svdvals(ma)
    return (sigmas.max(dim=1).values / sigmas.min(dim=1).values).mean()


def _bmv(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (a @ x[..., None])[..., 0]


def pcg_residual_loss(
    systems_tril_dense: torch.Tensor,  # (B, n, n) lower-triangular A part
    m_dense: torch.Tensor,  # (B, n, n) dense SPD preconditioner M ~= A^-1
    right_hand_sides: torch.Tensor,  # (B, n)
    k_steps: int = 16,
    floor: float = 1e-12,
) -> torch.Tensor:
    """Mean log squared relative residual after ``k_steps`` of PCG from
    x0 = 0: ``log(max(r_k.r_k / b.b, floor))``, the differentiable proxy
    for the deployed iteration count.  The update order and the
    zero-denominator guards are the reference's."""
    a = symmetrize_tril(systems_tril_dense)
    b = right_hand_sides
    bb = torch.clamp((b * b).sum(dim=1), min=1e-30)
    x = torch.zeros_like(b)
    r = b
    z = _bmv(m_dense, r)
    p = z
    for _ in range(k_steps):
        ap = _bmv(a, p)
        rz = (r * z).sum(dim=1)
        denom = (ap * p).sum(dim=1)
        alpha = rz / torch.where(denom == 0, 1.0, denom)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * ap
        z = _bmv(m_dense, r)
        beta = (r * z).sum(dim=1) / torch.where(rz == 0, 1.0, rz)
        p = z + beta[:, None] * p
    res = (r * r).sum(dim=1) / bb
    return torch.log(torch.clamp(res, min=floor)).mean()


def kaporin_loss(
    systems_tril_dense: torch.Tensor,  # (B, n, n) lower-triangular A part
    l_dense: torch.Tensor,  # (B, n, n) lower-triangular factor L
    eps: float = 1e-30,
) -> torch.Tensor:
    """Log Kaporin condition number of L^T A L up to a per-sample constant:
    ``log(trace(L^T A L) / n) - (2 / n) sum_j log |L_jj|``, mean over the
    batch."""
    a = symmetrize_tril(systems_tril_dense)
    n = a.shape[-1]
    al = a @ l_dense
    trace = (l_dense * al).sum(dim=(1, 2))
    diag = torch.diagonal(l_dense, dim1=1, dim2=2)
    logdet_term = torch.log(torch.clamp(diag.abs(), min=eps)).sum(dim=1)
    return (torch.log(torch.clamp(trace / n, min=eps))
            - (2.0 / n) * logdet_term).mean()
