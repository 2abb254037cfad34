"""Preconditioned conjugate gradient, chunked with one host read per chunk.

Numeric contract of ``deeppreconditioning_tpu/solvers/cg.py``:
  * stop when the squared relative residual ``(r.r) / (b.b) < rtol``
    (default 1e-8), at most ``max_iter`` (1024) iterations, ``b.b == 0``
    guarded to 1;
  * the preconditioner is a callable ``z = apply_m(m_data, r)``;
  * update order Ap, rz, alpha = rz / (Ap.p), x, r, z, beta, p;
  * the convergence check is seeded with ``r``.

The loop runs ``check_every`` masked iterations per chunk, all on the
device (``torch.where`` freezes the state once done), and reads ``done``
on the host once per chunk.  Iteration counts are exact per iteration,
not rounded to chunks.  ``pcg_fixed_trips`` runs the same masked
iteration a fixed number of times with no host read at all, so its
counts equal the chunked solver's whenever ``trips`` covers the solve.

``batched_preconditioned_conjugate_gradient`` and
``batched_pcg_fixed_trips`` solve B independent systems at once, x and b
(B, n), with the same masked semantics per case: every scalar is a
per-case dot, a case freezes once it converges (or at ``max_iter``), and
the chunked form reads on the host, once per chunk, whether any case is
still running.  The matvec and the preconditioner take (B, n).

``pcg_sequence_fixed_trips`` solves k right-hand sides of one operator in
order, each a cold-start fixed-trip solve (the multi-RHS protocol);
``conjugate_gradient`` is PCG with the identity; ``pcg_with_history``
returns the residual curve of ``max_iter`` masked iterations (running
them until ``done`` reads true at a chunk's end);
``benchmark_cg`` is the reference's scipy wrapper (host).
"""

from __future__ import annotations

import time
from typing import Any, Callable, NamedTuple

import torch


class CGResult(NamedTuple):
    x: torch.Tensor
    iterations: torch.Tensor  # int32 scalar
    residual: torch.Tensor  # final (r.r)/(b.b)


def identity_apply(m_data: Any, r: torch.Tensor) -> torch.Tensor:
    """Vanilla 'preconditioner': z = r."""
    del m_data
    return r


def dense_matvec(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return a @ x


def ell_matvec(a, x: torch.Tensor) -> torch.Tensor:
    """Matvec for sparse/ell.py ELLMatrix operands."""
    return a.matvec(x)


class _PCGState(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    z: torch.Tensor
    p: torch.Tensor
    k: torch.Tensor  # int32 scalar: iterations taken
    done: torch.Tensor  # bool scalar: (r.r)/(b.b) < rtol reached


def _pcg_start(matvec, a_data, b, apply_m, m_data, rtol):
    x = torch.zeros_like(b)
    r = b - matvec(a_data, x)
    z = apply_m(m_data, r)
    bb = torch.dot(b, b)
    bb = torch.where(bb == 0, torch.ones_like(bb), bb)
    k = torch.zeros((), dtype=torch.int32, device=b.device)
    return _PCGState(x, r, z, z, k, torch.dot(r, r) / bb < rtol), bb


def _masked_iteration(matvec, a_data, apply_m, m_data, s: _PCGState, bb,
                      rtol, max_iter) -> _PCGState:
    """One PCG iteration, frozen by ``torch.where`` once done (or at
    ``max_iter``)."""
    frozen = s.done | (s.k >= max_iter)
    zero = torch.zeros((), dtype=s.r.dtype, device=s.r.device)
    ap = matvec(a_data, s.p)
    rz = torch.dot(s.r, s.z)
    denom = torch.dot(ap, s.p)
    alpha = torch.where(frozen, zero, rz / denom)
    x = s.x + alpha * s.p
    r_new = torch.where(frozen, s.r, s.r - alpha * ap)
    z_new = torch.where(frozen, s.z, apply_m(m_data, r_new))
    beta = torch.where(frozen, zero, torch.dot(r_new, z_new) / rz)
    p = torch.where(frozen, s.p, z_new + beta * s.p)
    k = torch.where(frozen, s.k, s.k + 1)
    done = s.done | (torch.dot(r_new, r_new) / bb < rtol)
    return _PCGState(x, r_new, z_new, p, k, done)


def preconditioned_conjugate_gradient(
    matvec: Callable[[Any, torch.Tensor], torch.Tensor],
    a_data: Any,
    b: torch.Tensor,
    apply_m: Callable[[Any, torch.Tensor], torch.Tensor] = identity_apply,
    m_data: Any = None,
    rtol: float = 1e-8,
    max_iter: int = 1024,
    check_every: int = 64,
) -> CGResult:
    """Solve A x = b with PCG (see the module docstring)."""
    s, bb = _pcg_start(matvec, a_data, b, apply_m, m_data, rtol)
    while not bool(s.done | (s.k >= max_iter)):
        for _ in range(check_every):
            s = _masked_iteration(matvec, a_data, apply_m, m_data, s, bb,
                                  rtol, max_iter)
    return CGResult(x=s.x, iterations=s.k, residual=torch.dot(s.r, s.r) / bb)


def pcg_fixed_trips(
    matvec: Callable[[Any, torch.Tensor], torch.Tensor],
    a_data: Any,
    b: torch.Tensor,
    apply_m: Callable[[Any, torch.Tensor], torch.Tensor] = identity_apply,
    m_data: Any = None,
    rtol: float = 1e-8,
    max_iter: int = 1024,
    trips: int = 8,
) -> CGResult:
    """PCG for exactly ``trips`` masked iterations, with no host read:
    the same iterations, count and x as the chunked solver when ``trips``
    covers the solve."""
    s, bb = _pcg_start(matvec, a_data, b, apply_m, m_data, rtol)
    for _ in range(trips):
        s = _masked_iteration(matvec, a_data, apply_m, m_data, s, bb, rtol,
                              max_iter)
    return CGResult(x=s.x, iterations=s.k, residual=torch.dot(s.r, s.r) / bb)


def pcg_sequence_fixed_trips(
    matvec: Callable[[Any, torch.Tensor], torch.Tensor],
    a_data: Any,
    b_seq: torch.Tensor,
    apply_m: Callable[[Any, torch.Tensor], torch.Tensor] = identity_apply,
    m_data: Any = None,
    rtol: float = 1e-8,
    max_iter: int = 1024,
    trips: int = 8,
):
    """k solves of one operator, in order, each ``pcg_fixed_trips`` from
    x0 = 0 (the reference's cold start), with no host read.  Returns
    (x_seq (k, n), iterations (k,) int32, residuals (k,))."""
    results = [pcg_fixed_trips(matvec, a_data, b, apply_m, m_data, rtol=rtol,
                               max_iter=max_iter, trips=trips)
               for b in b_seq]
    return (torch.stack([r.x for r in results]),
            torch.stack([r.iterations for r in results]),
            torch.stack([r.residual for r in results]))


def conjugate_gradient(
    matvec: Callable[[Any, torch.Tensor], torch.Tensor],
    a_data: Any,
    b: torch.Tensor,
    rtol: float = 1e-8,
    max_iter: int = 1024,
) -> CGResult:
    """Plain CG: PCG with the identity preconditioner."""
    return preconditioned_conjugate_gradient(
        matvec, a_data, b, identity_apply, None, rtol=rtol, max_iter=max_iter
    )


def benchmark_cg(matrix, right_hand_side, preconditioner=None):
    """The reference's scipy CG benchmark (``solvers/cg.py::benchmark_cg``):
    scipy defaults, maxiter 512, iterations counted by callback.  Returns
    (duration_seconds, iterations, info)."""
    from scipy.sparse.linalg import cg as scipy_cg

    iterations = 0

    def callback(_):
        nonlocal iterations
        iterations += 1

    start = time.perf_counter()
    _, info = scipy_cg(matrix, right_hand_side, maxiter=512, M=preconditioner,
                       callback=callback)
    return time.perf_counter() - start, iterations, info


def pcg_with_history(
    matvec: Callable[[Any, torch.Tensor], torch.Tensor],
    a_data: Any,
    b: torch.Tensor,
    apply_m: Callable[[Any, torch.Tensor], torch.Tensor] = identity_apply,
    m_data: Any = None,
    rtol: float = 1e-8,
    max_iter: int = 1024,
    check_every: int = 64,
):
    """PCG for ``max_iter`` masked iterations returning the squared
    relative residual after each (history[i] after i + 1 iterations, held
    once converged), as the reference's scan.  Returns (CGResult, history
    (max_iter,)).  ``done`` is read on the host once per ``check_every``
    iterations; once it holds, every later masked iteration would leave
    the state and its residual as they are, so the rest of the history is
    the last residual repeated, with no more iterations run."""
    x = torch.zeros_like(b)
    r = b - matvec(a_data, x)
    z = apply_m(m_data, r)
    p = z
    bb = torch.dot(b, b)
    bb = torch.where(bb == 0, torch.ones_like(bb), bb)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    k = torch.zeros((), dtype=torch.int32, device=b.device)
    done = torch.dot(r, r) / bb < rtol
    history = []
    while len(history) < max_iter:
        if history and len(history) % check_every == 0 and bool(done):
            history += [history[-1]] * (max_iter - len(history))
            break
        ap = matvec(a_data, p)
        rz = torch.dot(r, z)
        denom = torch.dot(ap, p)
        alpha = torch.where(done, zero, rz / denom)
        x = x + alpha * p
        r_new = torch.where(done, r, r - alpha * ap)
        z_new = torch.where(done, z, apply_m(m_data, r_new))
        beta = torch.where(done, zero, torch.dot(r_new, z_new) / rz)
        p = torch.where(done, p, z_new + beta * p)
        res = torch.dot(r_new, r_new) / bb
        k = torch.where(done, k, k + 1)
        done = done | (res < rtol)
        r, z = r_new, z_new
        history.append(res)
    return (CGResult(x=x, iterations=k, residual=torch.dot(r, r) / bb),
            torch.stack(history))


def _dots(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (u * v).sum(dim=-1)


def _batched_start(matvec, a_data, b, apply_m, m_data, rtol):
    x = torch.zeros_like(b)
    r = b - matvec(a_data, x)
    z = apply_m(m_data, r)
    bb = _dots(b, b)
    bb = torch.where(bb == 0, torch.ones_like(bb), bb)
    k = torch.zeros(b.shape[0], dtype=torch.int32, device=b.device)
    return _PCGState(x, r, z, z, k, _dots(r, r) / bb < rtol), bb


def _batched_iteration(matvec, a_data, apply_m, m_data, s: _PCGState, bb,
                       rtol, max_iter) -> _PCGState:
    """One PCG iteration of every case; a case that is done (or at
    ``max_iter``) stays frozen."""
    frozen = s.done | (s.k >= max_iter)  # (B,)
    fz = frozen[:, None]
    zero = torch.zeros((), dtype=s.r.dtype, device=s.r.device)
    ap = matvec(a_data, s.p)
    rz = _dots(s.r, s.z)
    denom = _dots(ap, s.p)
    alpha = torch.where(frozen, zero, rz / denom)
    x = s.x + alpha[:, None] * s.p
    r_new = torch.where(fz, s.r, s.r - alpha[:, None] * ap)
    z_new = torch.where(fz, s.z, apply_m(m_data, r_new))
    beta = torch.where(frozen, zero, _dots(r_new, z_new) / rz)
    p = torch.where(fz, s.p, z_new + beta[:, None] * s.p)
    k = torch.where(frozen, s.k, s.k + 1)
    done = s.done | (_dots(r_new, r_new) / bb < rtol)
    return _PCGState(x, r_new, z_new, p, k, done)


def batched_preconditioned_conjugate_gradient(
    matvec: Callable[[Any, torch.Tensor], torch.Tensor],
    a_data: Any,
    b: torch.Tensor,
    apply_m: Callable[[Any, torch.Tensor], torch.Tensor] = identity_apply,
    m_data: Any = None,
    rtol: float = 1e-8,
    max_iter: int = 1024,
    check_every: int = 8,
) -> CGResult:
    """Solve B systems A_i x_i = b_i (b: (B, n)) until every case is done;
    x (B, n), iterations (B,) int32, residual (B,)."""
    s, bb = _batched_start(matvec, a_data, b, apply_m, m_data, rtol)
    while bool((~s.done & (s.k < max_iter)).any()):
        for _ in range(check_every):
            s = _batched_iteration(matvec, a_data, apply_m, m_data, s, bb,
                                   rtol, max_iter)
    return CGResult(x=s.x, iterations=s.k, residual=_dots(s.r, s.r) / bb)


def batched_pcg_fixed_trips(
    matvec: Callable[[Any, torch.Tensor], torch.Tensor],
    a_data: Any,
    b: torch.Tensor,
    apply_m: Callable[[Any, torch.Tensor], torch.Tensor] = identity_apply,
    m_data: Any = None,
    rtol: float = 1e-8,
    max_iter: int = 1024,
    trips: int = 8,
) -> CGResult:
    """The batched solve for exactly ``trips`` masked iterations, with no
    host read: the chunked solver's counts and x whenever ``trips`` covers
    the slowest case (a case it does not cover reports ``trips``
    iterations and a residual >= rtol)."""
    s, bb = _batched_start(matvec, a_data, b, apply_m, m_data, rtol)
    for _ in range(trips):
        s = _batched_iteration(matvec, a_data, apply_m, m_data, s, bb, rtol,
                               max_iter)
    return CGResult(x=s.x, iterations=s.k, residual=_dots(s.r, s.r) / bb)
