"""Preconditioned conjugate gradient, chunked with one host read per chunk.

Numeric contract of ``deeppreconditioning_tpu/solvers/cg.py``:
  * stop when the squared relative residual ``(r.r) / (b.b) < rtol``
    (default 1e-8), at most ``max_iter`` (1024) iterations, ``b.b == 0``
    guarded to 1;
  * the preconditioner is a callable ``z = apply_m(m_data, r)``;
  * update order Ap, rz, alpha = rz / (Ap.p), x, r, z, beta, p;
  * the convergence check is seeded with ``r``.

The loop runs ``check_every`` masked iterations per chunk, all on the
device (the state freezes once done, or at ``max_iter``), and reads
``done | k >= max_iter`` on the host once per chunk.  Iteration counts
are exact per iteration, not rounded to chunks.  An iteration's vector
and scalar work around ``matvec`` and ``apply_m`` is
``ops.pcg_iteration``'s two halves on a ``PCGState``: on the card their
hand-written kernels, in place (four launches an iteration, two at small
n); on the CPU, and in a solve under grad mode whose start needs a
gradient (an operand that requires one), their plain versions, the same
ops as before the fusion on fresh tensors, which give the solver's CPU
results their bits and which autograd follows.  Under a
``torch.profiler`` the two chunked solvers record the spans
``pcg.solve``, ``pcg.chunk`` and ``pcg.read`` and count the iterations
they execute, masked ones included, in ``pcg.system_iterations``, those
of them off the autograd route in ``pcg.fused_iterations``, and the
products with the system's operator they enqueue in
``pcg.operator_products`` (``utils/tracing.py``): one an iteration and
at the start, and those the preconditioner makes, as ``apply_m``
declares them (``operator_products``).  ``pcg_fixed_trips`` runs the
same masked iteration a fixed number of times with no host read at all,
so its counts equal the chunked solver's whenever ``trips`` covers the
solve.

On a CUDA device ``preconditioned_conjugate_gradient`` replays the chunk
from CUDA graphs (``utils/graphs.py``) where ``matvec`` and ``apply_m``
are both declared ``capture_safe`` (``ell_matvec``, ``dense_matvec``,
``identity_apply``, ``ops.dia_spmv.dia_matvec``, the apply of
``ops.structured_fsai.make_structured_poly_apply_dia``, the multigrid's
``ops.gmg.gmg_apply``) and the seam's eager rule lets it; every other call
(the IC and ILU level waves, AMG, a caller's own closure, the CPU) runs
the eager loop.  The key adds the two callables, ``rtol``, ``max_iter``
and ``check_every`` to the walk of ``(a_data, b, m_data)`` (a multigrid's
levels and root included) and is captured on its first call.  The stages
are the start and one chunk of ``check_every`` masked iterations over a
static ``PCGState``, which the kernels update in place: a solve replays
the start, then per chunk reads its stop flag on the host and replays
the chunk, and returns fresh copies of x, the count and the residual.
The spans stay outside the graphs; each replay counts the operator
products its capture enqueued, and the graphed solve counts
``pcg.graph_chunks`` and ``pcg.graph_captures``.

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

from deeppreconditioning_tpu_torch.ops import pcg_iteration
from deeppreconditioning_tpu_torch.utils import graphs
from deeppreconditioning_tpu_torch.utils.graphs import capture_safe
from deeppreconditioning_tpu_torch.utils.tracing import count, span


class CGResult(NamedTuple):
    x: torch.Tensor
    iterations: torch.Tensor  # int32 scalar
    residual: torch.Tensor  # final (r.r)/(b.b)


def operator_products(apply_m) -> int:
    """The products with the system's operator that one PCG iteration (or
    the start) enqueues: the solver's own, and those one call of
    ``apply_m`` makes, as it declares them in its attribute
    ``operator_products`` (none where it declares nothing)."""
    return 1 + getattr(apply_m, "operator_products", 0)


@capture_safe
def identity_apply(m_data: Any, r: torch.Tensor) -> torch.Tensor:
    """Vanilla 'preconditioner': z = r."""
    del m_data
    return r


@capture_safe
def dense_matvec(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return a @ x


@capture_safe
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


def _state(s: _PCGState, bb, max_iter) -> pcg_iteration.PCGState:
    """The iteration's state from the start ``s``."""
    state = pcg_iteration.PCGState(s.r)
    state.start(s.r, s.z, bb, s.done, max_iter)
    return state


def _iteration(matvec, a_data, apply_m, m_data, s: pcg_iteration.PCGState,
               rtol, max_iter) -> None:
    """One PCG iteration into ``s``, frozen once done (or at
    ``max_iter``): ``ops.pcg_iteration``'s halves around the product and
    the apply."""
    pcg_iteration.update_xr(s, matvec(a_data, s.p), rtol, max_iter)
    pcg_iteration.update_p(s, apply_m(m_data, s.r), max_iter)


def _result(s: pcg_iteration.PCGState) -> CGResult:
    return CGResult(x=s.x, iterations=s.k.clone(),
                    residual=s.residual.clone())


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
    dev = b.device
    with span("pcg.solve", dev):
        key, leaves = _graph_key(matvec, a_data, b, apply_m, m_data, rtol,
                                 max_iter, check_every)
        if key is not None and _eager_because(matvec, apply_m,
                                              leaves) is None:
            return _graphs.lookup(key, lambda: _ChunkGraph(
                leaves, matvec, a_data, b, apply_m, m_data, rtol, max_iter,
                check_every)).solve(leaves)
        products = operator_products(apply_m)
        s, bb = _pcg_start(matvec, a_data, b, apply_m, m_data, rtol)
        count("pcg.operator_products", products)
        state = _state(s, bb, max_iter)
        fused = not pcg_iteration.needs_autograd(state)
        while True:
            with span("pcg.read", dev):
                running = not bool(state.stop)
            if not running:
                break
            with span("pcg.chunk", dev):
                for _ in range(check_every):
                    _iteration(matvec, a_data, apply_m, m_data, state, rtol,
                               max_iter)
            _count_chunk(check_every, products, fused)
        return _result(state)


def _count_chunk(check_every: int, products: int, fused: bool) -> None:
    """The counters of one chunk of the single-system solver."""
    count("pcg.system_iterations", check_every)
    count("pcg.operator_products", check_every * products)
    if fused:
        count("pcg.fused_iterations", check_every)


def _eager_because(matvec, apply_m, leaves) -> str | None:
    """Why a solve takes the eager loop ("undeclared": a callable not
    declared ``capture_safe``; else ``graphs.eager_because`` of its
    operand tensors), or None where its chunk is replayed."""
    if not (getattr(matvec, "capture_safe", False)
            and getattr(apply_m, "capture_safe", False)):
        return "undeclared"
    return graphs.eager_because(leaves)


def _graph_key(matvec, a_data, b, apply_m, m_data, rtol, max_iter,
               check_every):
    """(key, operand tensors in walk order) of a solve, or (None, None)
    where an operand holds a type the walk does not take."""
    try:
        operands, leaves = graphs.walk((a_data, b, m_data))
    except TypeError:
        return None, None
    return (matvec, apply_m, operands, rtol, max_iter, check_every), leaves


class _ChunkGraph(graphs.GraphEntry):
    """One key's graphed solve: its static state, and the start and chunk
    graphs (see the module docstring)."""

    def __init__(self, leaves, matvec, a_data, b, apply_m, m_data, rtol,
                 max_iter, check_every) -> None:
        super().__init__((a_data, b, m_data), b.device)
        self.a, self.b, self.m = self.operands
        self.matvec, self.apply_m = matvec, apply_m
        self.products = operator_products(apply_m)
        self.rtol, self.max_iter, self.check_every = rtol, max_iter, check_every
        self.state = pcg_iteration.PCGState(self.b)
        self.load(leaves)
        _, self.graphs = graphs.capture_graphs(self.device, self._warm,
                                               self._start, self._chunk)
        count("pcg.graph_captures")

    def _warm(self) -> None:
        self._start()
        self._iteration()

    def _start(self) -> None:
        s, bb = _pcg_start(self.matvec, self.a, self.b, self.apply_m,
                           self.m, self.rtol)
        self.state.start(s.r, s.z, bb, s.done, self.max_iter)

    def _iteration(self) -> None:
        _iteration(self.matvec, self.a, self.apply_m, self.m, self.state,
                   self.rtol, self.max_iter)

    def _chunk(self) -> None:
        for _ in range(self.check_every):
            self._iteration()

    def solve(self, leaves) -> CGResult:
        """The chunked solve of operands ``leaves`` (``_graph_key``'s)."""
        dev = self.device
        start, chunk = self.graphs
        self.load(leaves)
        start.replay()
        count("pcg.operator_products", self.products)
        while True:
            with span("pcg.read", dev):
                running = not bool(self.state.stop)
            if not running:
                break
            with span("pcg.chunk", dev):
                chunk.replay()
            count("pcg.graph_chunks")
            _count_chunk(self.check_every, self.products, fused=True)
        result = _result(self.state)
        return result._replace(x=result.x.clone())


_graphs = graphs.GraphCache()  # key -> _ChunkGraph, captured at once


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
    state = _state(s, bb, max_iter)
    if not pcg_iteration.needs_autograd(state):
        count("pcg.fused_iterations", trips)
    for _ in range(trips):
        _iteration(matvec, a_data, apply_m, m_data, state, rtol, max_iter)
    return _result(state)


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
    dev = b.device
    with span("pcg.solve", dev):
        products = operator_products(apply_m)
        s, bb = _batched_start(matvec, a_data, b, apply_m, m_data, rtol)
        count("pcg.operator_products", products)
        while True:
            with span("pcg.read", dev):
                running = bool((~s.done & (s.k < max_iter)).any())
            if not running:
                break
            with span("pcg.chunk", dev):
                for _ in range(check_every):
                    s = _batched_iteration(matvec, a_data, apply_m, m_data,
                                           s, bb, rtol, max_iter)
            count("pcg.system_iterations", b.shape[0] * check_every)
            count("pcg.operator_products", check_every * products)
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
