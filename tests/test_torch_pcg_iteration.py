"""The masked PCG iteration of the single-system solver, fused
(``ops/pcg_iteration.py``, ``csrc/pcg_iteration.cu``).

On the CPU: the solver through the plain versions gives, bit for bit, the
solve of a frozen copy of the loop as it ran before the iteration was
fused (ELL + dense M, the structured DIA apply, the multigrid apply;
float32 and float64; a system that freezes inside a chunk and one that
stops at ``max_iter``), so does the autograd route, and so does
``pcg_fixed_trips``; the counter ``pcg.fused_iterations``; the grid; and
the kernels' argument checks.  On a card the kernels against the plain
version, iteration counts against the old loop, determinism, graphed
against eager, both grids and their launch counts.

The card tests use no JAX:
``python -m pytest --noconftest -q -m cuda tests/test_torch_pcg_iteration.py``.
"""

import types

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from deeppreconditioning_tpu_torch import _backend
from deeppreconditioning_tpu_torch.data.poisson import (
    hpcg_operator,
    hpcg_rhs,
    poisson_coeff_dia,
)
from deeppreconditioning_tpu_torch.ops import gmg, pcg_iteration
from deeppreconditioning_tpu_torch.ops.dia_spmv import dia_matvec
from deeppreconditioning_tpu_torch.ops.pcg_iteration import (
    PCGState,
    check_pcg_args,
    grid_for,
)
from deeppreconditioning_tpu_torch.ops.structured_fsai import (
    bands_to_dia,
    build_structured_plan,
    make_structured_poly_apply_dia,
    structured_setup,
)
from deeppreconditioning_tpu_torch.solvers import cg
from deeppreconditioning_tpu_torch.sparse.ell import ELLMatrix
from deeppreconditioning_tpu_torch.utils import tracing
from deeppreconditioning_tpu_torch.utils.graphs import capture_safe


# -- the loop as it ran before the fusion, frozen ------------------------

def _old_iteration(matvec, a_data, apply_m, m_data, s, bb, rtol, max_iter):
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
    return cg._PCGState(x, r_new, z_new, p, k, done)


def _old_start(matvec, a_data, b, apply_m, m_data, rtol):
    x = torch.zeros_like(b)
    r = b - matvec(a_data, x)
    z = apply_m(m_data, r)
    bb = torch.dot(b, b)
    bb = torch.where(bb == 0, torch.ones_like(bb), bb)
    k = torch.zeros((), dtype=torch.int32, device=b.device)
    return cg._PCGState(x, r, z, z, k, torch.dot(r, r) / bb < rtol), bb


def _old_pcg(matvec, a_data, b, apply_m, m_data, rtol, max_iter,
             check_every):
    s, bb = _old_start(matvec, a_data, b, apply_m, m_data, rtol)
    while not bool(s.done | (s.k >= max_iter)):
        for _ in range(check_every):
            s = _old_iteration(matvec, a_data, apply_m, m_data, s, bb, rtol,
                               max_iter)
    return cg.CGResult(x=s.x, iterations=s.k,
                       residual=torch.dot(s.r, s.r) / bb)


def _old_fixed_trips(matvec, a_data, b, apply_m, m_data, rtol, max_iter,
                     trips):
    s, bb = _old_start(matvec, a_data, b, apply_m, m_data, rtol)
    for _ in range(trips):
        s = _old_iteration(matvec, a_data, apply_m, m_data, s, bb, rtol,
                           max_iter)
    return cg.CGResult(x=s.x, iterations=s.k,
                       residual=torch.dot(s.r, s.r) / bb)


# -- systems ---------------------------------------------------------------

@capture_safe
def _jacobi(d, r):
    return d * r


def _ell(seed, dtype, device=None, n=40, n_pad=48, dense=True):
    """(ELL A, b, dense Jacobi M with a weak symmetric band) of a random
    SPD 2-D five-point system of ``n`` live rows in ``n_pad``; with
    ``dense`` False, the Jacobi diagonal alone."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(n)))
    lap1 = sp.diags([-np.ones(side - 1), 2 * np.ones(side),
                     -np.ones(side - 1)], [-1, 0, 1])
    a = sp.kronsum(lap1, lap1).tocsr()[:n, :n]
    a = (a + sp.diags(10.0 ** rng.uniform(-1, 1, n))).tocsr()
    ell = ELLMatrix.from_scipy(a, n_pad=n_pad, dtype=dtype, device=device)
    b = torch.zeros(n_pad, dtype=dtype)
    b[:n] = torch.as_tensor(rng.standard_normal(n), dtype=dtype)
    d = 1.0 / a.diagonal()
    if not dense:
        diag = np.zeros(n_pad)
        diag[:n] = d
        return (cg.ell_matvec, ell, b.to(device), _jacobi,
                torch.as_tensor(diag, dtype=dtype, device=device))
    m = np.zeros((n_pad, n_pad))
    m[np.arange(n), np.arange(n)] = d
    off = 0.05 * np.sqrt(d[1:] * d[:-1])
    m[np.arange(1, n), np.arange(n - 1)] = off
    m[np.arange(n - 1), np.arange(1, n)] = off
    return (cg.ell_matvec, ell, b.to(device), cg.dense_matvec,
            torch.as_tensor(m, dtype=dtype, device=device))


_APPLY = make_structured_poly_apply_dia(1)


def _structured(seed, dtype, device=None, shape=(6, 5, 4), hpcg=False):
    """The structured FSAI solve: a lognormal 7-point field (or HPCG's
    27-point box and b = A 1), its classical factor, the wrap q = (1, q1)."""
    if hpcg:
        a = hpcg_operator(shape, dtype=dtype, device=device)
        b = hpcg_rhs(a)
        plan = build_structured_plan(shape, power=1, a_offsets=a.offsets)
    else:
        a = poisson_coeff_dia(shape, rng=np.random.default_rng(seed),
                              dtype=dtype, device=device)
        gen = torch.Generator().manual_seed(seed)
        b = torch.zeros(a.n_pad, dtype=dtype)
        b[:a.n] = torch.randn(a.n, generator=gen, dtype=dtype)
        b = b.to(device)
        plan = build_structured_plan(shape, power=2)
    with torch.no_grad():
        bands, _ = structured_setup(a, plan)
    c_up, c_low = bands_to_dia(bands, plan.offsets, a.n)
    q = torch.tensor([1.0, 0.05 + 0.1 * seed], dtype=dtype, device=device)
    return dia_matvec, a, b, _APPLY, (c_up, c_low, q, a)


def _multigrid(seed, dtype, device=None, shape=(16, 16, 16)):
    a = poisson_coeff_dia(shape, rng=np.random.default_rng(seed),
                          dtype=dtype, device=device)
    with torch.no_grad():
        m = gmg.build_gmg(a, shape)
    gen = torch.Generator().manual_seed(seed)
    b = torch.zeros(a.n_pad, dtype=dtype)
    b[:a.n] = torch.randn(a.n, generator=gen, dtype=dtype)
    return dia_matvec, a, b.to(device), gmg.gmg_apply, m


SYSTEMS = {"ell": _ell, "dia": _structured, "gmg": _multigrid}
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _same(got, want):
    assert torch.equal(got.x, want.x)
    assert torch.equal(got.iterations, want.iterations)
    assert torch.equal(got.residual, want.residual)


def _counters(fn):
    """``fn()``'s result and the tracer's counters while a profiler
    records."""
    tracing.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    counters = tracing.snapshot()["counters"]
    tracing.reset()
    return out, counters


# -- the CPU route: the plain versions, bit for bit ----------------------

@pytest.mark.parametrize("stop", ["converges", "max_iter"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", list(SYSTEMS))
def test_plain_route_matches_the_old_loop(kind, dtype, stop):
    """The solver on the CPU (the plain versions of the kernels, in
    place) against the old loop, bit for bit: x, the count and the
    residual.  A converging solve freezes inside its last chunk (of 3, 4
    or 5 iterations, whichever its count is no multiple of); a solve cut
    at ``max_iter`` 5 freezes inside its second."""
    matvec, a, b, apply_m, m = SYSTEMS[kind](3, DTYPES[dtype])
    max_iter = 256 if stop == "converges" else 5
    needed = int(_old_pcg(matvec, a, b, apply_m, m, 1e-8, max_iter,
                          1).iterations)
    check_every = next(c for c in (3, 4, 5) if needed % c)
    got = cg.preconditioned_conjugate_gradient(
        matvec, a, b, apply_m, m, rtol=1e-8, max_iter=max_iter,
        check_every=check_every)
    _same(got, _old_pcg(matvec, a, b, apply_m, m, 1e-8, max_iter,
                        check_every))
    assert int(got.iterations) == needed
    if stop == "max_iter":
        assert needed == 5 and float(got.residual) >= 1e-8
    else:
        assert float(got.residual) < 1e-8


TRIPS = 20


@pytest.mark.parametrize("kind", list(SYSTEMS))
def test_fixed_trips_match_the_old_loop(kind):
    """``pcg_fixed_trips`` and its sequence form, past convergence."""
    matvec, a, b, apply_m, m = SYSTEMS[kind](4, torch.float64)
    got = cg.pcg_fixed_trips(matvec, a, b, apply_m, m, rtol=1e-8,
                             max_iter=256, trips=TRIPS)
    want = _old_fixed_trips(matvec, a, b, apply_m, m, 1e-8, 256, TRIPS)
    _same(got, want)
    assert int(got.iterations) < TRIPS
    seq = cg.pcg_sequence_fixed_trips(matvec, a, torch.stack((b, 2 * b)),
                                      apply_m, m, trips=TRIPS)
    want2 = _old_fixed_trips(matvec, a, 2 * b, apply_m, m, 1e-8, 256,
                             TRIPS)
    assert torch.equal(seq[0][0], want.x) and torch.equal(seq[0][1],
                                                          want2.x)
    assert seq[1].tolist() == [int(want.iterations), int(want2.iterations)]


def test_grad_route_matches_the_old_loop_and_carries_gradients():
    """Under grad mode an operand that needs a gradient keeps the old ops
    (fresh tensors autograd follows): the same solve, and a gradient
    reaches the operand."""
    matvec, a, b, apply_m, m = _ell(5, torch.float64)
    m = m.requires_grad_()
    got = cg.preconditioned_conjugate_gradient(
        matvec, a, b, apply_m, m, rtol=1e-8, max_iter=256, check_every=4)
    assert got.x.requires_grad
    with torch.no_grad():
        want = _old_pcg(matvec, a, b, apply_m, m, 1e-8, 256, 4)
    _same(got, want)
    got.x.sum().backward()
    assert m.grad is not None and bool(m.grad.abs().sum() > 0)


def test_zero_rhs_and_zero_max_iter():
    """b = 0 (b.b guarded to 1) stops at once; ``max_iter`` 0 runs no
    iteration; both as the old loop."""
    matvec, a, b, apply_m, m = _ell(6, torch.float64)
    for rhs, max_iter in ((torch.zeros_like(b), 256), (b, 0)):
        got = cg.preconditioned_conjugate_gradient(
            matvec, a, rhs, apply_m, m, rtol=1e-8, max_iter=max_iter,
            check_every=4)
        _same(got, _old_pcg(matvec, a, rhs, apply_m, m, 1e-8, max_iter, 4))
        assert int(got.iterations) == 0


def test_identity_apply_aliases_r():
    """``identity_apply`` hands back r itself: z aliases r, which the
    second half reads and never writes."""
    matvec, a, b, _, _ = _ell(7, torch.float64)
    got = cg.conjugate_gradient(matvec, a, b, rtol=1e-8, max_iter=256)
    _same(got, _old_pcg(matvec, a, b, cg.identity_apply, None, 1e-8, 256,
                        64))


# -- the counter -----------------------------------------------------------

def test_fused_iterations_count_every_chunk():
    """``check_every`` a chunk, as ``pcg.system_iterations``; a fixed-trip
    solve counts its trips."""
    matvec, a, b, apply_m, m = _ell(8, torch.float64)
    got, counters = _counters(lambda: cg.preconditioned_conjugate_gradient(
        matvec, a, b, apply_m, m, rtol=1e-8, max_iter=256, check_every=4))
    chunks = -(-int(got.iterations) // 4)
    assert counters["pcg.fused_iterations"] == 4 * chunks
    assert counters["pcg.system_iterations"] == 4 * chunks
    _, counters = _counters(lambda: cg.pcg_fixed_trips(
        matvec, a, b, apply_m, m, trips=7))
    assert counters["pcg.fused_iterations"] == 7


def test_fused_iterations_zero_on_the_grad_route_and_batched():
    matvec, a, b, apply_m, m = _ell(9, torch.float64)
    _, counters = _counters(lambda: cg.preconditioned_conjugate_gradient(
        matvec, a, b, apply_m, m.requires_grad_(), rtol=1e-8, max_iter=256,
        check_every=4))
    assert counters["pcg.system_iterations"] > 0
    assert counters.get("pcg.fused_iterations", 0) == 0
    mats = torch.stack([m.detach(), m.detach()])
    _, counters = _counters(
        lambda: cg.batched_preconditioned_conjugate_gradient(
            lambda op, x: torch.stack([op.matvec(v) for v in x]), a,
            torch.stack((b, -b)),
            lambda mm, r: torch.einsum("bij,bj->bi", mm, r), mats,
            rtol=1e-8, max_iter=256, check_every=4))
    assert counters["pcg.system_iterations"] > 0
    assert counters.get("pcg.fused_iterations", 0) == 0


def test_cpu_route_counts_no_launch_and_no_plain_call_on_a_card():
    matvec, a, b, apply_m, m = _ell(10, torch.float32)
    before = _backend.launch_counts()[pcg_iteration.KERNEL]
    plain = _backend.plain_cuda_counts()[pcg_iteration.KERNEL]
    cg.preconditioned_conjugate_gradient(matvec, a, b, apply_m, m)
    assert _backend.launch_counts()[pcg_iteration.KERNEL] == before
    assert _backend.plain_cuda_counts()[pcg_iteration.KERNEL] == plain


# -- the grid and the argument checks ----------------------------------

def test_grid_by_n():
    """One block at or below ``SINGLE_BLOCK_MAX_N``, one a 1024 entries
    above, capped at ``MAX_GRID``: the per-case n, 128^3 and 256^3."""
    assert grid_for(1) == grid_for(1024) == grid_for(16384) == 1
    assert grid_for(16385) == 17
    assert grid_for(128 ** 3) == grid_for(256 ** 3) == 1024
    assert grid_for(32 ** 3) == 32


class _OnCard:
    """A CPU tensor that reports ``cuda:0`` as its device, so the argument
    checks run to their end here."""

    def __init__(self, t):
        self._t = t
        self.device = torch.device("cuda", 0)

    def __getattr__(self, name):
        return getattr(self._t, name)


def _card_state(n=40, dtype=torch.float32, **swap):
    s = PCGState(torch.zeros(n, dtype=dtype))
    parts = {name: getattr(s, name)
             for name in ("x", "r", "p", "vals", "flags", "work")}
    parts.update(swap)
    return types.SimpleNamespace(
        grid=s.grid, **{k: _OnCard(v) for k, v in parts.items()})


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 1000, 16385, 20011])
def test_argument_checks_accept(n, dtype):
    s = _card_state(n, dtype)
    check_pcg_args(s, _OnCard(torch.zeros(n, dtype=dtype)),
                   written=(s.x, s.r))
    check_pcg_args(s, s.r, written=(s.p,))  # identity_apply's z is r


@pytest.mark.parametrize("case, match", [
    ("cpu", "CUDA device"),
    ("float16", "float32 or float64"),
    ("mixed", "share a dtype"),
    ("shape", r"\(n,\) shape"),
    ("two_d", r"\(n,\) shape"),
    ("strided", "contiguous"),
    ("flags", "do not fit"),
    ("grid", "do not fit"),
    ("overlap", "overlaps"),
    ("grad", "no backward"),
])
def test_argument_checks_refuse(case, match):
    s = _card_state()
    v = torch.zeros(40)
    if case == "float16":
        s, v = _card_state(dtype=torch.float16), v.half()
    elif case == "mixed":
        v = v.double()
    elif case == "shape":
        v = torch.zeros(41)
    elif case == "two_d":
        v = torch.zeros(40, 1)
    elif case == "strided":
        v = torch.zeros(80)[::2]
    elif case == "flags":
        s = _card_state(flags=torch.zeros(5, dtype=torch.int64))
    elif case == "grid":
        s.grid = 2
    elif case == "overlap":
        v = s.r._t
    elif case == "grad":
        v = torch.zeros(40, requires_grad=True)
    args = v if case == "cpu" else _OnCard(v)
    with pytest.raises(ValueError, match=match):
        check_pcg_args(s, args, written=(s.x, s.r))


def test_max_iter_must_fit_an_int32():
    with pytest.raises(ValueError, match="int32"):
        pcg_iteration._args(PCGState(torch.zeros(8)), 2 ** 31)


def test_cuda_call_without_library_raises(monkeypatch):
    """A CUDA tensor goes to the kernels or raises: with the library
    unavailable the call fails and the plain version never runs."""
    def unavailable():
        raise RuntimeError("kernel library unavailable")

    def plain_must_not_run(*args):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(_backend, "kernel_library", unavailable)
    monkeypatch.setattr(pcg_iteration, "update_xr_torch", plain_must_not_run)
    monkeypatch.setattr(pcg_iteration, "update_p_torch", plain_must_not_run)
    s, on_card = _card_state(), _OnCard(torch.zeros(40))
    before = _backend.launch_counts()[pcg_iteration.KERNEL]
    with pytest.raises(RuntimeError, match="unavailable"):
        pcg_iteration.update_xr(s, on_card, 1e-8, 8)
    with pytest.raises(RuntimeError, match="unavailable"):
        pcg_iteration.update_p(s, on_card, 8)
    assert _backend.launch_counts()[pcg_iteration.KERNEL] == before


@pytest.mark.parametrize("case, route", [
    ("cpu", "plain"),
    ("card", "cuda"),
    ("card, operand needs a gradient", "plain"),
    ("card, state needs a gradient", "plain"),
    ("card, operand needs a gradient, no_grad", "cuda"),
])
def test_dispatch(monkeypatch, case, route):
    """The plain version takes CPU tensors and the calls autograd has to
    follow; the kernels every other CUDA call, under ``no_grad`` too."""
    taken = []
    for name in ("update_xr_torch", "update_p_torch", "update_xr_cuda",
                 "update_p_cuda"):
        monkeypatch.setattr(pcg_iteration, name,
                            lambda *args, name=name: taken.append(name))
    grad = "operand needs" in case
    v = torch.zeros(40, requires_grad=grad)
    s = _card_state(r=torch.zeros(40, requires_grad="state needs" in case))
    if case == "cpu":
        s = PCGState(torch.zeros(40))
    else:
        v = _OnCard(v)
    with torch.set_grad_enabled("no_grad" not in case):
        pcg_iteration.update_xr(s, v, 1e-8, 8)
        pcg_iteration.update_p(s, v, 8)
    assert taken == [f"update_xr_{route if route == 'cuda' else 'torch'}",
                     f"update_p_{route if route == 'cuda' else 'torch'}"]


# -- the kernels' oracle: a diagonal system, and its tolerance by dtype ----

HALVES_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
HALVES_TRIPS, HALVES_MAX_ITER = 3, 2  # the third trip frozen at max_iter


def _diagonal_start(n, dtype, device, seed=0):
    """PCG's start on a diagonal SPD system, A = diag(a) with a in [1, 10]
    and M = diag(m) with m in [0.5, 1] (so r shrinks slowly, and the
    rounding of alpha is not magnified), b standard normal, drawn in
    float64: (the state, a, m) in ``dtype`` on ``device``."""
    gen = torch.Generator().manual_seed(seed)
    a = 1 + 9 * torch.rand(n, generator=gen, dtype=torch.float64)
    m = 0.5 + 0.5 * torch.rand(n, generator=gen, dtype=torch.float64)
    b = torch.randn(n, generator=gen, dtype=torch.float64)
    a, m, b = (t.to(dtype=dtype, device=device) for t in (a, m, b))
    s = PCGState(b)
    s.start(b, m * b, torch.dot(b, b),
            torch.zeros((), dtype=torch.bool, device=device),
            HALVES_MAX_ITER)
    return s, a, m


def _copy_state(s, device=None, dtype=None):
    t = PCGState(s.x.to(device=device, dtype=dtype))
    for name in ("x", "r", "p", "vals", "flags"):
        getattr(t, name).copy_(getattr(s, name))
    return t


def _trips(s, a, m, update_xr, update_p, rtol=1e-8):
    for _ in range(HALVES_TRIPS):
        update_xr(s, a * s.p, rtol, HALVES_MAX_ITER)
        update_p(s, m * s.r, HALVES_MAX_ITER)


def _hold(got, want, dtype):
    """x, r, p within ``HALVES_RTOL[dtype]`` of ``want``'s (and that times
    its largest entry), the scalars within it, the flags equal."""
    tol = HALVES_RTOL[dtype]
    for name in ("x", "r", "p", "vals"):
        have, ref = getattr(got, name).cpu(), getattr(want, name).cpu()
        torch.testing.assert_close(
            have.to(ref.dtype), ref, rtol=tol,
            atol=0 if name == "vals" else tol * float(ref.abs().max()))
    assert got.flags.tolist() == want.flags.tolist()


def test_diagonal_trips_freeze_at_max_iter():
    """The oracle's run: two iterations taken, the third frozen."""
    s, a, m = _diagonal_start(1000, torch.float64, None)
    _trips(s, a, m, pcg_iteration.update_xr, pcg_iteration.update_p)
    assert s.flags.tolist() == [HALVES_MAX_ITER, 0, 1, 1, 0]
    assert float(s.vals[pcg_iteration.ALPHA]) == 0.0
    assert 0 < float(s.residual) < 1


@pytest.mark.parametrize("planted", ["every op", "the dots"])
def test_float64_tolerance_refuses_float32_arithmetic(monkeypatch, planted):
    """A float64 instance that computed in float32 (every op, or its dots
    alone) fails the float64 tolerance, and passes the float32 one: the
    tolerance by dtype sees the precision."""
    s, a, m = _diagonal_start(20011, torch.float64, None)
    want = _copy_state(s)
    _trips(want, a, m, pcg_iteration.update_xr, pcg_iteration.update_p)
    if planted == "every op":
        got = _copy_state(s, dtype=torch.float32)
        _trips(got, a.float(), m.float(), pcg_iteration.update_xr,
               pcg_iteration.update_p)
    else:
        dot = torch.dot
        monkeypatch.setattr(torch, "dot", lambda u, v: dot(
            u.float(), v.float()).to(u.dtype))
        got = _copy_state(s)
        _trips(got, a, m, pcg_iteration.update_xr, pcg_iteration.update_p)
        monkeypatch.undo()
    _hold(got, want, torch.float32)
    with pytest.raises(AssertionError):
        _hold(got, want, torch.float64)


# -- on the card -----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1000, 16384, 20011, 300007])
def test_cuda_halves_match_plain(cuda_device, n, dtype):
    """Three trips of the kernels' halves on a diagonal system, both
    grids, n a multiple of no block, against the plain halves on the same
    card tensors: x, r, p and the scalars within the dtype's tolerance
    (``_hold``), the flags equal (the third trip frozen at ``max_iter``),
    the ticket back at 0; and a state frozen by ``done`` left as it
    was."""
    s, a, m = _diagonal_start(n, dtype, cuda_device)
    ref = _copy_state(s)
    _trips(s, a, m, pcg_iteration.update_xr, pcg_iteration.update_p)
    _trips(ref, a, m, pcg_iteration.update_xr_torch,
           pcg_iteration.update_p_torch)
    torch.cuda.synchronize()
    _hold(s, ref, dtype)
    assert int(s.flags[pcg_iteration.TICKET]) == 0
    s.flags[pcg_iteration.DONE] = 1
    s.flags[pcg_iteration.K] = 0
    kept = [t.clone() for t in (s.x, s.r, s.p)]
    pcg_iteration.update_xr(s, a * s.p, 1e-8, 100)
    pcg_iteration.update_p(s, m * s.r, 100)
    for before, after in zip(kept, (s.x, s.r, s.p)):
        assert torch.equal(before, after)
    assert s.flags.tolist() == [0, 1, 1, 1, 0]


def _card_systems(device):
    """The per-case (a sludge-like system in n_pad 1024), 128^3-like
    (32^3 structured) and HPCG (12^3) fixtures, float32."""
    yield "per case", _ell(11, torch.float32, device, n=900, n_pad=1024)
    yield "128^3-like", _structured(1, torch.float32, device,
                                    shape=(32, 32, 32))
    yield "hpcg", _structured(0, torch.float32, device, shape=(12, 12, 12),
                              hpcg=True)
    yield "gmg", _multigrid(2, torch.float32, device, shape=(32, 32, 32))


@pytest.mark.cuda
@torch.no_grad()
def test_cuda_iterations_against_the_old_loop(cuda_device):
    """The fused solve (eager: no capture's warm-up iteration enters the
    count) against the old loop on the card: iterations equal or within
    one, both converged; no plain version ran on the card, and the
    kernels launched 2 (n <= 16384) or 4 times an executed iteration."""
    for name, (matvec, a, b, apply_m, m) in _card_systems(cuda_device):
        want = _old_pcg(matvec, a, b, apply_m, m, 1e-8, 1024, 8)
        _backend.reset_launch_counts()
        got = cg.preconditioned_conjugate_gradient(
            lambda op, v: matvec(op, v), a, b, lambda mm, r: apply_m(mm, r),
            m, rtol=1e-8, max_iter=1024, check_every=8)
        assert _backend.plain_cuda_counts()[pcg_iteration.KERNEL] == 0, name
        executed = 8 * -(-int(got.iterations) // 8)
        per = 2 if b.shape[0] <= pcg_iteration.SINGLE_BLOCK_MAX_N else 4
        assert _backend.launch_counts()[pcg_iteration.KERNEL] == (
            per * executed), name
        print(f"{name}: {int(got.iterations)} iterations, the old loop "
              f"{int(want.iterations)}")
        assert abs(int(got.iterations) - int(want.iterations)) <= 1, name
        assert float(got.residual) < 1e-8, name
        true = torch.dot(b - matvec(a, got.x), b - matvec(a, got.x)) / (
            torch.dot(b, b))
        assert float(true) < 1e-6, name


@pytest.mark.cuda
@torch.no_grad()
@pytest.mark.parametrize("n", [1000, 24273])
def test_cuda_deterministic_and_graphed_equal(cuda_device, n):
    """Two eager solves give the same bits (a deterministic reduction), and
    the graphed solve equals them: one block (n 1000) and 24 blocks
    (n 24 273), n a multiple of no block."""
    matvec, a, b, apply_m, m = _ell(12, torch.float32, cuda_device,
                                    n=n - 7, n_pad=n, dense=False)

    def eager():
        return cg.preconditioned_conjugate_gradient(
            lambda op, v: matvec(op, v), a, b, lambda mm, r: apply_m(mm, r),
            m, rtol=1e-8, max_iter=1024, check_every=8)

    first, second = eager(), eager()
    _same(first, second)
    assert float(first.residual) < 1e-8
    cg._graphs.clear()
    try:
        for _ in range(2):
            graphed = cg.preconditioned_conjugate_gradient(
                matvec, a, b, apply_m, m, rtol=1e-8, max_iter=1024,
                check_every=8)
            _same(graphed, first)
        assert len(cg._graphs) == 1
    finally:
        cg._graphs.clear()
    assert grid_for(n) == (1 if n <= 16384 else 24)
