"""The port's geometric multigrid (``ops/gmg.py``, the damped-Jacobi
V(1,1) cycle) against the benchmark's plain float64 reference
(``portbench/reference/gmg.py``: Galerkin operators by scatter-add, the
root inverted in float64), on seeded lognormal 7-point fields at 16^3
(one smoothed level and the 8^3 root) and 32^3 (two levels), on the CPU.

In float64 the port and the reference differ by the order of their sums
alone: the coarse levels, the root inverse and one cycle agree to 1e-12
of their largest entry, and the PCG takes the same iterations.  In
float32 (the benchmark's precision) the tolerances follow from the unit
roundoff u = 2^-24: a coarse entry is a sum of at most 12 entries of the
level above (the diagonal's 8 and the folded couplings), each rounded to
float32 once and once per addition, so a level's largest entry error is
under 32 u of its largest entry at these depths; the root's inverse, and
the cycle it dominates, may amplify the operator's rounding by the root's
condition number kappa, so they are held to 16 kappa u; and rounding moves
the PCG's residual curve, falling about tenfold an iteration here, across
rtol by at most one iteration.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from deeppreconditioning_tpu_torch.data.poisson import poisson_coeff_dia
from deeppreconditioning_tpu_torch.ops import gmg
from deeppreconditioning_tpu_torch.ops.dia_spmv import dia_matvec
from deeppreconditioning_tpu_torch.solvers.cg import (
    preconditioned_conjugate_gradient,
)
from deeppreconditioning_tpu_torch.sparse.dia import DIAMatrix
from portbench.reference import gmg as ref
from portbench.reference.pcg import squared_residual

U32 = 2.0 ** -24
CASES = [(16, 0), (16, 2), (32, 1)]  # (side, seed)


def _gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want).abs().max() / want.abs().max())


def _case(side: int, seed: int, dtype):
    """(the port's operator in ``dtype``, its float64 bands, shape, the
    reference's hierarchy, the port's, a seeded vector on the live
    rows)."""
    shape = (side, side, side)
    a64 = poisson_coeff_dia(shape, rng=np.random.default_rng(seed),
                            sigma=1.0, dtype=torch.float64)
    a = DIAMatrix(vals=a64.vals.to(dtype), offsets=a64.offsets, n=a64.n)
    with torch.no_grad():
        m = gmg.build_gmg(a, shape)
    h = ref.build(a64.vals, a64.offsets, shape)
    r = torch.randn(a.n_pad, generator=torch.Generator().manual_seed(seed),
                    dtype=torch.float64)
    r[a.n:] = 0.0
    return a, a64, shape, h, m, r


def _root_condition(h: ref.Hierarchy) -> float:
    last = h.levels[-1]
    vals, offsets = ref.galerkin(last.vals, last.offsets, last.shape)
    nc = int(np.prod(h.root_shape))
    return float(torch.linalg.cond(ref.dense(vals, offsets, nc)))


def _iterations(a, a64, m, h, r, dtype) -> tuple:
    """(the port's PCG iterations on b = r with hierarchy ``m``, the
    reference's with ``h``)."""
    got = preconditioned_conjugate_gradient(
        dia_matvec, a, r.to(dtype), gmg.gmg_apply, m, rtol=1e-8,
        max_iter=1024, check_every=8)
    _, want = ref.solve(h, lambda v: ref.matvec(a64.vals, a64.offsets, v),
                        r, 1e-8, 1024)
    return int(got.iterations), want


@pytest.mark.parametrize("side,seed", CASES)
def test_hierarchy_matches_reference_float64(side, seed):
    a, a64, shape, h, m, r = _case(side, seed, torch.float64)
    shapes, root = ref.level_shapes(shape)
    assert [lev.shape for lev in m.levels] == shapes
    assert m.coarse_shape == root == (8, 8, 8)
    assert len(m.levels[1:]) == len(h.coarse) == len(shapes) - 1
    for lev, want in zip(m.levels[1:], h.levels[1:]):
        assert lev.a.offsets == want.offsets
        n = lev.a.n
        assert _gap(lev.a.vals[:, :n], want.vals[:, :n]) < 1e-12
    for lev, want in zip(m.levels, h.levels):
        assert _gap(lev.inv_diag, want.inv_diag) < 1e-12
    assert _gap(m.coarse_inv, h.root_inv) < 1e-12
    assert _gap(gmg.gmg_apply(m, r), ref.cycle(h, r)) < 1e-12


@pytest.mark.parametrize("side,seed", CASES)
def test_pcg_iterations_match_reference_float64(side, seed):
    a, a64, _, h, m, r = _case(side, seed, torch.float64)
    got, want = _iterations(a, a64, m, h, r, torch.float64)
    assert got == want and 0 < got < 30


@pytest.mark.parametrize("side,seed", CASES)
def test_float32_within_its_rounding(side, seed):
    a, a64, _, h, m, r = _case(side, seed, torch.float32)
    kappa = _root_condition(h)
    for lev, want in zip(m.levels[1:], h.coarse):
        n = lev.a.n
        assert _gap(lev.a.vals[:, :n], want[:, :n]) < 32 * U32
    assert _gap(m.coarse_inv, h.root_inv) < 16 * kappa * U32
    assert _gap(gmg.gmg_apply(m, r.float()), ref.cycle(h, r)) < (
        16 * kappa * U32)
    got, want = _iterations(a, a64, m, h, r, torch.float32)
    assert abs(got - want) <= 1


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_stale_coarse_levels_cost_iterations(dtype):
    """A solve whose coarse levels and root are another field's, below its
    own finest level (what a replay holding stale level tensors computes),
    still converges, but in at least two iterations more than the
    reference's: the iteration count, held to the reference's within
    one, sees it where the hierarchy and its cycle compare clean."""
    a, a64, _, h, m, r = _case(32, 1, dtype)
    with torch.no_grad():
        other = gmg.build_gmg(_case(32, 2, dtype)[0], (32, 32, 32))
    stale = replace(other, levels=(m.levels[0],) + other.levels[1:])
    got, want = _iterations(a, a64, stale, h, r, dtype)
    assert got - want >= 2
    fresh, _ = _iterations(a, a64, m, h, r, dtype)
    assert abs(fresh - want) <= 1


def test_reference_solve_counts_its_iterations():
    """``ref.solve``'s count is the iterations its PCG ran: it meets rtol
    there, and not one iteration earlier."""
    a, a64, _, h, _, r = _case(16, 0, torch.float64)

    def a_mv(v):
        return ref.matvec(a64.vals, a64.offsets, v)

    x, iters = ref.solve(h, a_mv, r, 1e-8, 1024)
    assert 0 < iters < 30
    assert float(squared_residual(a_mv, x, r)) < 1e-8
    x_short, short = ref.solve(h, a_mv, r, 1e-8, iters - 1)
    assert short == iters - 1
    assert float(squared_residual(a_mv, x_short, r)) >= 1e-8


def test_reference_galerkin_is_the_dense_product():
    """The reference's coarse bands are P^T A P of the dense matrices, on
    a grid whose sides differ."""
    shape = (8, 6, 4)
    a64 = poisson_coeff_dia(shape, rng=np.random.default_rng(5),
                            dtype=torch.float64)
    n = a64.n
    dense = ref.dense(a64.vals, a64.offsets, n)
    agg = ref.aggregates(shape, "cpu")
    p = torch.zeros(n, int(agg.max()) + 1, dtype=torch.float64)
    p[torch.arange(n), agg] = 1.0
    vals, offsets = ref.galerkin(a64.vals, a64.offsets, shape)
    nc = p.shape[1]
    assert torch.allclose(ref.dense(vals, offsets, nc), p.T @ dense @ p,
                          rtol=0, atol=1e-12 * float(dense.abs().max()))
