"""Aggregation algebraic multigrid: host hierarchy, V(1,1)-cycle on the card.

Counterpart of ``deeppreconditioning_tpu/ops/amg.py``.  The setup is host
numpy (copies of the reference's): strength-of-connection edges,
parallel-greedy aggregation, the Jacobi-smoothed prolongation
P = (I - omega D^-1 A) P0, weak-entry filtering of each Galerkin product
P^T A P, recursively until the coarse operator has at most
``coarse_target`` rows, then the dense inverse of that root.  The apply is
one symmetric V(1,1)-cycle over the levels: damped-Jacobi pre- and
post-smoothing, restriction and prolongation as rectangular ELL matvecs
(or a segment sum and a gather for piecewise-constant transfers), the
root solve one dense matvec.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from deeppreconditioning_tpu_torch.sparse.ell import (
    ELLMatrix,
    csr_to_ell_arrays,
)


@dataclass
class _RectELL:
    """Rectangular ELL (rows_pad x m_pad) for the grid transfers; the
    sentinel column is m_pad, so the gather reads a zero extension."""

    cols: torch.Tensor  # (rows_pad, k) int64
    vals: torch.Tensor  # (rows_pad, k)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        x_ext = torch.cat([x, x.new_zeros(1)])
        return (self.vals * x_ext[self.cols]).sum(dim=1)

    @staticmethod
    def from_scipy(mat, rows_pad: int, m_pad: int, dtype=torch.float32,
                   device=None) -> "_RectELL":
        cols, vals = csr_to_ell_arrays(sp.csr_matrix(mat), rows_pad,
                                       sentinel=m_pad)
        return _RectELL(
            cols=torch.as_tensor(cols.astype(np.int64), device=device),
            vals=torch.as_tensor(vals, device=device).to(dtype),
        )


@dataclass
class AMGLevel:
    """One V-cycle level: its operator, the inverse diagonal (0 on
    padding), the aggregate id per node (nc_pad on padding) and the
    smoothed transfers (None for piecewise-constant ones)."""

    ell: ELLMatrix
    inv_diag: torch.Tensor
    agg: torch.Tensor
    p_ell: Optional[_RectELL]
    pt_ell: Optional[_RectELL]
    nc_pad: int
    omega: float


@dataclass
class AMGPreconditioner:
    """The levels (fine to coarse) and the dense symmetric root
    inverse."""

    levels: tuple
    coarse_inv: torch.Tensor

    @property
    def nc_pad(self) -> int:
        return self.coarse_inv.shape[0]


def _strength_edges(csr: sp.csr_matrix, theta: float):
    """Strong off-diagonal edges (i, j, |v|): |a_ij|^2 >= theta^2
    |a_ii a_jj|."""
    coo = csr.tocoo()
    d = csr.diagonal()
    i, j, v = coo.row, coo.col, coo.data
    strong = (i != j) & (v * v >= theta * theta * np.abs(d[i] * d[j]))
    return i[strong], j[strong], np.abs(v[strong])


def _aggregate(a: sp.spmatrix, theta: float = 0.08):
    """Parallel-greedy strength-based aggregation: rounds of seeds that
    are priority-local maxima among unaggregated strong neighbours absorb
    their strong neighbourhood; leftovers join their strongest
    aggregated neighbour; isolated nodes become singletons.  Returns
    (agg (n,) int64 aggregate ids, nc)."""
    csr = a.tocsr()
    n = csr.shape[0]
    ei, ej, ev = _strength_edges(csr, theta)
    agg = np.full(n, -1, np.int64)
    # scattered deterministic priorities (Knuth multiplicative hash)
    prio = (np.arange(n, dtype=np.uint64) * np.uint64(2654435761)
            % np.uint64(2 ** 31)).astype(np.int64)
    prio = prio * n + np.arange(n)
    nc = 0
    for _ in range(64):
        unagg = agg < 0
        if not unagg.any():
            break
        has_agg_nb = np.zeros(n, bool)
        np.logical_or.at(has_agg_nb, ei, ~unagg[ej])
        pr = np.where(unagg, prio, np.int64(-1))
        nbmax = np.full(n, -1, np.int64)
        both = unagg[ei] & unagg[ej]
        np.maximum.at(nbmax, ei[both], pr[ej[both]])
        seeds = unagg & ~has_agg_nb & (pr > nbmax)
        if not seeds.any():
            break
        ids = np.cumsum(seeds) - 1 + nc
        agg[seeds] = ids[seeds]
        nc += int(seeds.sum())
        join = np.full(n, -1, np.int64)
        sel = unagg[ei] & seeds[ej]
        np.maximum.at(join, ei[sel], agg[ej[sel]])
        take = (agg < 0) & (join >= 0)
        agg[take] = join[take]
    for _ in range(8):
        unagg = agg < 0
        sel = unagg[ei] & (agg[ej] >= 0)
        if not sel.any():
            break
        ii, jj, vv = ei[sel], ej[sel], ev[sel]
        order = np.lexsort((vv, ii))
        ii_s = order[np.r_[ii[order][1:] != ii[order][:-1], True]]
        agg[ii[ii_s]] = agg[jj[ii_s]]
    unagg = agg < 0
    k = int(unagg.sum())
    if k:
        agg[unagg] = nc + np.arange(k)
        nc += k
    return agg, nc


def _prolongation(csr: sp.csr_matrix, agg: np.ndarray, nc: int,
                  smooth_omega: Optional[float]) -> sp.csr_matrix:
    """P0 (piecewise constant) or the Jacobi-smoothed P."""
    n = csr.shape[0]
    p0 = sp.coo_matrix((np.ones(n), (np.arange(n), agg)),
                       shape=(n, nc)).tocsr()
    if smooth_omega is None:
        return p0
    da = sp.diags(1.0 / csr.diagonal()) @ csr
    return (p0 - smooth_omega * (da @ p0)).tocsr()


def _pad8(x: int) -> int:
    return ((x + 7) // 8) * 8


def _filter_weak(a_c: sp.csr_matrix, eps: float) -> sp.csr_matrix:
    """Drop |a_ij| < eps sqrt(a_ii a_jj) off the diagonal, lumping the
    dropped entries into the diagonal."""
    coo = a_c.tocoo()
    d = np.sqrt(np.abs(a_c.diagonal()))
    i, j, v = coo.row, coo.col, coo.data
    weak = (i != j) & (np.abs(v) < eps * d[i] * d[j])
    keep = ~weak
    lump = np.zeros(a_c.shape[0])
    np.add.at(lump, i[weak], v[weak])
    out = sp.csr_matrix(
        (np.concatenate([v[keep], lump]),
         (np.concatenate([i[keep], np.arange(a_c.shape[0])]),
          np.concatenate([j[keep], np.arange(a_c.shape[0])]))),
        shape=a_c.shape,
    )
    out.sum_duplicates()
    return out


def build_amg(
    a: sp.spmatrix,
    n_pad: Optional[int] = None,
    omega: float = 0.67,
    theta: float = 0.08,
    theta_coarse: float = 0.0,
    filter_eps: float = 1e-3,
    dtype=torch.float32,
    coarse_target: int = 512,
    max_levels: int = 16,
    smooth_prolongation: bool = True,
    device=None,
    timings: Optional[dict] = None,
) -> AMGPreconditioner:
    """The hierarchy of a scipy SPD matrix (host build, tensors on
    ``device``): aggregate at least once, then until the coarse operator
    has at most ``coarse_target`` rows (or ``max_levels``, or coarsening
    stalls), and invert that root densely (symmetrized).  ``timings``, if
    given, gathers the host seconds of the aggregation (``aggregate``),
    the prolongations and Galerkin products (``galerkin``), the ELL
    conversions and copies to ``device`` (``transfer``) and the root
    inverse (``coarse``)."""
    clock = {"t": time.perf_counter()}

    def lap(part):
        now = time.perf_counter()
        if timings is not None:
            timings[part] = timings.get(part, 0.0) + now - clock["t"]
        clock["t"] = now

    csr = sp.csr_matrix(a, dtype=np.float64)
    n = csr.shape[0]
    if n_pad is None:
        n_pad = _pad8(n)

    def t(x):
        return torch.as_tensor(x, device=device)

    levels = []
    lvl_csr, lvl_pad = csr, n_pad
    lap("galerkin")  # the float64 copy of A
    while len(levels) < max_levels - 1 and (
            not levels or lvl_csr.shape[0] > coarse_target):
        nf = lvl_csr.shape[0]
        agg, nc = _aggregate(lvl_csr, theta if not levels else theta_coarse)
        lap("aggregate")
        if nc >= nf:  # coarsening stalled
            break
        p = _prolongation(lvl_csr, agg, nc,
                          omega if smooth_prolongation else None)
        a_c = (p.T @ lvl_csr @ p).tocsr()
        if filter_eps:
            a_c = _filter_weak(a_c, filter_eps)
        lap("galerkin")
        nc_pad = _pad8(nc)
        agg_pad = np.full(lvl_pad, nc_pad, np.int64)
        agg_pad[:nf] = agg
        inv_diag = np.zeros(lvl_pad)
        inv_diag[:nf] = 1.0 / lvl_csr.diagonal()
        if smooth_prolongation:
            p_ell = _RectELL.from_scipy(p, lvl_pad, nc_pad, dtype, device)
            pt_ell = _RectELL.from_scipy(p.T.tocsr(), nc_pad, lvl_pad,
                                         dtype, device)
        else:
            p_ell = pt_ell = None
        levels.append(AMGLevel(
            ell=ELLMatrix.from_scipy(lvl_csr, n_pad=lvl_pad, dtype=dtype,
                                     device=device),
            inv_diag=t(inv_diag).to(dtype),
            agg=t(agg_pad),
            p_ell=p_ell,
            pt_ell=pt_ell,
            nc_pad=nc_pad,
            omega=omega,
        ))
        lvl_csr, lvl_pad = a_c, nc_pad
        lap("transfer")

    nc = lvl_csr.shape[0]
    coarse_inv = np.zeros((lvl_pad, lvl_pad))
    inv = np.linalg.inv(lvl_csr.toarray())
    coarse_inv[:nc, :nc] = 0.5 * (inv + inv.T)
    out = AMGPreconditioner(levels=tuple(levels),
                            coarse_inv=t(coarse_inv).to(dtype))
    lap("coarse")
    return out


def _restrict(m: AMGLevel, res: torch.Tensor) -> torch.Tensor:
    if m.pt_ell is not None:
        return m.pt_ell.matvec(res)
    out = res.new_zeros(m.nc_pad + 1)
    return out.index_add_(0, m.agg, res)[:-1]


def _prolong(m: AMGLevel, yc: torch.Tensor) -> torch.Tensor:
    if m.p_ell is not None:
        return m.p_ell.matvec(yc)
    return torch.cat([yc, yc.new_zeros(1)])[m.agg]


def amg_apply(m: AMGPreconditioner, r: torch.Tensor) -> torch.Tensor:
    """One symmetric V(1,1)-cycle: z ~ A^-1 r."""

    def cycle(lvl: int, r: torch.Tensor) -> torch.Tensor:
        if lvl == len(m.levels):
            return m.coarse_inv @ r
        lev = m.levels[lvl]
        x = lev.omega * lev.inv_diag * r  # pre-smooth
        res = r - lev.ell.matvec(x)
        x = x + _prolong(lev, cycle(lvl + 1, _restrict(lev, res)))
        return x + lev.omega * lev.inv_diag * (r - lev.ell.matvec(x))

    return cycle(0, r)
