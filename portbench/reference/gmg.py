"""Plain reference of the V(1,1) damped-Jacobi multigrid, in float64 torch.

The hierarchy of ``deeppreconditioning_tpu/ops/gmg.py`` (``gmg_jacobi``):
levels are taken while every side of the grid is even and at least 16;
each level's cells pair into 2 x 2 x 2 aggregates (piecewise-constant
prolongation P, restriction P^T); the next level's operator is the
Galerkin product P^T A P; the grid left over (the root) is inverted
densely and symmetrised, 0.5 (inv + inv^T).  One symmetric V(1,1) cycle
is the PCG preconditioner: on each level one damped-Jacobi sweep
(omega 0.7 times the inverse diagonal, 0 where the diagonal is 0) before
the coarse correction and one after it, the root solved by its inverse.

Departures from the JAX package's module, each on purpose:

* The Galerkin operator is formed by its own route: every fine entry
  A_ij of the 7-point operator inside the grid is scatter-added into its
  aggregates' pair (I, J), and the coarse bands are read from the pairs
  (``galerkin``), where the JAX package (and the port) fold the fine bands
  by the parity of each cell's coordinate.  A pair outside the coarse
  7-point stencil raises.
* Restriction is an ``index_add_`` over the map from a cell to its
  aggregate, prolongation a gather through it, where the JAX package
  reshapes and sums.
* Everything is float64, the root inverted by ``torch.linalg.inv`` in
  float64; the JAX package computes in the operator's dtype.
* Only the damped-Jacobi smoother: no level is smoothed by an FSAI
  factor (the package's ``fsai_levels`` is 0).
* TF32 is off for the dense products (``hpcg.no_tf32``), though in
  float64 none would take it.
* ``precision="bf16"`` rounds every stored result to bfloat16 (the
  operator, each coarse operator, each inverse diagonal, the root
  inverse and every vector of the cycle): the control
  (``neural_fsai.rounder``).

Operators are DIA as the port's: ``vals[d, i]`` multiplies ``x[i +
offsets[d]]``, offsets ascending, rows padded to a multiple of 1024.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from portbench.inputs.poisson import pad_rows
from portbench.reference.hpcg import no_tf32
from portbench.reference.neural_fsai import rounder
from portbench.reference.pcg import pcg

OMEGA = 0.7
MIN_COARSE_SIDE = 8  # a level is taken while every side is >= 2 x this


def strides(shape) -> list:
    return [int(np.prod(shape[ax + 1:])) for ax in range(len(shape))]


def level_shapes(shape) -> tuple:
    """(the shapes of the smoothed levels, the root's shape)."""
    shape, levels = tuple(int(s) for s in shape), []
    while all(s % 2 == 0 and s >= 2 * MIN_COARSE_SIDE for s in shape):
        levels.append(shape)
        shape = tuple(s // 2 for s in shape)
    return levels, shape


def _coords(shape, device) -> list:
    idx = torch.arange(int(np.prod(shape)), device=device)
    out = []
    for stride, side in zip(strides(shape), shape):
        out.append((idx // stride) % side)
    return out


def aggregates(shape, device) -> torch.Tensor:
    """(n,) the coarse index of each fine cell's 2 x 2 x 2 aggregate."""
    cshape = tuple(s // 2 for s in shape)
    agg = torch.zeros(int(np.prod(shape)), dtype=torch.int64, device=device)
    for c, stride in zip(_coords(shape, device), strides(cshape)):
        agg += (c // 2) * stride
    return agg


def entries(vals: torch.Tensor, offsets, shape) -> tuple:
    """(rows, cols, values) of the 7-point operator's couplings inside the
    grid: the diagonal, and each band's entries whose neighbour one step
    along the band's axis lies in the grid."""
    n = int(np.prod(shape))
    dev = vals.device
    coords = _coords(shape, dev)
    rows_all = torch.arange(n, device=dev)
    axis_of = {s: ax for ax, s in enumerate(strides(shape))}
    rows, cols, values = [], [], []
    for d, off in enumerate(offsets):
        if off == 0:
            keep = torch.ones(n, dtype=torch.bool, device=dev)
        elif abs(off) in axis_of:
            step = 1 if off > 0 else -1
            c = coords[axis_of[abs(off)]] + step
            keep = (c >= 0) & (c < shape[axis_of[abs(off)]])
        else:
            raise ValueError(f"offset {off} is no 7-point step of {shape}")
        r = rows_all[keep]
        rows.append(r)
        cols.append(r + off)
        values.append(vals[d, :n][keep])
    return torch.cat(rows), torch.cat(cols), torch.cat(values)


def galerkin(vals: torch.Tensor, offsets, shape, rnd=lambda t: t):
    """(coarse bands, coarse offsets) of P^T A P: each fine entry added
    into its aggregates' pair, the pairs read as coarse bands."""
    cshape = tuple(s // 2 for s in shape)
    nc = int(np.prod(cshape))
    agg = aggregates(shape, vals.device)
    rows, cols, values = entries(vals, offsets, shape)
    big_i, big_j = agg[rows], agg[cols]
    delta = big_j - big_i
    offsets_c = sorted({0} | {s for s in strides(cshape)}
                       | {-s for s in strides(cshape)})
    found = set(torch.unique(delta).tolist())
    if not found <= set(offsets_c):
        raise ValueError(f"coarse couplings {sorted(found)} leave the "
                         "7-point stencil")
    out = torch.zeros(len(offsets_c), pad_rows(nc), dtype=torch.float64,
                      device=vals.device)
    for d, oc in enumerate(offsets_c):
        hit = delta == oc
        out[d].index_add_(0, big_i[hit], values[hit])
    return rnd(out), tuple(offsets_c)


def inverse_diagonal(vals: torch.Tensor, offsets) -> torch.Tensor:
    d = vals[list(offsets).index(0)]
    return torch.where(d == 0, 0.0, 1.0 / torch.where(d == 0, 1.0, d))


def dense(vals: torch.Tensor, offsets, n: int) -> torch.Tensor:
    """The (n, n) matrix of the bands: A[i, i + o] = vals[o's band, i]."""
    out = torch.zeros(n, n, dtype=torch.float64, device=vals.device)
    rows = torch.arange(n, device=vals.device)
    for d, off in enumerate(offsets):
        keep = (rows + off >= 0) & (rows + off < n)
        out[rows[keep], rows[keep] + off] = vals[d, :n][keep]
    return out


def matvec(vals: torch.Tensor, offsets, x: torch.Tensor) -> torch.Tensor:
    """y = A x with zero-extended reads."""
    halo = max(abs(o) for o in offsets)
    xe = torch.nn.functional.pad(x, (halo, halo))
    n_pad = x.shape[0]
    y = torch.zeros_like(x)
    for d, off in enumerate(offsets):
        y = y + vals[d] * xe[halo + off:halo + off + n_pad]
    return y


@dataclass
class Level:
    vals: torch.Tensor  # (7, n_pad) float64
    offsets: tuple
    shape: tuple
    inv_diag: torch.Tensor
    agg: torch.Tensor  # (n,) a cell's coarse aggregate


@dataclass
class Hierarchy:
    levels: list
    root_inv: torch.Tensor  # (nc, nc)
    root_shape: tuple

    @property
    def coarse(self) -> list:
        """The coarse operators' bands below the finest level."""
        return [lev.vals for lev in self.levels[1:]]


def build(vals: torch.Tensor, offsets, shape,
          precision: str | None = None) -> Hierarchy:
    """The hierarchy of the fine operator ``vals`` (made float64 here)."""
    rnd = rounder(precision)
    shapes, root_shape = level_shapes(shape)
    lvl_vals, lvl_offsets = rnd(vals.to(torch.float64)), tuple(offsets)
    levels = []
    for lvl_shape in shapes:
        levels.append(Level(lvl_vals, lvl_offsets, lvl_shape,
                            rnd(inverse_diagonal(lvl_vals, lvl_offsets)),
                            aggregates(lvl_shape, vals.device)))
        lvl_vals, lvl_offsets = galerkin(lvl_vals, lvl_offsets, lvl_shape,
                                         rnd)
    nc = int(np.prod(root_shape))
    with no_tf32():
        inv = torch.linalg.inv(dense(lvl_vals, lvl_offsets, nc))
    return Hierarchy(levels, rnd(0.5 * (inv + inv.T)), root_shape)


def cycle(h: Hierarchy, r: torch.Tensor, precision: str | None = None,
          lvl: int = 0) -> torch.Tensor:
    """One V(1,1) cycle from level ``lvl``: z ~= A^-1 r."""
    rnd = rounder(precision)
    if lvl == len(h.levels):
        nc = h.root_inv.shape[0]
        z = torch.zeros_like(r)
        with no_tf32():
            z[:nc] = h.root_inv @ r[:nc]
        return rnd(z)
    lev = h.levels[lvl]
    n = lev.agg.shape[0]

    def smooth(v):
        return rnd(OMEGA * lev.inv_diag * v)

    def residual(x):
        return rnd(r - matvec(lev.vals, lev.offsets, x))

    x = smooth(r)
    res = residual(x)
    n_pad_c = (h.levels[lvl + 1].vals.shape[1] if lvl + 1 < len(h.levels)
               else pad_rows(h.root_inv.shape[0]))
    rc = torch.zeros(n_pad_c, dtype=r.dtype, device=r.device)
    rc.index_add_(0, lev.agg, res[:n])
    xc = cycle(h, rnd(rc), precision, lvl + 1)
    up = torch.zeros_like(r)
    up[:n] = xc[lev.agg]
    x = rnd(x + up)
    return rnd(x + smooth(residual(x)))


def solve(h: Hierarchy, matvec, b: torch.Tensor, rtol: float,
          max_iter: int, precision: str | None = None) -> tuple:
    """(x, iterations): ``reference/pcg.py``'s PCG of ``b`` with one cycle
    of ``h`` an apply.  The apply is made at the start and once in each
    iteration, so the iterations are its calls less one."""
    calls = []

    def apply_m(r):
        calls.append(None)
        return cycle(h, r, precision)

    x = pcg(matvec, apply_m, b.double(), rtol, max_iter, rounder(precision))
    return x, len(calls) - 1
