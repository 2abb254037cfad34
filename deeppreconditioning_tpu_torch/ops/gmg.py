"""Geometric multigrid on structured DIA operators.

Counterpart of ``deeppreconditioning_tpu/ops/gmg.py``.  Coarsening is 2x
per axis with piecewise-constant aggregates, so restriction is a
reshape-sum and prolongation a broadcast; the Galerkin coarse operator
P^T A P of a 7-point DIA operator is again a 7-point DIA operator whose
bands are reshape-sums of the fine bands; smoothing is damped Jacobi or
the structured-FSAI factor S = C C^T (classical or the learned head).
One symmetric V(1,1)-cycle is the PCG preconditioner.  Every operator
and smoother application is a DIA matvec (kernel B2 on the card, on every
level).

``gmg_apply`` is declared ``capture_safe``, so on the card the single-system
PCG replays its cycles inside the solver's CUDA graphs (``solvers/cg.py``;
the hierarchy's levels are walked and copied in per solve by
``utils/graphs.py``).  It declares the products with the system's operator
one cycle makes (``operator_products``: the two fine-level residuals),
which the solver counts.

On the card ``build_gmg`` of a damped-Jacobi hierarchy replays its
Galerkin levels and the root's dense assembly from two CUDA graphs, keyed
on the fine operator's walk (``utils/graphs.py``) and the grid, captured on
a key's second call (``SETUP_GRAPHS``; the first runs eagerly, as do the
CPU, a caller under grad and an FSAI-smoothed hierarchy); the root's
inverse runs eagerly after them, and the levels are fresh copies of the
graphs' outputs, so a hierarchy outlives the next setup.  A replay runs the
eager path's kernels in its order, so it gives the same bits.  Under a
``torch.profiler`` ``build_gmg`` records the span ``gmg.setup`` with the
children ``gmg.galerkin`` (the levels' inverse diagonals and coarse
operators) and ``gmg.root`` (the root's dense assembly and inverse).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deeppreconditioning_tpu_torch.ops.dia_spmv import dia_matvec
from deeppreconditioning_tpu_torch.ops.structured_fsai import (
    bands_to_dia,
    build_structured_plan,
    structured_setup,
)
from deeppreconditioning_tpu_torch.sparse.dia import DIAMatrix, pad_rows
from deeppreconditioning_tpu_torch.utils import graphs
from deeppreconditioning_tpu_torch.utils.graphs import capture_safe
from deeppreconditioning_tpu_torch.utils.tracing import span

OMEGA = 0.7  # damped-Jacobi weight
MIN_SIDE = 8  # coarsen while every side is even and >= 2 * MIN_SIDE


def _axis_offsets(shape: Sequence[int]) -> Tuple[int, ...]:
    """Positive linear offsets of the 7-point stencil, x-major order."""
    return tuple(int(np.prod(shape[ax + 1:])) for ax in range(len(shape)))


@dataclass
class GMGLevel:
    """One level: its DIA operator and smoother data (``c_up`` /
    ``c_low`` are None for damped Jacobi, else the structured-FSAI
    factor as (C^T, C) DIA operators)."""

    a: DIAMatrix
    inv_diag: torch.Tensor
    c_up: Optional[DIAMatrix]
    c_low: Optional[DIAMatrix]
    shape: Tuple[int, ...]
    omega: float


@dataclass
class GMGPreconditioner:
    levels: Tuple[GMGLevel, ...]
    coarse_inv: torch.Tensor  # (nc, nc) dense root inverse
    coarse_shape: Tuple[int, ...]


def inverse_diagonal(a: DIAMatrix) -> torch.Tensor:
    """1 / diag(A), 0 where the diagonal is 0 (the Jacobi preconditioner
    and smoother)."""
    d = a.vals[a.offsets.index(0)]
    return torch.where(d == 0, torch.zeros_like(d),
                       1.0 / torch.where(d == 0, torch.ones_like(d), d))


def _grid_view(x: torch.Tensor, shape) -> torch.Tensor:
    return x[:int(np.prod(shape))].reshape(shape)


def _restrict_grid(g: torch.Tensor, shape) -> torch.Tensor:
    """Aggregate-sum a fine grid onto the coarse grid (every axis
    halved): one reshape and one sum."""
    split = []
    for s in shape:
        split += [s // 2, 2]
    return g.reshape(split).sum(dim=tuple(range(1, 2 * len(shape), 2)))


def galerkin_coarse_dia(a: DIAMatrix, shape) -> DIAMatrix:
    """P^T A P for 2x-per-axis piecewise-constant aggregates, DIA in and
    out.  An axis band value coupling i -> i + e_ax stays inside one
    aggregate iff i's coordinate along ax is even: those values fold
    (twice, once per triangle) into the coarse diagonal, the odd ones
    sum into the coarse band.  The negative coarse bands mirror the
    positive ones.  Every grid side must be even."""
    shape = tuple(int(s) for s in shape)
    nd = len(shape)
    if any(s % 2 for s in shape):
        raise ValueError(f"every side must be even, got {shape}")
    cshape = tuple(s // 2 for s in shape)
    nc = int(np.prod(cshape))
    n_pad_c = pad_rows(nc)
    offs = _axis_offsets(shape)
    offs_c = _axis_offsets(cshape)
    pos = {offs[ax]: ax for ax in range(nd)}
    dtype, dev = a.vals.dtype, a.vals.device

    diag_c = torch.zeros(cshape, dtype=dtype, device=dev)
    bands_c = {}
    for d, off in enumerate(a.offsets):
        g = _grid_view(a.vals[d], shape)
        if off == 0:
            diag_c = diag_c + _restrict_grid(g, shape)
        elif off in pos:
            ax = pos[off]
            par = (torch.arange(shape[ax], device=dev) % 2).to(dtype)
            par = par.reshape([shape[ax] if i == ax else 1
                               for i in range(nd)])
            intra = _restrict_grid(g * (1.0 - par), shape)
            inter = _restrict_grid(g * par, shape)
            diag_c = diag_c + 2.0 * intra
            bands_c[offs_c[ax]] = inter

    vals = []
    for ax in range(nd):
        oc = offs_c[ax]
        band = bands_c.get(oc, torch.zeros(cshape, dtype=dtype, device=dev))
        band = F.pad(band.reshape(-1), (0, n_pad_c - nc))
        vals.append((oc, band))
        # A[i, i - oc] = A[i - oc, i] = positive band at i - oc
        vals.append((-oc, F.pad(band[:n_pad_c - oc], (oc, 0))))
    vals.append((0, F.pad(diag_c.reshape(-1), (0, n_pad_c - nc))))
    vals.sort(key=lambda t: t[0])
    return DIAMatrix(vals=torch.stack([v for _, v in vals]),
                     offsets=tuple(o for o, _ in vals), n=nc)


def restrict_pc(r: torch.Tensor, shape) -> torch.Tensor:
    """P^T r: aggregate sums, fine (n_pad,) -> coarse (n_pad_c,)."""
    shape = tuple(int(s) for s in shape)
    nc = int(np.prod(shape)) // 2 ** len(shape)
    rc = _restrict_grid(_grid_view(r, shape), shape)
    return F.pad(rc.reshape(-1), (0, pad_rows(nc) - nc))


def prolong_pc(xc: torch.Tensor, shape) -> torch.Tensor:
    """P xc: each aggregate value broadcast to its 2^nd fine cells."""
    shape = tuple(int(s) for s in shape)
    nd = len(shape)
    cshape = tuple(s // 2 for s in shape)
    n = int(np.prod(shape))
    g = _grid_view(xc, cshape)
    split = []
    for s in cshape:
        split += [s, 1]
    expanded = []
    for s in cshape:
        expanded += [s, 2]
    g = g.reshape(split).expand(expanded).reshape(n)
    return F.pad(g, (0, pad_rows(n) - n))


def _dia_to_dense_static(a: DIAMatrix) -> torch.Tensor:
    """(n, n) dense from DIA, one diagonal placement per band."""
    nc = a.n
    out = torch.zeros((nc, nc), dtype=a.vals.dtype, device=a.vals.device)
    for d, off in enumerate(a.offsets):
        band = a.vals[d, :nc - off] if off >= 0 else a.vals[d, -off:nc]
        out = out + torch.diag(band, off)
    return out


def level_shapes(shape: Sequence[int]) -> tuple:
    """(the smoothed levels' shapes, the root's): levels are taken while
    every side is even and >= 2 * ``MIN_SIDE``."""
    s, lvl_shapes = tuple(int(d) for d in shape), []
    while all(d % 2 == 0 and d >= 2 * MIN_SIDE for d in s):
        lvl_shapes.append(s)
        s = tuple(d // 2 for d in s)
    return tuple(lvl_shapes), s


def _galerkin_levels(a: DIAMatrix, lvl_shapes) -> tuple:
    """(each level's inverse diagonal, each coarse operator: the next
    level's, the last the root's)."""
    inv_diags, coarse = [], []
    lvl_a = a
    for lvl_shape in lvl_shapes:
        inv_diags.append(inverse_diagonal(lvl_a))
        lvl_a = galerkin_coarse_dia(lvl_a, lvl_shape)
        coarse.append(lvl_a)
    return inv_diags, coarse


def _symmetric_inverse(root: torch.Tensor) -> torch.Tensor:
    inv = torch.linalg.inv(root)
    return 0.5 * (inv + inv.T)


def build_gmg(
    a: DIAMatrix,
    shape: Sequence[int],
    model=None,
    plan_power: int = 2,
    fsai_levels: int = 0,
) -> GMGPreconditioner:
    """GMG setup from the fine DIA operator.

    Levels are taken while every side is even and >= 2 * ``MIN_SIDE``.
    The first ``fsai_levels`` levels are smoothed by the structured-FSAI
    factor on the pattern of power ``plan_power`` (classical if ``model``
    is None, else the NeuralFSAI head), scaled by sqrt(min(1, 1.9 /
    lambda)) in each half with lambda from 8 power steps of C C^T A (the
    smoother safeguard); the others by damped Jacobi (``OMEGA``).  The
    root is inverted densely and symmetrised, 0.5 (inv + inv^T).  A
    damped-Jacobi hierarchy on the card is replayed from CUDA graphs (see
    the module docstring).
    """
    lvl_shapes, root_shape = level_shapes(shape)
    dev = a.vals.device
    with span("gmg.setup", dev):
        graph = None
        if fsai_levels == 0:
            key, leaves = graphs.walk(a)
            if graphs.eager_because(leaves) is None:
                graph = SETUP_GRAPHS.lookup((key, lvl_shapes), lambda: (
                    _SetupGraph(leaves, a, lvl_shapes)))
        if graph is not None:
            inv_diags, coarse, coarse_inv = graph.run(leaves)
        else:
            with span("gmg.galerkin", dev):
                inv_diags, coarse = _galerkin_levels(a, lvl_shapes)
            with span("gmg.root", dev):
                coarse_inv = _symmetric_inverse(_dia_to_dense_static(
                    coarse[-1] if coarse else a))
        levels = []
        for lvl_idx, (lvl_shape, lvl_a, inv_diag) in enumerate(
                zip(lvl_shapes, (a, *coarse), inv_diags)):
            c_up = c_low = None
            if lvl_idx < fsai_levels:
                plan = build_structured_plan(lvl_shape, power=plan_power)
                bands, _ = structured_setup(lvl_a, plan, model)
                c_up, c_low = bands_to_dia(bands, plan.offsets, lvl_a.n)
                scale = _smoother_scale(lvl_a, c_up, c_low)
                c_up = replace(c_up, vals=c_up.vals * torch.sqrt(scale))
                c_low = replace(c_low, vals=c_low.vals * torch.sqrt(scale))
            levels.append(GMGLevel(a=lvl_a, inv_diag=inv_diag, c_up=c_up,
                                   c_low=c_low, shape=lvl_shape,
                                   omega=OMEGA))
    return GMGPreconditioner(levels=tuple(levels), coarse_inv=coarse_inv,
                             coarse_shape=root_shape)


class _SetupGraph(graphs.GraphEntry):
    """One key's static fine operator and its two graphs: the Galerkin
    levels, and the root's dense assembly (see the module docstring)."""

    def __init__(self, leaves, a: DIAMatrix, lvl_shapes) -> None:
        super().__init__(a, a.vals.device)
        self.lvl_shapes = lvl_shapes
        self.load(leaves)
        _, self.graphs = graphs.capture_graphs(self.device, self._warm,
                                               self._galerkin, self._root)

    def _galerkin(self) -> None:
        self.inv_diags, self.coarse = _galerkin_levels(self.operands,
                                                       self.lvl_shapes)

    def _root(self) -> None:
        self.root = _dia_to_dense_static(
            self.coarse[-1] if self.coarse else self.operands)

    def _warm(self) -> None:
        self._galerkin()
        self._root()

    def run(self, leaves) -> tuple:
        """(fresh inverse diagonals, fresh coarse operators, the root's
        symmetric inverse) of the fine operator's tensors ``leaves``."""
        galerkin, root = self.graphs
        dev = self.device
        self.load(leaves)
        with span("gmg.galerkin", dev):
            galerkin.replay()
        with span("gmg.root", dev):
            root.replay()
            coarse_inv = _symmetric_inverse(self.root)
        return ([d.clone() for d in self.inv_diags],
                [replace(c, vals=c.vals.clone()) for c in self.coarse],
                coarse_inv)


# (fine operator's key, level shapes) -> _SetupGraph, captured on the
# key's second call
SETUP_GRAPHS = graphs.GraphCache(capture_on=2)


def _smoother_scale(a: DIAMatrix, c_up: DIAMatrix,
                    c_low: DIAMatrix) -> torch.Tensor:
    """min(1, 1.9 / lambda) with lambda the growth of 8 power steps of
    S A = C C^T A from the start cos(0.7 i) on the live rows: the
    smoothing iteration I - S A is stable iff lambda_max(S A) < 2."""
    dtype, dev = a.vals.dtype, a.vals.device
    idx = torch.arange(a.n_pad, device=dev)
    v = torch.cos(idx.to(dtype) * 0.7) * (idx < a.n)
    lam = torch.zeros((), dtype=dtype, device=dev)
    for _ in range(8):
        w = dia_matvec(c_low, dia_matvec(c_up, dia_matvec(a, v)))
        w_norm = torch.sqrt(w @ w)
        lam = w_norm / torch.clamp(torch.sqrt(v @ v), min=1e-30)
        v = w / torch.clamp(w_norm, min=1e-30)
    return torch.clamp(1.9 / torch.clamp(lam, min=1e-30), max=1.0)


def _smooth(lev: GMGLevel, r: torch.Tensor) -> torch.Tensor:
    if lev.c_up is None:
        return lev.omega * lev.inv_diag * r
    return dia_matvec(lev.c_low, dia_matvec(lev.c_up, r))


@capture_safe
def gmg_apply(m: GMGPreconditioner, r: torch.Tensor) -> torch.Tensor:
    """One symmetric V(1,1)-cycle: z ~= A^-1 r (the PCG apply).  It
    launches on the current stream and reads nothing on the host, so the
    solver may replay it from a CUDA graph."""

    def cycle(lvl: int, r: torch.Tensor) -> torch.Tensor:
        if lvl == len(m.levels):
            nc = m.coarse_inv.shape[0]
            return F.pad(m.coarse_inv @ r[:nc], (0, r.shape[0] - nc))
        lev = m.levels[lvl]
        x = _smooth(lev, r)
        res = r - dia_matvec(lev.a, x)
        xc = cycle(lvl + 1, restrict_pc(res, lev.shape))
        x = x + prolong_pc(xc, lev.shape)
        return x + _smooth(lev, r - dia_matvec(lev.a, x))

    return cycle(0, r)


gmg_apply.operator_products = 2  # the fine level's two residuals a cycle
