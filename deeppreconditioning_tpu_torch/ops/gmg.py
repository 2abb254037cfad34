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
    root is inverted densely and symmetrised, 0.5 (inv + inv^T).
    """
    shape = tuple(int(s) for s in shape)
    lvl_shapes = []
    s = shape
    while all(d % 2 == 0 and d >= 2 * MIN_SIDE for d in s):
        lvl_shapes.append(s)
        s = tuple(d // 2 for d in s)

    levels = []
    lvl_a = a
    for lvl_idx, lvl_shape in enumerate(lvl_shapes):
        c_up = c_low = None
        if lvl_idx < fsai_levels:
            plan = build_structured_plan(lvl_shape, power=plan_power)
            bands, _ = structured_setup(lvl_a, plan, model)
            c_up, c_low = bands_to_dia(bands, plan.offsets, lvl_a.n)
            scale = _smoother_scale(lvl_a, c_up, c_low)
            c_up = replace(c_up, vals=c_up.vals * torch.sqrt(scale))
            c_low = replace(c_low, vals=c_low.vals * torch.sqrt(scale))
        levels.append(GMGLevel(a=lvl_a, inv_diag=inverse_diagonal(lvl_a),
                               c_up=c_up, c_low=c_low, shape=lvl_shape,
                               omega=OMEGA))
        lvl_a = galerkin_coarse_dia(lvl_a, lvl_shape)

    inv = torch.linalg.inv(_dia_to_dense_static(lvl_a))
    return GMGPreconditioner(levels=tuple(levels),
                             coarse_inv=0.5 * (inv + inv.T),
                             coarse_shape=s)


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


def gmg_apply(m: GMGPreconditioner, r: torch.Tensor) -> torch.Tensor:
    """One symmetric V(1,1)-cycle: z ~= A^-1 r (the PCG apply)."""

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
