"""Variable-coefficient Poisson operators on uniform grids, DIA-native.

Numpy copy of ``deeppreconditioning_tpu/data/poisson.py`` (the reference
cannot be imported without jax): ``poisson_coeff_dia``, -div(kappa grad u)
with cell-wise lognormal kappa, harmonic-mean face coefficients and
Dirichlet ghosts of the cell's own coefficient, assembled in float64 on
the host into the DIA layout of ``sparse/dia.py``; ``poisson_rhs_sequence``
(the multi-RHS protocol's drifting known solutions) and ``poisson_family``
(seeded operators with known-solution right-hand sides).  Their operator
products run through ``ops.dia_spmv.dia_matvec`` on the operator's device.

``hpcg_operator`` and ``hpcg_rhs`` are the HPCG benchmark's problem
(HPCG 3.1, ``GenerateProblem_ref.cpp``) on one rank's box: the 27-point
stencil with 26 on the diagonal and -1 for each neighbour inside the box,
and b = A 1; the operator is made on its device, with no host array of
its size.
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from deeppreconditioning_tpu_torch.ops.dia_spmv import dia_matvec
from deeppreconditioning_tpu_torch.sparse.dia import DIAMatrix, pad_rows


def poisson_coeff_dia(
    shape: Sequence[int],
    rng: np.random.Generator,
    sigma: float = 1.0,
    dtype=torch.float32,
    device=None,
) -> DIAMatrix:
    """-div(kappa grad) on a uniform grid as DIA, with cell coefficients
    kappa drawn lognormal(0, sigma) from ``rng``.  Face coefficient =
    harmonic mean of the two cell kappas; boundary faces add the cell's
    kappa to the diagonal."""
    shape = tuple(int(s) for s in shape)
    ndim = len(shape)
    n = int(np.prod(shape))
    n_pad = pad_rows(n)
    kappa = np.exp(sigma * rng.standard_normal(n)).reshape(shape)

    strides = [int(np.prod(shape[i + 1:])) for i in range(ndim)]
    offsets = sorted({0} | set(strides) | {-s for s in strides})
    vals = np.zeros((len(offsets), n_pad), np.float64)
    diag = np.zeros(shape, np.float64)
    for ax in range(ndim):
        lo_all = [slice(None)] * ndim
        hi_all = [slice(None)] * ndim
        lo_all[ax] = slice(0, shape[ax] - 1)
        hi_all[ax] = slice(1, shape[ax])
        lo, hi = kappa[tuple(lo_all)], kappa[tuple(hi_all)]
        face = 2.0 * lo * hi / (lo + hi)
        diag[tuple(lo_all)] += face
        diag[tuple(hi_all)] += face
        first = [slice(None)] * ndim
        last = [slice(None)] * ndim
        first[ax] = 0
        last[ax] = shape[ax] - 1
        diag[tuple(first)] += kappa[tuple(first)]
        diag[tuple(last)] += kappa[tuple(last)]
        pos = offsets.index(strides[ax])
        neg = offsets.index(-strides[ax])
        facef = np.zeros(shape, np.float64)
        facef[tuple(lo_all)] = face  # face between i and i + stride
        vals[pos, :n] += -facef.reshape(-1)
        faceb = np.zeros(shape, np.float64)
        faceb[tuple(hi_all)] = face
        # += (not =): axes with colliding strides (a size-1 grid dim)
        # share a band
        vals[neg, :n] += -faceb.reshape(-1)

    vals[offsets.index(0), :n] = diag.reshape(-1)
    return DIAMatrix(
        vals=torch.tensor(vals, dtype=dtype, device=device),
        offsets=tuple(offsets), n=n,
    )


def _product(a: DIAMatrix, x: np.ndarray) -> np.ndarray:
    """A x on the operator's device and in its dtype, back on the host."""
    xt = torch.as_tensor(x, device=a.vals.device).to(a.vals.dtype)
    with torch.no_grad():
        return dia_matvec(a, xt).cpu().numpy()


def poisson_rhs_sequence(
    a: DIAMatrix,
    k: int,
    rng: Optional[np.random.Generator] = None,
    step: float = 0.1,
) -> Tuple[np.ndarray, np.ndarray]:
    """Evolving-rhs sequence over one operator (the multi-RHS protocol):
    x*_0 standard normal on the n rows (float32), x*_{t+1} = x*_t + step *
    noise, b_t = A x*_t.  Returns (b_seq (k, n_pad), x_seq (k, n_pad))."""
    rng = rng or np.random.default_rng(0)
    n, n_pad = a.n, a.n_pad
    x = np.zeros(n_pad, np.float32)
    x[:n] = rng.standard_normal(n)
    xs, bs = [], []
    for _ in range(k):
        xs.append(x.copy())
        bs.append(_product(a, x))
        nxt = x.copy()
        nxt[:n] = x[:n] + step * rng.standard_normal(n).astype(np.float32)
        x = nxt
    return np.stack(bs), np.stack(xs)


def poisson_family(
    count: int,
    shape: Sequence[int],
    seed: int = 0,
    sigma: float = 1.0,
    dtype=torch.float32,
    device=None,
) -> Tuple[list, list]:
    """A seeded family of coefficient-field operators and right-hand
    sides b = A x* (x* standard normal on the n rows: known solution)."""
    rng = np.random.default_rng(seed)
    mats, rhss = [], []
    for _ in range(count):
        a = poisson_coeff_dia(shape, rng=rng, sigma=sigma, dtype=dtype,
                              device=device)
        x_star = rng.standard_normal(a.n_pad)
        x_star[a.n:] = 0.0
        mats.append(a)
        rhss.append(_product(a, x_star))
    return mats, rhss


def hpcg_operator(shape: Sequence[int], dtype=torch.float32,
                  device=None) -> DIAMatrix:
    """HPCG's matrix on an nx x ny x nz box as DIA, its 27 bands sorted by
    offset: 26 on the diagonal, -1 for each of the up to 26 neighbours
    (every cell within one step along each axis), neighbours outside the
    box dropped (a one-rank HPCG run: no halo)."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != 3:
        raise ValueError(f"HPCG's box is 3-D, not {shape}")
    n = int(np.prod(shape))
    n_pad = pad_rows(n)
    strides = [int(np.prod(shape[i + 1:])) for i in range(3)]
    steps = sorted(itertools.product((-1, 0, 1), repeat=3),
                   key=lambda d: int(np.dot(d, strides)))
    idx = torch.arange(n_pad, device=device)
    coords, rem = [], idx
    for stride in strides:
        coords.append(rem // stride)
        rem = rem - coords[-1] * stride
    vals = torch.zeros((len(steps), n_pad), dtype=dtype, device=device)
    for k, d in enumerate(steps):
        inside = idx < n
        for ax, step in enumerate(d):
            c = coords[ax] + step
            inside &= (c >= 0) & (c < shape[ax])
        vals[k] = inside * (26.0 if not any(d) else -1.0)
    return DIAMatrix(vals=vals,
                     offsets=tuple(int(np.dot(d, strides)) for d in steps),
                     n=n)


def hpcg_rhs(a: DIAMatrix) -> torch.Tensor:
    """HPCG's right-hand side b = A 1 (the exact solution is all ones on
    the n rows), zero on the padding, on the operator's device."""
    ones = torch.zeros(a.n_pad, dtype=a.vals.dtype, device=a.vals.device)
    ones[:a.n] = 1.0
    with torch.no_grad():
        return dia_matvec(a, ones)
