"""Variable-coefficient Poisson operators on uniform grids, DIA-native.

Numpy copy of ``deeppreconditioning_tpu/data/poisson.py::poisson_coeff_dia``
(the reference cannot be imported without jax): -div(kappa grad u) with
cell-wise lognormal kappa, harmonic-mean face coefficients and Dirichlet
ghosts of the cell's own coefficient, assembled in float64 on the host
into the DIA layout of ``sparse/dia.py``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

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
