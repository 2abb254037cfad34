"""Frozen input maker of the variable-coefficient Poisson operators.

The arithmetic of the port's ``data/poisson.poisson_coeff_dia``, in
float64 torch on the run's device: -div(kappa grad u) on a uniform grid
with cell coefficients kappa drawn lognormal(0, sigma) (from a
``torch.Generator`` seeded from ``--seed``, so the fields are made on the
card in a few large calls), harmonic-mean face coefficients and
Dirichlet ghosts of the cell's own coefficient, in the DIA layout
``vals[d, i]`` multiplies ``x[i + offsets[d]]`` (offsets ascending).
Rows are padded to a multiple of 1024 as the port's ``pad_rows`` pads
them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class PoissonOperator:
    vals: torch.Tensor  # (bands, n_pad) float64
    offsets: tuple
    n: int
    shape: tuple

    @property
    def n_pad(self) -> int:
        return self.vals.shape[1]


def pad_rows(n: int, mult: int = 1024) -> int:
    return ((n + mult - 1) // mult) * mult


def poisson_coeff_bands(shape, gen: torch.Generator, sigma: float,
                        device) -> PoissonOperator:
    shape = tuple(int(s) for s in shape)
    ndim = len(shape)
    n = int(np.prod(shape))
    n_pad = pad_rows(n)
    kappa = torch.exp(sigma * torch.randn(
        shape, generator=gen, dtype=torch.float64, device=device))
    strides = [int(np.prod(shape[i + 1:])) for i in range(ndim)]
    offsets = sorted({0} | set(strides) | {-s for s in strides})
    vals = torch.zeros(len(offsets), n_pad, dtype=torch.float64,
                       device=device)
    diag = torch.zeros(shape, dtype=torch.float64, device=device)
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
        facef = torch.zeros_like(diag)
        facef[tuple(lo_all)] = face
        vals[offsets.index(strides[ax]), :n] -= facef.reshape(-1)
        faceb = torch.zeros_like(diag)
        faceb[tuple(hi_all)] = face
        vals[offsets.index(-strides[ax]), :n] -= faceb.reshape(-1)
    vals[offsets.index(0), :n] = diag.reshape(-1)
    return PoissonOperator(vals, tuple(offsets), n, shape)


def generate_fields(seed: int, count: int, shape, sigma: float,
                    device) -> list:
    """``count`` operators drawn one after another from the seed's
    stream."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.default_rng([int(seed), 1]).integers(
        2**62)))
    return [poisson_coeff_bands(shape, gen, sigma, device)
            for _ in range(count)]
