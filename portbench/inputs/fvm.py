"""Frozen input maker of the 2-D sludge-tank cases (numpy only).

A copy of the port's ``data/fvm.generate_sludge_case`` on its numpy
assembly route, with the same ``np.random.Generator`` draws in the same
order, so a generator state builds the same matrix and right-hand side.
Two parts are left out because no benchmark input depends on them: the
ground-truth CG solve (the benchmark judges a solve by its residual) and
the Lanczos check that only runs on a matrix that is not diagonally
dominant (every sludge matrix is).  The check that remains still refuses
a matrix that is not symmetric or has a nonpositive diagonal.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp

RHO_WATER = 1000.0
RHO_SLUDGE = 1400.0
DT = 1e-3


@dataclass
class SludgeCase:
    """One raw SPD system A x = b: A as COO triplets (float64, both
    triangles, duplicates summed) and b."""

    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    rhs: np.ndarray
    shape_2d: tuple

    @property
    def n(self) -> int:
        return self.rhs.shape[0]

    def csr(self) -> sp.csr_matrix:
        return sp.csr_matrix((self.vals, (self.rows, self.cols)),
                             shape=(self.n, self.n))


def _sludge_height(nx: int, rng: np.random.Generator) -> np.ndarray:
    n_modes = 4
    x = np.linspace(0, 2 * np.pi, nx)
    h = np.zeros(nx)
    for k in range(1, n_modes + 1):
        h += rng.normal() / k * np.sin(k * x + rng.uniform(0, 2 * np.pi))
    h = (h - h.min()) / max(h.max() - h.min(), 1e-12)
    return 0.1 + 0.4 * h


def _assemble(ny: int, nx: int, rho: np.ndarray, dx: float,
              dy: float) -> sp.coo_matrix:
    """SPD (negated) FVM Laplacian with harmonic face diffusivity dt/rho;
    the fixed-value top boundary adds its face coefficient to the
    diagonal."""
    n = ny * nx
    idx = np.arange(n).reshape(ny, nx)
    rau = DT / rho
    rows, cols, vals = [], [], []
    diag = np.zeros(n)

    def add_faces(p_idx, n_idx, rau_p, rau_n, area_over_dist):
        rau_f = 2.0 * rau_p * rau_n / (rau_p + rau_n)
        c = rau_f * area_over_dist
        rows.append(p_idx.ravel())
        cols.append(n_idx.ravel())
        vals.append(-c.ravel())
        rows.append(n_idx.ravel())
        cols.append(p_idx.ravel())
        vals.append(-c.ravel())
        np.add.at(diag, p_idx.ravel(), c.ravel())
        np.add.at(diag, n_idx.ravel(), c.ravel())

    add_faces(idx[:, :-1], idx[:, 1:], rau[:, :-1], rau[:, 1:], dy / dx)
    add_faces(idx[:-1, :], idx[1:, :], rau[:-1, :], rau[1:, :], dx / dy)
    diag[idx[-1, :]] += rau[-1, :] * dx / (dy / 2.0)
    rows.append(np.arange(n))
    cols.append(np.arange(n))
    vals.append(diag)
    a = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n),
    )
    a.sum_duplicates()
    return a.tocoo()


def _check(a: sp.coo_matrix) -> None:
    asym = abs(a - a.T)
    if not (asym.nnz == 0 or asym.max() < 1e-10):
        raise ValueError("matrix not symmetric")
    if not (a.diagonal() > 0).all():
        raise ValueError("non-positive diagonal")


def generate_sludge_case(rng: np.random.Generator,
                         mesh_cells: int = 2) -> SludgeCase:
    """One sludge-pattern pressure-correction system."""
    base = 14 * mesh_cells
    nx = int(base * rng.uniform(0.85, 1.15))
    ny = int(base * rng.uniform(0.85, 1.15))
    nx, ny = max(nx, 8), max(ny, 8)
    while nx * ny > 2000:
        nx -= 1
        ny -= 1

    h = _sludge_height(nx, rng)
    ycoord = (np.arange(ny)[:, None] + 0.5) / ny
    sludge = ycoord < h[None, :]
    rho = np.where(sludge, RHO_SLUDGE, RHO_WATER)
    rho = (
        4.0 * rho
        + np.roll(rho, 1, 0) + np.roll(rho, -1, 0)
        + np.roll(rho, 1, 1) + np.roll(rho, -1, 1)
    ) / 8.0

    dx = dy = 1.0 / max(nx, ny)
    a = _assemble(ny, nx, rho, dx, dy)
    _check(a)

    psi = rng.normal(size=(ny + 2, nx + 2))
    for _ in range(8):
        psi = 0.25 * (
            np.roll(psi, 1, 0) + np.roll(psi, -1, 0)
            + np.roll(psi, 1, 1) + np.roll(psi, -1, 1)
        )
    u = (psi[1:-1, 2:] - psi[1:-1, :-2]) / (2 * dx)
    v = (psi[2:, 1:-1] - psi[:-2, 1:-1]) / (2 * dy)
    div = (
        (np.roll(u, -1, 1) - np.roll(u, 1, 1)) / (2 * dx)
        + (np.roll(v, -1, 0) - np.roll(v, 1, 0)) / (2 * dy)
    )
    b = (div * dx * dy * DT).ravel()
    b = b - b.mean()
    b = b * (1.0 / max(np.abs(b).max(), 1e-30))
    return SludgeCase(a.row.astype(np.int64), a.col.astype(np.int64),
                      a.data.astype(np.float64), b, (ny, nx))


def generate_cases(seed: int, count: int, mesh_cells: int) -> list:
    """``count`` cases drawn one after another from the seed's stream."""
    rng = np.random.default_rng([int(seed), 1])
    return [generate_sludge_case(rng, mesh_cells) for _ in range(count)]
