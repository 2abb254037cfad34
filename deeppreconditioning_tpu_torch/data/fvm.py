"""Finite-volume pressure-Poisson generators (2-D and 3-D castellated).

A numpy copy of ``deeppreconditioning_tpu/data/fvm.py`` (its 2-D
assembly, the 3-D castellated / permuted family, ``save_case`` and
``generate_dataset``): the JAX package's ``data/__init__`` imports jax,
so the port cannot import even its host code.  The random streams are
the same ``np.random.Generator`` calls in the same order, so a seed
builds the same cases; ``tests/test_torch_fvm.py`` holds the copy equal
to the original.

The 2-D assembly routes as the reference's does: through the host
runtime's ``fvm_assemble`` (``native``) whenever ``native_assembly()`` is
true, which it is whenever the runtime builds and loads, else through
the numpy assembly here.  The two agree to ~1e-14 relative, which the
ground-truth CG amplifies to ~1e-10.  ``native_assembly`` plays the role
of the reference's ``native.available`` for this one step: a caller that
holds counts made on the numpy route (the tests' fixtures were made with
the reference's native library switched off) replaces it with
``lambda: False``, as the reference's fixture scripts replace
``native.available``, or uses ``numpy_assembly()``.
"""

from __future__ import annotations

import contextlib
import hashlib
import zipfile
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg  # noqa: F401  (sp.linalg.cg / eigsh)
from scipy.ndimage import label

from deeppreconditioning_tpu_torch import native

RHO_WATER = 1000.0
RHO_SLUDGE = 1400.0
DT = 1e-3


@dataclass
class FVMCase:
    """One generated linear system A x = b with ground truth."""

    matrix: sp.coo_matrix  # SPD pressure-correction matrix
    rhs: np.ndarray
    solution: np.ndarray  # CG ground truth (atol 1e-6)
    shape_2d: tuple  # (ny, nx) grid used


def _sludge_height(nx: int, rng: np.random.Generator) -> np.ndarray:
    """Random smooth sludge-bed height profile in [0.1, 0.5] of depth."""
    n_modes = 4
    x = np.linspace(0, 2 * np.pi, nx)
    h = np.zeros(nx)
    for k in range(1, n_modes + 1):
        h += rng.normal() / k * np.sin(k * x + rng.uniform(0, 2 * np.pi))
    h = (h - h.min()) / max(h.max() - h.min(), 1e-12)  # -> [0, 1]
    return 0.1 + 0.4 * h


def native_assembly() -> bool:
    """Whether ``assemble_pressure_poisson`` takes the host runtime's
    ``fvm_assemble``: whenever the runtime builds and loads (the
    reference's ``native.available()`` route)."""
    return native.available()


@contextlib.contextmanager
def numpy_assembly():
    """Pin the 2-D assembly to its numpy route inside the block (the
    route the fixtures' counts were made on)."""
    global native_assembly
    saved = native_assembly
    native_assembly = lambda: False  # noqa: E731
    try:
        yield
    finally:
        native_assembly = saved


def assemble_pressure_poisson(
    ny: int,
    nx: int,
    rho: np.ndarray,
    dx: float = 1.0,
    dy: float = 1.0,
) -> sp.coo_matrix:
    """SPD (negated) FVM Laplacian with harmonic face diffusivity
    ``dt / rho`` on an (ny, nx) grid; the fixed-value top boundary adds
    its face coefficient to the diagonal.  Native when
    ``native_assembly()``, else numpy."""
    n = ny * nx
    if native_assembly():
        rows_n, cols_n, vals_n, _ = native.fvm_assemble(
            ny, nx, rho, dx, dy, DT, True)
        a = sp.coo_matrix((vals_n, (rows_n, cols_n)), shape=(n, n))
        a.sum_duplicates()
        return a.tocoo()
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


def _validate_spd(a: sp.coo_matrix) -> None:
    """Exact symmetry, positive diagonal, and diagonal dominance (or a
    Lanczos check of the smallest eigenvalue when not dominant)."""
    asym = abs(a - a.T)
    if not (asym.nnz == 0 or asym.max() < 1e-10):
        raise ValueError("matrix not symmetric")
    d = a.diagonal()
    if not (d > 0).all():
        raise ValueError("non-positive diagonal")
    offdiag_abs = np.asarray(abs(a).sum(axis=1)).ravel() - np.abs(d)
    if not (d >= offdiag_abs - 1e-12).all():
        lam_min = sp.linalg.eigsh(a.tocsc(), k=1, which="SA",
                                  return_eigenvectors=False)[0]
        if not lam_min > 0:
            raise ValueError("matrix not positive definite")


def generate_sludge_case(
    rng: np.random.Generator,
    mesh_cells: int = 2,
) -> FVMCase:
    """One sludge-pattern pressure-correction system (see the JAX
    package's ``generate_sludge_case``; same draws, same order)."""
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
    a = assemble_pressure_poisson(ny, nx, rho, dx, dy)
    _validate_spd(a)

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
    b = b - b.mean()  # compatible rhs
    b = b * (1.0 / max(np.abs(b).max(), 1e-30))

    x, info = sp.linalg.cg(a.tocsr(), b, atol=1e-6, rtol=0.0, maxiter=20000)
    if info != 0:
        raise RuntimeError(f"ground-truth CG did not converge (info={info})")

    return FVMCase(matrix=a, rhs=b, solution=x, shape_2d=(ny, nx))


def _sludge_height_2d(ny: int, nx: int,
                      rng: np.random.Generator) -> np.ndarray:
    """Random smooth bed-height field h(y, x) in [0.1, 0.5] of depth."""
    n_modes = 3
    yy = np.linspace(0, 2 * np.pi, ny)[:, None]
    xx = np.linspace(0, 2 * np.pi, nx)[None, :]
    h = np.zeros((ny, nx))
    for k in range(1, n_modes + 1):
        h += rng.normal() / k * np.sin(
            k * xx + rng.uniform(0, 2 * np.pi)
        ) * np.cos(k * yy + rng.uniform(0, 2 * np.pi))
    h = (h - h.min()) / max(h.max() - h.min(), 1e-12)
    return 0.1 + 0.4 * h


def generate_sludge_case_3d(
    rng: np.random.Generator,
    mesh_cells: int = 2,
    castellated: bool = True,
    permute: bool = False,
    dims: tuple | None = None,
    max_cells: int = 2000,
    solve: bool = True,
) -> FVMCase:
    """3-D two-phase pressure-Poisson case on a castellated hex mesh (see
    the JAX package's ``generate_sludge_case_3d``; same draws, same
    order): a 7-point stencil on the cells left after random box voids
    are carved out, the largest connected component kept and renumbered;
    ``permute`` shuffles the numbering (A -> P A P^T); ``solve=False``
    skips the ground-truth CG (operator benchmarks)."""
    if dims is None:
        base = 5 * mesh_cells
        dims = [max(int(base * rng.uniform(0.85, 1.15)), 5)
                for _ in range(3)]
    nz, ny, nx = dims
    while nx * ny * nz > max_cells:
        nz, ny, nx = nz - 1, ny - 1, nx - 1
    shape = (nz, ny, nx)

    active = np.ones(shape, bool)
    if castellated:
        n_voids = rng.integers(1, 4)
        for _ in range(n_voids):
            sz = [max(int(d * rng.uniform(0.15, 0.4)), 1) for d in shape]
            lo = [int(rng.integers(0, d - s + 1)) for d, s in zip(shape, sz)]
            active[lo[0]:lo[0] + sz[0], lo[1]:lo[1] + sz[1],
                   lo[2]:lo[2] + sz[2]] = False
        if not active.any():
            active[...] = True

    lab, n_comp = label(active)  # carving can split the tank
    if n_comp > 1:
        sizes = np.bincount(lab.ravel())[1:]
        active = lab == (1 + int(np.argmax(sizes)))

    n = int(active.sum())
    idx3 = np.full(shape, -1, np.int64)
    idx3[active] = np.arange(n)

    h = _sludge_height_2d(ny, nx, rng)  # z measured upward
    zc = (np.arange(nz)[:, None, None] + 0.5) / nz
    rho = np.where(zc < h[None, :, :], RHO_SLUDGE, RHO_WATER)
    rho = (
        6.0 * rho
        + np.roll(rho, 1, 0) + np.roll(rho, -1, 0)
        + np.roll(rho, 1, 1) + np.roll(rho, -1, 1)
        + np.roll(rho, 1, 2) + np.roll(rho, -1, 2)
    ) / 12.0
    rau = DT / rho

    d = 1.0 / max(nx, ny, nz)
    dx = dy = dz = d
    areas = (dy * dz / dx, dx * dz / dy, dx * dy / dz)

    rows, cols, vals = [], [], []
    diag = np.zeros(n)

    def faces(axis, area_over_dist):
        sl_p = [slice(None)] * 3
        sl_n = [slice(None)] * 3
        sl_p[axis] = slice(None, -1)
        sl_n[axis] = slice(1, None)
        p3, n3 = idx3[tuple(sl_p)], idx3[tuple(sl_n)]
        mask = (p3 >= 0) & (n3 >= 0)
        p, q = p3[mask], n3[mask]
        rp, rq = rau[tuple(sl_p)][mask], rau[tuple(sl_n)][mask]
        c = 2.0 * rp * rq / (rp + rq) * area_over_dist
        rows.extend([p, q])
        cols.extend([q, p])
        vals.extend([-c, -c])
        np.add.at(diag, p, c)
        np.add.at(diag, q, c)

    faces(2, areas[0])  # x faces
    faces(1, areas[1])  # y faces
    faces(0, areas[2])  # z faces

    top = idx3[-1][active[-1]]  # fixed-value boundary on the top plane
    if top.size:
        diag[top] += rau[-1][active[-1]] * dx * dy / (dz / 2.0)
    else:  # fully castellated top: pin the reference cell
        diag[0] += 1.0

    rows.append(np.arange(n))
    cols.append(np.arange(n))
    vals.append(diag)
    a = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n),
    )
    a.sum_duplicates()
    a = a.tocoo()
    _validate_spd(a)

    src = rng.normal(size=shape)  # smoothed source on the active cells
    for _ in range(6):
        src = (
            2.0 * src
            + np.roll(src, 1, 0) + np.roll(src, -1, 0)
            + np.roll(src, 1, 1) + np.roll(src, -1, 1)
            + np.roll(src, 1, 2) + np.roll(src, -1, 2)
        ) / 8.0
    b = src[active]
    b = b - b.mean()
    b = b * (1.0 / max(np.abs(b).max(), 1e-30))

    if permute:
        perm = rng.permutation(n)
        a = a.tocsr()[perm][:, perm].tocoo()
        b = b[perm]

    if solve:
        x, info = sp.linalg.cg(a.tocsr(), b, atol=1e-6, rtol=0.0,
                               maxiter=20000)
        if info != 0:
            raise RuntimeError(
                f"ground-truth CG did not converge (info={info})")
    else:
        x = np.zeros_like(b)
    return FVMCase(matrix=a, rhs=b, solution=x, shape_2d=shape)


def save_case(case: FVMCase, folder: Path) -> None:
    """Write a case in the reference's on-disk layout: ``matrix.npz``
    (scipy COO), ``right_hand_side.csv`` and ``solution.csv``."""
    folder.mkdir(parents=True, exist_ok=True)
    sp.save_npz(folder / "matrix.npz", case.matrix, compressed=False)
    np.savetxt(folder / "right_hand_side.csv", case.rhs)
    np.savetxt(folder / "solution.csv", case.solution)


def case_digests(folder: Path) -> dict[str, str]:
    """sha256 of what a case folder holds: each text file, and each member
    of ``matrix.npz`` by name (``matrix.npz/row.npy`` ...), in archive
    order.  The archive's own bytes carry its write time in the zip
    headers, so two writes of one case differ there and nowhere else."""
    folder = Path(folder)
    out = {}
    with zipfile.ZipFile(folder / "matrix.npz") as archive:
        for member in archive.namelist():
            out[f"matrix.npz/{member}"] = hashlib.sha256(
                archive.read(member)).hexdigest()
    for name in ("right_hand_side.csv", "solution.csv"):
        out[name] = hashlib.sha256((folder / name).read_bytes()).hexdigest()
    return out


def generate_dataset(
    root: Path,
    number_samples: int = 500,
    mesh_cells: int = 2,
    seed: int = 69420,
) -> None:
    """The sludge-pattern data set: ``number_samples`` cases from
    ``seed`` at ``mesh_cells``, written as ``root/case_0000`` ... in the
    reference's layout (the reference's ``generate_dataset``; its
    defaults are params.yaml's sample count and the generate stage's
    seed)."""
    rng = np.random.default_rng(seed)
    for i in range(number_samples):
        case = generate_sludge_case(rng, mesh_cells=mesh_cells)
        save_case(case, Path(root) / f"case_{i:04d}")
