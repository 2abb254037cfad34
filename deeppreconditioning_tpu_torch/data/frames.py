"""Synthetic 3-D frame-structure stiffness systems (the StAn-like family).

A numpy copy of ``deeppreconditioning_tpu/data/frames.py``: random
multi-story grids of axis-aligned Euler-Bernoulli beams with randomized
sections, 6 dof per node (3 translations, 3 rotations), assembled into
the global stiffness K and made SPD by grounding the base layer.  The
random draws are the same ``np.random.Generator`` calls in the same
order, so a seed builds the same case; ``tests/test_torch_frames.py``
holds the copy equal to the original.

One change: the base nodes are grounded by selecting rows, then columns
(``k_full[keep][:, keep]``).  The reference's ``k_full[np.ix_(keep,
keep)]`` selects the same entries, but at ``dims=(30, 30, 20)`` (102 600
dof, the SpMV roofline's frame operator) it runs the host out of memory.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg  # noqa: F401  (sp.linalg.cg)

from deeppreconditioning_tpu_torch.data.fvm import FVMCase


def beam_stiffness_local(length: float, ea: float, gj: float, eiy: float,
                         eiz: float) -> np.ndarray:
    """12x12 local stiffness of a 3-D Euler-Bernoulli beam along +x; dof
    order per node (ux, uy, uz, rx, ry, rz)."""
    le = length
    k = np.zeros((12, 12))
    ka = ea / le  # axial (ux1, ux2)
    k[np.ix_([0, 6], [0, 6])] += ka * np.array([[1, -1], [-1, 1]])
    kt = gj / le  # torsion (rx1, rx2)
    k[np.ix_([3, 9], [3, 9])] += kt * np.array([[1, -1], [-1, 1]])
    c = eiz / le**3  # bending about z (uy, rz)
    kb = c * np.array([
        [12, 6 * le, -12, 6 * le],
        [6 * le, 4 * le**2, -6 * le, 2 * le**2],
        [-12, -6 * le, 12, -6 * le],
        [6 * le, 2 * le**2, -6 * le, 4 * le**2],
    ])
    k[np.ix_([1, 5, 7, 11], [1, 5, 7, 11])] += kb
    c = eiy / le**3  # bending about y (uz, ry): the rotation rows flip sign
    kb = c * np.array([
        [12, -6 * le, -12, -6 * le],
        [-6 * le, 4 * le**2, 6 * le, 2 * le**2],
        [-12, 6 * le, 12, 6 * le],
        [-6 * le, 2 * le**2, 6 * le, 4 * le**2],
    ])
    k[np.ix_([2, 4, 8, 10], [2, 4, 8, 10])] += kb
    return k


def _rotation_for_axis(axis: int) -> np.ndarray:
    """3x3 signed permutation mapping the local +x beam axis onto global
    axis 0 (x), 1 (y) or 2 (z), right-handed."""
    if axis == 0:
        return np.eye(3)
    if axis == 1:  # local x -> global y, y -> z, z -> x
        return np.array([[0.0, 0.0, 1.0],
                         [1.0, 0.0, 0.0],
                         [0.0, 1.0, 0.0]])
    return np.array([[0.0, 1.0, 0.0],  # local x -> global z
                     [0.0, 0.0, 1.0],
                     [1.0, 0.0, 0.0]])


def generate_frame_case(
    rng: np.random.Generator,
    max_dof: int = 2000,
    dims: tuple | None = None,
    solve: bool = True,
) -> FVMCase:
    """One frame-structure stiffness system K u = f (see the JAX package's
    ``generate_frame_case``; same draws, same order): random grid extents
    with 300 <= free dof <= ``max_dof`` unless ``dims`` fixes them,
    per-member section properties, base layer grounded, a random load
    scaled to max |f| = 1, and the CG ground truth (atol 1e-6) unless
    ``solve=False``."""
    if dims is not None:
        nx, ny, nz = dims
        n_nodes = nx * ny * nz
    else:
        while True:
            nx = int(rng.integers(2, 6))
            ny = int(rng.integers(2, 6))
            nz = int(rng.integers(2, 7))
            n_nodes = nx * ny * nz
            free_nodes = n_nodes - nx * ny  # base layer grounded
            if 300 <= 6 * free_nodes <= max_dof:
                break

    def nid(i, j, k):
        return (k * ny + j) * nx + i

    members = []  # all axis-aligned grid edges
    for k in range(nz):
        for j in range(ny):
            for i in range(nx):
                if i + 1 < nx:
                    members.append((nid(i, j, k), nid(i + 1, j, k), 0))
                if j + 1 < ny:
                    members.append((nid(i, j, k), nid(i, j + 1, k), 1))
                if k + 1 < nz:
                    members.append((nid(i, j, k), nid(i, j, k + 1), 2))

    e_mod = 2.1e2  # scaled steel modulus (entries O(1e0..1e4))
    g_mod = e_mod / 2.6
    lengths = {0: 1.0 + 0.5 * rng.random(),
               1: 1.0 + 0.5 * rng.random(),
               2: 1.2 + 0.8 * rng.random()}

    rows, cols, vals = [], [], []
    for (na, nb, axis) in members:
        le = lengths[axis]
        scale = 3.0 if axis == 2 else 1.0  # columns one class stiffer
        area = scale * 10 ** rng.uniform(-0.5, 0.5)
        iy = scale * 1e-2 * 10 ** rng.uniform(-0.5, 0.5)
        iz = scale * 1e-2 * 10 ** rng.uniform(-0.5, 0.5)
        jt = 0.5 * (iy + iz)
        k_loc = beam_stiffness_local(
            le, e_mod * area, g_mod * jt, e_mod * iy, e_mod * iz
        )
        r3 = _rotation_for_axis(axis)
        t = np.zeros((12, 12))
        for blk in range(4):
            t[blk * 3:blk * 3 + 3, blk * 3:blk * 3 + 3] = r3
        k_glob = t @ k_loc @ t.T
        dofs = np.concatenate([6 * na + np.arange(6), 6 * nb + np.arange(6)])
        rr, cc = np.meshgrid(dofs, dofs, indexing="ij")
        rows.append(rr.ravel())
        cols.append(cc.ravel())
        vals.append(k_glob.ravel())

    n_dof = 6 * n_nodes
    k_full = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n_dof, n_dof),
    ).tocsr()

    free = np.ones(n_dof, bool)  # ground the base layer (k = 0)
    for j in range(ny):
        for i in range(nx):
            free[6 * nid(i, j, 0):6 * nid(i, j, 0) + 6] = False
    keep = np.where(free)[0]
    k_red = k_full[keep][:, keep].tocoo()
    # tiny rotational regularization: free-end rotation dofs of a
    # single-member chain can be near-singular under roundoff
    k_red = (k_red + 1e-9 * sp.eye(k_red.shape[0])).tocoo()

    n = k_red.shape[0]
    f = rng.standard_normal(n)
    f = f / np.abs(f).max()
    if solve:
        u, info = sp.linalg.cg(k_red.tocsr(), f, atol=1e-6, rtol=0.0,
                               maxiter=200000)
        if info != 0:
            raise RuntimeError(
                f"frame ground-truth CG diverged (info={info})")
    else:  # operator benchmarks need no ground truth
        u = np.zeros_like(f)
    return FVMCase(matrix=k_red, rhs=f, solution=u, shape_2d=(nx * ny, nz))
