"""Constant-coefficient 7-point Poisson stencil: the matrix-free SpMV.

Counterpart of ``deeppreconditioning_tpu/ops/pallas_stencil.py::
poisson3d_stencil_matvec`` (plain XLA in the reference, plain PyTorch
here): y = 6 x - (sum of the six neighbours) with zero ghost planes, the
operator of ``sparse.dia.poisson_dia(shape)`` without stored values.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def poisson3d_stencil_matvec(x: torch.Tensor, shape) -> torch.Tensor:
    """y = A x for the 7-point Dirichlet Poisson operator on ``shape``
    (nz, ny, nx); entries of x past nz*ny*nx are ignored and their y is
    zero."""
    nz, ny, nx = shape
    n = nz * ny * nx
    g = x[:n].reshape(nz, ny, nx)
    p = F.pad(g, (1, 1, 1, 1, 1, 1))
    y = (
        6.0 * g
        - p[0:nz, 1:ny + 1, 1:nx + 1]
        - p[2:nz + 2, 1:ny + 1, 1:nx + 1]
        - p[1:nz + 1, 0:ny, 1:nx + 1]
        - p[1:nz + 1, 2:ny + 2, 1:nx + 1]
        - p[1:nz + 1, 1:ny + 1, 0:nx]
        - p[1:nz + 1, 1:ny + 1, 2:nx + 2]
    )
    out = torch.zeros_like(x)
    out[:n] = y.reshape(-1)
    return out
