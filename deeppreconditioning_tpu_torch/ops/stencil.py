"""Constant-coefficient Poisson stencils: the matrix-free SpMV.

Counterpart of ``deeppreconditioning_tpu/ops/pallas_stencil.py`` (plain
XLA in the reference, plain PyTorch here: no TPU kernel stands behind
it).  ``poisson3d_stencil_matvec`` is y = 6 x - (sum of the six
neighbours) with zero ghost planes, the operator of
``sparse.dia.poisson_dia(shape)`` without stored values;
``poisson2d_stencil_matvec`` its 5-point twin.  ``StencilOperator3D``
keeps vectors in the ghost-padded (nz+2, ny+2, nx+2) layout (``embed`` /
``extract`` at the solve's ends); ``stencil_matvec_padded`` and
``stencil_matvec_flat`` are its solver bindings ``matvec(op, x)``, the
second on flat interior vectors (what ``bench.large_solve`` runs).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
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


def poisson2d_stencil_matvec(x: torch.Tensor, shape) -> torch.Tensor:
    """The 5-point 2-D operator on ``shape`` (ny, nx), same conventions."""
    ny, nx = shape
    n = ny * nx
    g = x[:n].reshape(ny, nx)
    p = F.pad(g, (1, 1, 1, 1))
    y = (
        4.0 * g
        - p[0:ny, 1:nx + 1]
        - p[2:ny + 2, 1:nx + 1]
        - p[1:ny + 1, 0:nx]
        - p[1:ny + 1, 2:nx + 2]
    )
    out = torch.zeros_like(x)
    out[:n] = y.reshape(-1)
    return out


@dataclass(frozen=True)
class StencilOperator3D:
    """7-point Poisson operator on ghost-padded vectors: ghost entries are
    zero and stay zero through CG's linear updates, so the matvec is
    shifted slices of the padded grid."""

    shape: tuple

    @property
    def padded_shape(self) -> tuple:
        nz, ny, nx = self.shape
        return (nz + 2, ny + 2, nx + 2)

    @property
    def size(self) -> int:
        return int(np.prod(self.padded_shape))

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """Flat interior vector -> flat padded vector."""
        nz, ny, nx = self.shape
        g = x[:nz * ny * nx].reshape(nz, ny, nx)
        return F.pad(g, (1, 1, 1, 1, 1, 1)).reshape(-1)

    def extract(self, xp: torch.Tensor) -> torch.Tensor:
        nz, ny, nx = self.shape
        return xp.reshape(self.padded_shape)[
            1:nz + 1, 1:ny + 1, 1:nx + 1].reshape(-1)

    def matvec(self, xp: torch.Tensor) -> torch.Tensor:
        """y_padded = A x_padded (the result's ghost entries are 0)."""
        nz, ny, nx = self.shape
        p = xp.reshape(self.padded_shape)
        y = (
            6.0 * p[1:nz + 1, 1:ny + 1, 1:nx + 1]
            - p[0:nz, 1:ny + 1, 1:nx + 1]
            - p[2:nz + 2, 1:ny + 1, 1:nx + 1]
            - p[1:nz + 1, 0:ny, 1:nx + 1]
            - p[1:nz + 1, 2:ny + 2, 1:nx + 1]
            - p[1:nz + 1, 1:ny + 1, 0:nx]
            - p[1:nz + 1, 1:ny + 1, 2:nx + 2]
        )
        return F.pad(y, (1, 1, 1, 1, 1, 1)).reshape(-1)


def stencil_matvec_padded(op: StencilOperator3D,
                          xp: torch.Tensor) -> torch.Tensor:
    """Solver binding ``matvec(a_data, x)`` on padded vectors."""
    return op.matvec(xp)


def stencil_matvec_flat(op: StencilOperator3D,
                        x: torch.Tensor) -> torch.Tensor:
    """Solver binding ``matvec(a_data, x)`` on flat interior vectors."""
    return poisson3d_stencil_matvec(x, op.shape)
