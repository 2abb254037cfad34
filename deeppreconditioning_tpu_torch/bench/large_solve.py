"""Matrix-free CG on the 3-D Poisson system at card scale.

    python -m deeppreconditioning_tpu_torch.bench.large_solve [--grid 256]
        [--max-iter 1024] [--rtol 1e-8] [--device cpu]

Counterpart of ``scripts/large_solve.py``: plain CG
(``solvers.cg.conjugate_gradient``) on the 7-point constant-coefficient
Poisson operator of a grid^3 box (16.7M unknowns at 256^3, float32),
applied matrix-free on flat vectors (``ops.stencil.stencil_matvec_flat``);
b standard normal from ``default_rng(0)``.  One warm-up solve, then one
timed solve, and the reference's line: iterations, seconds, iterations
per second, unknown-updates per second and the final squared relative
residual.  No hand-written kernel runs here: the stencil is plain
PyTorch, as it is plain XLA in the reference.
"""

from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import numpy as np
import torch

from deeppreconditioning_tpu_torch import _backend
from deeppreconditioning_tpu_torch.ops.stencil import (
    StencilOperator3D,
    stencil_matvec_flat,
)
from deeppreconditioning_tpu_torch.solvers.cg import conjugate_gradient
from deeppreconditioning_tpu_torch.utils.profiling import synchronize


class LargeSolve(NamedTuple):
    grid: int
    n: int
    iterations: int
    seconds: float
    residual: float
    x: torch.Tensor

    def line(self) -> str:
        """The reference script's report line."""
        g, n, it, dt = self.grid, self.n, self.iterations, self.seconds
        return (f"grid {g}^3: n={n:,} dof, {it} iterations in {dt:.2f}s "
                f"({it / dt:.0f} it/s, {n * it / dt / 1e9:.2f} "
                f"Gdof-updates/s), final squared rel resid "
                f"{self.residual:.2e}")


@torch.no_grad()
def large_solve(grid: int = 256, max_iter: int = 1024, rtol: float = 1e-8,
                device=None, dtype=torch.float32) -> LargeSolve:
    """One warm-up and one timed ``conjugate_gradient`` on the grid^3
    stencil (see the module docstring)."""
    device = torch.device(device) if device is not None else _backend.device()
    op = StencilOperator3D(shape=(grid, grid, grid))
    n = grid ** 3
    b = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    b = torch.as_tensor(b, device=device).to(dtype)
    conjugate_gradient(stencil_matvec_flat, op, b, rtol=rtol,
                       max_iter=max_iter)
    synchronize(device)
    start = time.perf_counter()
    res = conjugate_gradient(stencil_matvec_flat, op, b, rtol=rtol,
                             max_iter=max_iter)
    iters, residual = int(res.iterations), float(res.residual)
    synchronize(device)
    return LargeSolve(grid, n, iters, time.perf_counter() - start, residual,
                      res.x)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--grid", type=int, default=256)
    parser.add_argument("--max-iter", type=int, default=1024)
    parser.add_argument("--rtol", type=float, default=1e-8)
    parser.add_argument("--device", default=None,
                        help="'cpu' for the CPU; the card otherwise")
    args = parser.parse_args(argv)
    print(large_solve(args.grid, args.max_iter, args.rtol,
                      device=args.device).line())


if __name__ == "__main__":
    main()
