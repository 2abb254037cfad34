"""Work counts of the V(1,1) damped-Jacobi multigrid solve
(``runners/structured_gmg.py``), from the grid and the iterations alone.

The hierarchy is ``reference/gmg.level_shapes``'s: smoothed levels while
every side is even and at least 16, then the dense root.  Per level of n
rows (n_pad padded), one cycle makes two 7-band products with the level's
operator (kernel B2, ``dia_work``) and 9 n further flops: two Jacobi
sweeps of 2 n (omega d r), two residual subtractions, the restriction's
sums, the prolongation's add and the second sweep's add, n each; the root
adds its dense product, 2 nc^2.  A request's setup folds each level's 7
bands into the next (7 n adds), takes each inverse diagonal (n) and
inverts the root (2 nc^3: LU and inversion).
"""

from __future__ import annotations

import numpy as np

from portbench.inputs.poisson import pad_rows
from portbench.reference.gmg import level_shapes
from portbench.work import NO_WORK, dia_work, pcg_vector_flops

BANDS = 7  # the 7-point operator on every level
CYCLE_VECTOR_FLOPS = 9  # a row of a level, a cycle, outside the products


def hierarchy(shape) -> tuple:
    """([(rows, padded rows)] of the smoothed levels, the root's rows)."""
    shapes, root = level_shapes(shape)
    rows = [int(np.prod(s)) for s in shapes]
    return [(n, pad_rows(n)) for n in rows], int(np.prod(root))


def cycle_b2(shape):
    """Kernel B2's least work in one cycle: two products a level."""
    levels, _ = hierarchy(shape)
    work = NO_WORK
    for _, n_pad in levels:
        work = work + dia_work(BANDS, n_pad) + dia_work(BANDS, n_pad)
    return work


def cycle_flops(shape) -> int:
    """One cycle's flops: the products, the vector work, the root."""
    levels, root = hierarchy(shape)
    return (cycle_b2(shape).flops
            + sum(CYCLE_VECTOR_FLOPS * n for n, _ in levels)
            + 2 * root * root)


def setup_flops(shape) -> int:
    """The hierarchy's build: the Galerkin folds, the inverse diagonals,
    the root's inverse."""
    levels, root = hierarchy(shape)
    return sum((BANDS + 1) * n for n, _ in levels) + 2 * root ** 3


def solve_work(shape, iterations: int) -> dict:
    """Kernel B2's least work and the flops of one request: the setup,
    then at the start and each of ``iterations`` iterations the operator
    product, one cycle and the PCG's vector updates."""
    levels, _ = hierarchy(shape)
    n, n_pad = levels[0]
    applies = iterations + 1
    b2 = NO_WORK
    for _ in range(applies):
        b2 = b2 + dia_work(BANDS, n_pad) + cycle_b2(shape)
    flops = (setup_flops(shape) + applies * (
        dia_work(BANDS, n_pad).flops + cycle_flops(shape)
        + pcg_vector_flops(n)))
    return {"b2": b2, "flops": flops}
