"""Scaling-path amg iterations of the JAX reference on the CPU.

Runs ``scripts/scaling_learned.py::run_scaling``'s amg technique (its
``--with-amg`` block) on the CPU in float32 at 64^3 and 128^3, with no
timing: the operator ``poisson_coeff_dia`` (sigma 1.0, coefficients from
``default_rng(1)``, bands sorted by offset) and the random rhs from
``default_rng(2)``, as ``torch_port_scaling_reference.py`` builds them;
then the block itself: the float32 values jittered by ``next_unique() *
1.2e-7`` (the process counter's first and second values, 1 at 64^3 and 2
at 128^3), ``DIAMatrix.to_scipy``, ``build_amg(csr, n_pad=a.n_pad)`` and
``preconditioned_conjugate_gradient`` with the DIA matvec and
``amg_apply`` at rtol 1e-8.  The rest of ``run_scaling`` (the other
techniques' timed setups and solves) is left out.

Writes ``tests/fixtures/torch_port/scaling_amg_iterations.json``: per
shape the jitter, the hierarchy's level sizes (rows and padded rows per
level, the root's padded size), the iterations and convergence.  The
PyTorch port's ``chip_smoke.py`` holds its amg rows on the GPU against
it.

    JAX_PLATFORMS=cpu python scripts/torch_port_scaling_amg_reference.py
        [--shapes 64,128]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from deeppreconditioning_tpu.data.poisson import (  # noqa: E402
    poisson_coeff_dia,
)
from deeppreconditioning_tpu.ops.amg import (  # noqa: E402
    amg_apply,
    build_amg,
)
from deeppreconditioning_tpu.ops.pallas_spmv import dia_matvec  # noqa: E402
from deeppreconditioning_tpu.ops.structured_fsai import (  # noqa: E402
    dia_sorted_by_offset,
)
from deeppreconditioning_tpu.solvers.cg import (  # noqa: E402
    preconditioned_conjugate_gradient,
)
from deeppreconditioning_tpu.utils.profiling import (  # noqa: E402
    next_unique,
)

SHAPES = (64, 128)
SIGMA = 1.0
COEFF_SEED = 1
RHS_SEED = 2
RTOL = 1e-8
OUT = (REPO / "tests" / "fixtures" / "torch_port"
       / "scaling_amg_iterations.json")


def _amg_ap(m, r):
    return amg_apply(m, r)


def amg_row(side: int) -> dict:
    """The amg technique of ``run_scaling`` at side^3 (float32)."""
    shape = (side, side, side)
    a = poisson_coeff_dia(shape, rng=np.random.default_rng(COEFF_SEED),
                          sigma=SIGMA, dtype=jnp.float32)
    a = dia_sorted_by_offset(a)
    n = a.n
    b_np = np.zeros(a.n_pad, np.float32)
    b_np[:n] = np.random.default_rng(RHS_SEED).standard_normal(n)
    b = jnp.asarray(b_np)
    unique = next_unique()
    jit = jnp.float32(unique * 1.2e-7)
    a_j = jax.tree.map(
        lambda x: x * (1.0 + jit) if x.dtype == jnp.float32 else x, a)
    t0 = time.perf_counter()
    m = build_amg(a_j.to_scipy(), n_pad=a.n_pad)
    build_s = time.perf_counter() - t0
    res = preconditioned_conjugate_gradient(
        dia_matvec, a, b, rtol=RTOL, apply_m=_amg_ap, m_data=m)
    iters = int(res.iterations)
    print(f"{side}^3 amg: {iters} iterations, residual "
          f"{float(res.residual):.3e}, host build {build_s:.1f} s",
          flush=True)
    return {
        "n": n,
        "n_pad": a.n_pad,
        "next_unique": unique,
        "jitter": float(jit),
        "level_rows": [int(lev.ell.n) for lev in m.levels],
        "level_rows_pad": [int(lev.ell.n_pad) for lev in m.levels],
        "coarse_pad": int(m.coarse_inv.shape[0]),
        "iterations": iters,
        "converged": bool(float(res.residual) < RTOL),
        "residual": float(res.residual),
    }


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--shapes", default=",".join(map(str, SHAPES)))
    args = parser.parse_args()
    shapes = tuple(int(s) for s in args.shapes.split(","))
    out = {
        "what": "run_scaling's amg technique (--with-amg) of the JAX "
                "reference, CPU float32: iterations and convergence of "
                "PCG with the DIA matvec and the aggregation-AMG V-cycle",
        "sigma": SIGMA,
        "coeff_seed": COEFF_SEED,
        "rhs_seed": RHS_SEED,
        "rtol": RTOL,
        "shapes": list(shapes),
        "results": {str(side): amg_row(side) for side in shapes},
    }
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    main()
