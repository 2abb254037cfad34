"""Scaling-path PCG iteration counts of the JAX reference on the CPU.

Runs the JAX package's structured-grid pieces in float32 (the card's
dtype) at 64^3 and 128^3, as ``scripts/scaling_learned.py``'s technique
block builds them, with no timing: ``poisson_coeff_dia`` (sigma 1.0,
coefficients from ``default_rng(1)``), the random rhs from
``default_rng(2)``, ``structured_setup`` + ``bands_to_dia`` for fsai and
learned (``assets/checkpoints_structured/deg1_random.msgpack``),
``build_gmg`` for gmg_jacobi and gmg_learned (smoother
``deg0_p1.msgpack`` on the finest level), and
``preconditioned_conjugate_gradient`` with the DIA matvec at rtol 1e-8.

Writes ``tests/fixtures/torch_port/scaling_iterations.json``: the seeds,
sigma, shapes, checkpoint names, the learned q and safeguard flag, and
per technique the iterations and convergence.  The PyTorch port's
``chip_smoke.py`` holds its counts on the GPU against this file.

    JAX_PLATFORMS=cpu python scripts/torch_port_scaling_reference.py
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

SHAPES = (64, 128)
SIGMA = 1.0
COEFF_SEED = 1
RHS_SEED = 2
RTOL = 1e-8
MAX_ITER = 1024
CHECKPOINT_DIR = REPO / "assets" / "checkpoints_structured"
CHECKPOINT = "deg1_random.msgpack"
SMOOTHER_CHECKPOINT = "deg0_p1.msgpack"
TECHNIQUES = ("vanilla", "jacobi", "fsai", "learned", "gmg_jacobi",
              "gmg_learned")
OUT = REPO / "tests" / "fixtures" / "torch_port" / "scaling_iterations.json"


def _dia_matvec(a, x):
    from deeppreconditioning_tpu.ops.pallas_spmv import dia_matvec

    return dia_matvec(a, x)


def _diag_apply(d, r):
    return d * r


def _gmg_ap(m, r):
    from deeppreconditioning_tpu.ops.gmg import gmg_apply

    return gmg_apply(m, r)


def reference_setups(side: int, dtype):
    """(a, b, {technique: (apply_m, m_data)}, learned q) of the JAX
    reference at side^3, arrays of ``dtype``; b is rounded through
    float32 as the reference builds it."""
    import jax
    import jax.numpy as jnp
    from flax import serialization

    from deeppreconditioning_tpu.data.poisson import poisson_coeff_dia
    from deeppreconditioning_tpu.ops.gmg import build_gmg
    from deeppreconditioning_tpu.ops.structured_fsai import (
        bands_to_dia,
        build_structured_plan,
        dia_sorted_by_offset,
        make_structured_poly_apply_dia,
        structured_setup,
    )
    from deeppreconditioning_tpu.solvers.cg import identity_apply

    learned, smoother = (
        serialization.msgpack_restore((CHECKPOINT_DIR / name).read_bytes())
        for name in (CHECKPOINT, SMOOTHER_CHECKPOINT))
    # the weights in the working dtype (a no-op for the float32 fixture)
    learned_params, smoother_params = (
        jax.tree.map(lambda v: jnp.asarray(v, dtype), payload["params"])
        for payload in (learned, smoother))
    shape = (side, side, side)
    a = dia_sorted_by_offset(poisson_coeff_dia(
        shape, rng=np.random.default_rng(COEFF_SEED), sigma=SIGMA,
        dtype=dtype,
    ))
    b = np.zeros(a.n_pad, np.float32)
    b[:a.n] = np.random.default_rng(RHS_SEED).standard_normal(a.n)
    b = jnp.asarray(b, dtype)
    plan = build_structured_plan(shape, power=int(learned["power"]))
    d = a.vals[a.offsets.index(0)]
    inv_diag = jnp.where(d == 0, 0.0, 1.0 / jnp.where(d == 0, 1.0, d))

    def structured(params):
        bands, q = structured_setup(a, plan, params)
        c_up, c_low = bands_to_dia(bands, plan.offsets, a.n)
        return (c_up, c_low, q, a), q

    m_fsai, _ = structured(None)
    m_learned, q_learned = structured(learned_params)
    setups = {
        "vanilla": (identity_apply, None),
        "jacobi": (_diag_apply, inv_diag),
        "fsai": (make_structured_poly_apply_dia(0), m_fsai),
        "learned": (make_structured_poly_apply_dia(
            int(learned["poly_degree"])), m_learned),
        "gmg_jacobi": (_gmg_ap, build_gmg(a, shape)),
        "gmg_learned": (_gmg_ap, build_gmg(
            a, shape, params=smoother_params,
            plan_power=int(smoother["power"]), fsai_smoother=True,
            fsai_levels=1)),
    }
    return a, b, setups, np.asarray(q_learned, np.float64)


def reference_scaling(side: int, dtype) -> dict:
    """Iterations and convergence per technique, the learned q and
    whether the safeguard fell back to q = I."""
    from deeppreconditioning_tpu.solvers.cg import (
        preconditioned_conjugate_gradient,
    )

    a, b, setups, q = reference_setups(side, dtype)
    iterations, converged = {}, {}
    for name in TECHNIQUES:
        apply_m, m_data = setups[name]
        res = preconditioned_conjugate_gradient(
            _dia_matvec, a, b, apply_m, m_data, rtol=RTOL,
            max_iter=MAX_ITER,
        )
        iterations[name] = int(res.iterations)
        converged[name] = bool(float(res.residual) < RTOL)
    return {
        "n": a.n,
        "n_pad": a.n_pad,
        "iterations": iterations,
        "converged": converged,
        "learned_q": q.tolist(),
        "safeguard_fallback": bool(np.allclose(q, np.eye(1, q.shape[0])[0])),
    }


def main() -> None:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    out = {
        "what": "scaling-path PCG iterations of the JAX reference, CPU "
                "float32",
        "shapes": list(SHAPES),
        "sigma": SIGMA,
        "coeff_seed": COEFF_SEED,
        "rhs_seed": RHS_SEED,
        "rtol": RTOL,
        "max_iter": MAX_ITER,
        "checkpoint": CHECKPOINT,
        "smoother_checkpoint": SMOOTHER_CHECKPOINT,
        "techniques": list(TECHNIQUES),
        "results": {},
    }
    for side in SHAPES:
        out["results"][str(side)] = reference_scaling(side, jnp.float32)
        print(side, json.dumps(out["results"][str(side)]["iterations"]),
              flush=True)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    main()
