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
per technique the iterations and convergence; at both shapes the
multi-RHS sequences (``k_solves`` 2, 4, 8 of the default operator and
random rhs: the rhs random-walks from ``default_rng(7 + k)``,
``pcg_sequence_fixed_trips`` with ``min(int(1.3 iterations) + 4, 1024)``
trips; per technique and k the iterations of each solve, their mean and
convergence).  Then, at 64^3, the rest of ``run_scaling``'s protocols:
the known-solution rows (``rhs ax``: b = A x*, with ``x_rel_err`` from
the fixed-trip solve with ``iterations + 2`` trips) and the
constant-coefficient rows (``sigma 0``: ``poisson_dia``), each with
vanilla's float64 count.  The PyTorch port's ``chip_smoke.py``
holds its counts on the GPU against this file.  About 25 minutes.

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
PROTOCOL_SIDE = 64  # the known-solution and sigma-0 rows
K_SOLVES = (2, 4, 8)
SEQ_SEED, SEQ_STEP = 7, 0.1


def _dia_matvec(a, x):
    from deeppreconditioning_tpu.ops.pallas_spmv import dia_matvec

    return dia_matvec(a, x)


def _diag_apply(d, r):
    return d * r


def _gmg_ap(m, r):
    from deeppreconditioning_tpu.ops.gmg import gmg_apply

    return gmg_apply(m, r)


def reference_problem(side: int, dtype, sigma=SIGMA, rhs="random"):
    """(a, b, x*) of the JAX reference at side^3, arrays of ``dtype``:
    sigma 0 is ``poisson_dia``; the rhs (or x* under ``ax``, with b =
    A x*, else x* None) is rounded through float32 as the reference
    builds it."""
    import jax.numpy as jnp

    from deeppreconditioning_tpu.data.poisson import poisson_coeff_dia
    from deeppreconditioning_tpu.ops.structured_fsai import (
        dia_sorted_by_offset,
    )
    from deeppreconditioning_tpu.sparse.dia import poisson_dia

    shape = (side, side, side)
    if sigma > 0:
        a = poisson_coeff_dia(shape, rng=np.random.default_rng(COEFF_SEED),
                              sigma=sigma, dtype=dtype)
    else:
        a = poisson_dia(shape, dtype=dtype)
    a = dia_sorted_by_offset(a)
    b = np.zeros(a.n_pad, np.float32)
    b[:a.n] = np.random.default_rng(RHS_SEED).standard_normal(a.n)
    b = jnp.asarray(b, dtype)
    if rhs == "ax":
        return a, a.matvec(b), b
    return a, b, None


def reference_setups(side: int, dtype, sigma=SIGMA, rhs="random",
                     techniques=TECHNIQUES):
    """(a, b, {technique: (apply_m, m_data)} for ``techniques``, learned
    q, x*) of the JAX reference at side^3 (``reference_problem``)."""
    import jax
    import jax.numpy as jnp
    from flax import serialization

    from deeppreconditioning_tpu.ops.gmg import build_gmg
    from deeppreconditioning_tpu.ops.structured_fsai import (
        bands_to_dia,
        build_structured_plan,
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
    a, b, x_star = reference_problem(side, dtype, sigma, rhs)
    shape = (side, side, side)
    plan = build_structured_plan(shape, power=int(learned["power"]))
    d = a.vals[a.offsets.index(0)]
    inv_diag = jnp.where(d == 0, 0.0, 1.0 / jnp.where(d == 0, 1.0, d))

    def structured(params):
        bands, q = structured_setup(a, plan, params)
        c_up, c_low = bands_to_dia(bands, plan.offsets, a.n)
        return (c_up, c_low, q, a), q

    m_learned, q_learned = structured(learned_params)
    builders = {
        "vanilla": lambda: (identity_apply, None),
        "jacobi": lambda: (_diag_apply, inv_diag),
        "fsai": lambda: (make_structured_poly_apply_dia(0),
                         structured(None)[0]),
        "learned": lambda: (make_structured_poly_apply_dia(
            int(learned["poly_degree"])), m_learned),
        "gmg_jacobi": lambda: (_gmg_ap, build_gmg(a, shape)),
        "gmg_learned": lambda: (_gmg_ap, build_gmg(
            a, shape, params=smoother_params,
            plan_power=int(smoother["power"]), fsai_smoother=True,
            fsai_levels=1)),
    }
    setups = {name: builders[name]() for name in techniques}
    return a, b, setups, np.asarray(q_learned, np.float64), x_star


def rhs_sequence(a, b, x_star, k: int, dtype):
    """The reference's k right-hand sides (``run_scaling``'s sequence
    block): ``poisson_rhs_sequence`` under a known solution, else b
    random-walking in float32."""
    import jax.numpy as jnp

    from deeppreconditioning_tpu.data.poisson import poisson_rhs_sequence

    rng = np.random.default_rng(SEQ_SEED + k)
    if x_star is not None:
        return jnp.asarray(poisson_rhs_sequence(a, k, rng, step=SEQ_STEP)[0],
                           dtype)
    seq = np.zeros((k, a.n_pad), np.float32)
    cur = np.asarray(b, np.float32).copy()
    for t in range(k):
        seq[t] = cur
        cur = cur.copy()
        cur[:a.n] += SEQ_STEP * rng.standard_normal(a.n).astype(np.float32)
    return jnp.asarray(seq, dtype)


def reference_scaling(side: int, dtype, sigma=SIGMA, rhs="random",
                      k_solves=(), techniques=TECHNIQUES) -> dict:
    """Iterations and convergence per technique, the learned q and
    whether the safeguard fell back to q = I; under ``ax`` each
    technique's ``x_rel_err``; per technique and k in ``k_solves`` the
    sequence's iterations, their mean and convergence."""
    import jax.numpy as jnp

    from deeppreconditioning_tpu.solvers.cg import (
        pcg_fixed_trips,
        pcg_sequence_fixed_trips,
        preconditioned_conjugate_gradient,
    )

    a, b, setups, q, x_star = reference_setups(side, dtype, sigma, rhs,
                                               techniques)
    iterations, converged, errors, sequences = {}, {}, {}, {}
    for name in techniques:
        apply_m, m_data = setups[name]
        res = preconditioned_conjugate_gradient(
            _dia_matvec, a, b, apply_m, m_data, rtol=RTOL,
            max_iter=MAX_ITER,
        )
        iterations[name] = int(res.iterations)
        converged[name] = bool(float(res.residual) < RTOL)
        if x_star is not None:
            fixed = pcg_fixed_trips(
                _dia_matvec, a, b, apply_m, m_data, rtol=RTOL,
                max_iter=MAX_ITER, trips=min(iterations[name] + 2, MAX_ITER))
            errors[name] = float(jnp.linalg.norm(fixed.x[:a.n] - x_star[:a.n])
                                 / jnp.linalg.norm(x_star[:a.n]))
        for k in k_solves:
            trips = min(int(iterations[name] * 1.3) + 4, MAX_ITER)
            _, its, ress = pcg_sequence_fixed_trips(
                _dia_matvec, a, rhs_sequence(a, b, x_star, k, dtype),
                apply_m, m_data, rtol=RTOL, max_iter=MAX_ITER, trips=trips)
            its = np.asarray(its)
            sequences.setdefault(name, {})[str(k)] = {
                "trips": trips,
                "iterations": its.tolist(),
                "iterations_mean": float(its.mean()),
                "converged": bool((np.asarray(ress) < RTOL).all()),
            }
            print(f"  {side}^3 {name} k {k}: {its.tolist()}", flush=True)
    out = {
        "n": a.n,
        "n_pad": a.n_pad,
        "sigma": sigma,
        "rhs": rhs,
        "iterations": iterations,
        "converged": converged,
        "learned_q": q.tolist(),
        "safeguard_fallback": bool(np.allclose(q, np.eye(1, q.shape[0])[0])),
    }
    if errors:
        out["x_rel_err"] = errors
    if sequences:
        out["sequences"] = sequences
    return out


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
    out["k_solves"] = list(K_SOLVES)
    out["seq_seed"], out["seq_step"] = SEQ_SEED, SEQ_STEP
    out["sequences"] = {}
    for side in SHAPES:
        res = reference_scaling(side, jnp.float32, k_solves=K_SOLVES)
        out["sequences"][str(side)] = res.pop("sequences")
        out["results"][str(side)] = res
        print(side, json.dumps(res["iterations"]), flush=True)
    side = PROTOCOL_SIDE
    out["ax"] = {str(side): reference_scaling(side, jnp.float32, rhs="ax")}
    out["sigma0"] = {str(side): reference_scaling(side, jnp.float32,
                                                  sigma=0.0)}
    # unpreconditioned float32 CG's count is set by rounding: the float64
    # count bounds the spread from the other side
    jax.config.update("jax_enable_x64", True)
    for part, kwargs in (("ax", {"rhs": "ax"}), ("sigma0", {"sigma": 0.0})):
        out[part][str(side)]["vanilla_f64"] = reference_scaling(
            side, jnp.float64, techniques=("vanilla",),
            **kwargs)["iterations"]["vanilla"]
        print(part, json.dumps(out[part][str(side)]["iterations"]),
              "vanilla f64", out[part][str(side)]["vanilla_f64"], flush=True)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    main()
