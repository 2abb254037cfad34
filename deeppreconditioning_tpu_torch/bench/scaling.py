"""The structured-grid scaling path: 64^3 / 128^3 Poisson on the card.

    python -m deeppreconditioning_tpu_torch.bench.scaling

Counterpart of ``scripts/scaling_learned.py::run_scaling`` (without AMG
and the multi-RHS protocol) as ``bench.py``'s scaling section calls it:
variable-coefficient Poisson (lognormal kappa, sigma 1.0, coefficients
from ``default_rng(1)``), a random right-hand side from
``default_rng(2)``, rtol 1e-8 on ||r||^2 / ||b||^2, and the techniques
vanilla, jacobi, fsai (structured FSAI), learned (the structured
NeuralFSAI head ``deg1_random.msgpack``), gmg_jacobi and gmg_learned
(geometric multigrid, the finest level smoothed by ``deg0_p1.msgpack``).
Every CG operator is a DIA matvec (kernel B2 on the card).

Per shape and technique: the setup, timed with CUDA events (median of
``reps`` after a warm-up), the chunked PCG solve for the iteration count
and convergence, and the timed solve: ``pcg_fixed_trips`` with
``min(iterations + 2, 1024)`` trips.  Writes the reference's CSV schema
to ``assets/results/torch/scaling_learned.csv``.  Needs a CUDA device
when run as a module; the tests call ``run_scaling`` on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from deeppreconditioning_tpu_torch import _backend
from deeppreconditioning_tpu_torch.bench.suite import _diag_apply
from deeppreconditioning_tpu_torch.data.poisson import poisson_coeff_dia
from deeppreconditioning_tpu_torch.models.neural_fsai import (
    neural_fsai_from_checkpoint,
)
from deeppreconditioning_tpu_torch.ops.dia_spmv import dia_matvec
from deeppreconditioning_tpu_torch.ops.gmg import (
    build_gmg,
    gmg_apply,
    inverse_diagonal,
)
from deeppreconditioning_tpu_torch.ops.structured_fsai import (
    bands_to_dia,
    build_structured_plan,
    dia_sorted_by_offset,
    make_structured_poly_apply_dia,
    structured_setup,
)
from deeppreconditioning_tpu_torch.solvers.cg import (
    identity_apply,
    pcg_fixed_trips,
    preconditioned_conjugate_gradient,
)
from deeppreconditioning_tpu_torch.train.checkpoint import load_checkpoint
from deeppreconditioning_tpu_torch.utils.profiling import time_call

REPO = Path(__file__).resolve().parents[2]
CHECKPOINT_DIR = REPO / "assets" / "checkpoints_structured"
CHECKPOINT = "deg1_random.msgpack"
SMOOTHER_CHECKPOINT = "deg0_p1.msgpack"
RESULTS_CSV = REPO / "assets" / "results" / "torch" / "scaling_learned.csv"
SHAPES = (64, 128)
SIGMA = 1.0
COEFF_SEED = 1
RHS_SEED = 2
RTOL = 1e-8
MAX_ITER = 1024
TIMING_REPS = 5
TECHNIQUES = ("vanilla", "jacobi", "fsai", "learned", "gmg_jacobi",
              "gmg_learned")
STRUCTURED_TECHNIQUES = ("fsai", "learned", "gmg_learned")
CSV_COLUMNS = ("shape", "technique", "n", "sigma", "iterations", "setup_s",
               "solve_s", "total_s", "converged", "x_rel_err",
               "safeguard_fallback")


@dataclass
class ScalingRun:
    """What one run measured.  Keys of the dicts are (side, technique).

    ``setup_calls`` counts the technique's setup builds (warm-up, timing
    reps and the kept one); for fsai, learned and gmg_learned each build
    runs one ``structured_setup``.  ``launches`` / ``plain_on_cuda`` are
    the kernel counters over the technique's setups and solves.
    """

    rows: list = field(default_factory=list)
    setup_calls: dict = field(default_factory=dict)
    launches: dict = field(default_factory=dict)
    plain_on_cuda: dict = field(default_factory=dict)
    learned_q: dict = field(default_factory=dict)  # side -> list


def scaling_operator(side: int, dtype=torch.float32, device=None):
    """The side^3 operator (sorted DIA bands) and the random rhs, rounded
    through float32 as the reference builds it."""
    shape = (side, side, side)
    a = dia_sorted_by_offset(poisson_coeff_dia(
        shape, rng=np.random.default_rng(COEFF_SEED), sigma=SIGMA,
        dtype=dtype, device=device,
    ))
    b = np.zeros(a.n_pad, np.float32)
    b[:a.n] = np.random.default_rng(RHS_SEED).standard_normal(a.n)
    return a, torch.tensor(b, dtype=dtype, device=device)


def load_models(dtype=torch.float32, device=None):
    """(learned head, its pattern power, smoother head, its power)."""
    models = []
    for name in (CHECKPOINT, SMOOTHER_CHECKPOINT):
        payload = load_checkpoint(CHECKPOINT_DIR / name)
        model = neural_fsai_from_checkpoint(payload).to(device=device,
                                                        dtype=dtype)
        models += [model.eval(), int(payload["power"])]
    return tuple(models)


def _setups(a, shape, models):
    """technique -> (apply_m, setup builder or None)."""
    learned, power, smoother, smoother_power = models
    plan = build_structured_plan(shape, power=power)

    def structured(model):
        def build():
            bands, q = structured_setup(a, plan, model)
            c_up, c_low = bands_to_dia(bands, plan.offsets, a.n)
            return c_up, c_low, q, a
        return build

    return {
        "vanilla": (identity_apply, None),
        "jacobi": (_diag_apply, lambda: inverse_diagonal(a)),
        "fsai": (make_structured_poly_apply_dia(0), structured(None)),
        "learned": (make_structured_poly_apply_dia(learned.poly_degree),
                    structured(learned)),
        "gmg_jacobi": (gmg_apply, lambda: build_gmg(a, shape)),
        "gmg_learned": (gmg_apply, lambda: build_gmg(
            a, shape, model=smoother, plan_power=smoother_power,
            fsai_levels=1)),
    }


def write_csv(path: Path, rows: list) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w") as fio:
        fio.write(",".join(CSV_COLUMNS) + "\n")
        for row in rows:
            fio.write(",".join(str(row.get(k, "")) for k in CSV_COLUMNS)
                      + "\n")


@torch.no_grad()
def run_scaling(device, shapes=SHAPES, dtype=torch.float32,
                reps: int = TIMING_REPS, out: Path | None = RESULTS_CSV,
                techniques=TECHNIQUES) -> ScalingRun:
    """Run the scaling comparison on ``device`` (see the module
    docstring); the kernel counters are reset per technique."""
    device = torch.device(device)
    models = load_models(dtype, device)
    run = ScalingRun()
    for side in shapes:
        shape = (side, side, side)
        a, b = scaling_operator(side, dtype, device)
        setups = _setups(a, shape, models)
        for name in techniques:
            apply_m, build = setups[name]
            key = (side, name)
            calls = [0]

            def counted_build(_build=build, _calls=calls):
                _calls[0] += 1
                return _build()

            _backend.reset_launch_counts()
            setup_s, m_data = 0.0, None
            if build is not None:
                setup_s = time_call(counted_build, device, reps=reps)
                m_data = counted_build()
            res = preconditioned_conjugate_gradient(
                dia_matvec, a, b, apply_m, m_data, rtol=RTOL,
                max_iter=MAX_ITER,
            )
            iters = int(res.iterations)
            converged = float(res.residual) < RTOL
            trips = min(iters + 2, MAX_ITER)

            def solve(_apply=apply_m, _m=m_data, _trips=trips):
                return pcg_fixed_trips(dia_matvec, a, b, _apply, _m,
                                       rtol=RTOL, max_iter=MAX_ITER,
                                       trips=_trips)

            fixed = solve()
            if int(fixed.iterations) != iters:
                raise RuntimeError(
                    f"{side}^3 {name}: {trips} fixed trips took "
                    f"{int(fixed.iterations)} iterations, the chunked "
                    f"solve {iters}")
            solve_s = time_call(solve, device, reps=reps, warmup=0)
            run.launches[key] = _backend.launch_counts()
            run.plain_on_cuda[key] = _backend.plain_cuda_counts()
            run.setup_calls[key] = calls[0]
            row = {
                "shape": f"{side}^3", "technique": name, "n": a.n,
                "sigma": SIGMA, "iterations": iters, "setup_s": setup_s,
                "solve_s": solve_s, "total_s": setup_s + solve_s,
                "converged": converged, "x_rel_err": float("nan"),
            }
            if name == "learned":
                q = m_data[2].double().cpu().numpy()
                run.learned_q[side] = q.tolist()
                row["safeguard_fallback"] = bool(
                    np.allclose(q, np.eye(1, q.shape[0])[0]))
            run.rows.append(row)
            if out is not None:
                write_csv(Path(out), run.rows)
    return run


def main() -> None:
    device = _backend.device()
    run = run_scaling(device)
    print(f"device: {torch.cuda.get_device_name(device)}; CSV "
          f"{RESULTS_CSV}")
    print(f"{'shape':<6} {'technique':<12} {'iters':>6} {'setup_ms':>10} "
          f"{'solve_ms':>10} {'total_ms':>10} converged")
    for row in run.rows:
        print(f"{row['shape']:<6} {row['technique']:<12} "
              f"{row['iterations']:>6} {row['setup_s'] * 1e3:>10.3f} "
              f"{row['solve_s'] * 1e3:>10.3f} {row['total_s'] * 1e3:>10.3f} "
              f"{row['converged']}")


if __name__ == "__main__":
    main()
