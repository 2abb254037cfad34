"""The structured-grid scaling path: 64^3 / 128^3 Poisson on the card.

    python -m deeppreconditioning_tpu_torch.bench.scaling [--shapes 64,128]
        [--ckpt CKPT] [--smoother-ckpt CKPT] [--reps 5] [--sigma 1.0]
        [--rhs random|ax] [--k-solves 2,4,8] [--seq-out CSV] [--out CSV]
        [--no-gmg] [--with-amg] [--problem poisson|hpcg] [--device cpu]

Counterpart of ``scripts/scaling_learned.py::run_scaling`` as
``bench.py``'s scaling section calls it: variable-coefficient Poisson
(lognormal kappa, sigma 1.0, coefficients from ``default_rng(1)``;
``--sigma 0`` the constant ``poisson_dia``), a right-hand side from
``default_rng(2)`` (random, or ``--rhs ax``: b = A x* with x* standard
normal, the known solution), rtol 1e-8 on ||r||^2 / ||b||^2, and the
techniques vanilla, jacobi, fsai
(structured FSAI), learned (the structured NeuralFSAI head, by default
``deg1_random.msgpack``), gmg_jacobi and gmg_learned (geometric
multigrid, the finest level smoothed by the head ``deg0_p1.msgpack`` in
the learned checkpoint's folder, or ``--smoother-ckpt``; classical FSAI
where there is none).  ``--with-amg`` adds the reference's amg technique:
aggregation AMG (``ops/amg.build_amg``) built on the host from the
operator jittered by ``next_unique() * 1.2e-7`` (``DIAMatrix.to_scipy``),
one build timed on the host clock up to the device sync (its host parts
in ``ScalingRun.amg_builds``), applied as a V(1,1)-cycle; it sits out
the sequences, as in the reference.  Every CG operator is a DIA matvec
(kernel B2 on the card).

``--problem hpcg`` runs HPCG's problem instead (``data/poisson.
hpcg_operator``: the 27-point stencil, 26 on the diagonal, -1 for each
neighbour inside the box; b = A 1, so x* = 1 and ``x_rel_err`` is
reported; ``--sigma`` and ``--rhs`` do not apply) through the same
calls, with the techniques vanilla, jacobi, fsai and learned; the
structured plan follows the operator's stencil (the 3^3 box), so the
learned head must fit it: ``--ckpt`` a head of width 14 at power 1, such
as ``portbench/weights/structured_w14_deg1.msgpack``.

Per shape and technique: the setup, timed with CUDA events (median of
``reps`` after a warm-up), the chunked PCG solve for the iteration count
and convergence, and the timed solve: ``pcg_fixed_trips`` with
``min(iterations + 2, 1024)`` trips, whose unscaled run gives
``x_rel_err`` under ``--rhs ax``.  Writes the reference's CSV schema to
``assets/results/torch/scaling_learned.csv``.  With ``--k-solves`` each
technique then solves sequences of k right-hand sides of the same
operator (``pcg_sequence_fixed_trips``, ``min(int(1.3 iterations) + 4,
1024)`` trips each; random rhs: b random-walks from ``default_rng(7 +
k)``; ``ax``: ``poisson_rhs_sequence``), timed as one span (median of
``reps // 2``), written in the reference's ``multi_rhs.csv`` schema, and
the smallest k at which learned's total beats every other technique's is
the shape's ``crossover_k``.  Needs a CUDA device unless ``--device cpu``;
the tests call ``run_scaling`` on the CPU.
"""

from __future__ import annotations

import argparse
import itertools
import json
import time
from dataclasses import dataclass, field, replace
from pathlib import Path

import numpy as np
import torch

from deeppreconditioning_tpu_torch import _backend
from deeppreconditioning_tpu_torch.bench.suite import _diag_apply
from deeppreconditioning_tpu_torch.data.poisson import (
    hpcg_operator,
    hpcg_rhs,
    poisson_coeff_dia,
    poisson_rhs_sequence,
)
from deeppreconditioning_tpu_torch.models.neural_fsai import (
    neural_fsai_from_checkpoint,
)
from deeppreconditioning_tpu_torch.ops.amg import amg_apply, build_amg
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
    pcg_sequence_fixed_trips,
    preconditioned_conjugate_gradient,
)
from deeppreconditioning_tpu_torch.sparse.dia import poisson_dia
from deeppreconditioning_tpu_torch.train.checkpoint import load_checkpoint
from deeppreconditioning_tpu_torch.utils.profiling import (
    synchronize,
    time_call,
)

REPO = Path(__file__).resolve().parents[2]
CHECKPOINT_DIR = REPO / "assets" / "checkpoints_structured"
CHECKPOINT = "deg1_random.msgpack"
SMOOTHER_CHECKPOINT = "deg0_p1.msgpack"
RESULTS_CSV = REPO / "assets" / "results" / "torch" / "scaling_learned.csv"
SEQ_CSV = REPO / "assets" / "results" / "torch" / "multi_rhs.csv"
SHAPES = (64, 128)
SIGMA = 1.0
COEFF_SEED = 1
RHS_SEED = 2
SEQ_SEED = 7  # the sequence of length k draws from default_rng(7 + k)
SEQ_STEP = 0.1  # the random walk's relative step
RTOL = 1e-8
MAX_ITER = 1024
TIMING_REPS = 5
TECHNIQUES = ("vanilla", "jacobi", "fsai", "learned", "gmg_jacobi",
              "gmg_learned")
STRUCTURED_TECHNIQUES = ("fsai", "learned", "gmg_learned")
PROBLEMS = ("poisson", "hpcg")
HPCG_TECHNIQUES = ("vanilla", "jacobi", "fsai", "learned")
CSV_COLUMNS = ("shape", "technique", "n", "sigma", "iterations", "setup_s",
               "solve_s", "total_s", "converged", "x_rel_err",
               "safeguard_fallback")
SEQ_COLUMNS = ("shape", "technique", "n", "sigma", "k_solves",
               "iterations_mean", "setup_s", "solves_s", "total_s",
               "converged")
_UNIQUE = itertools.count(1)  # the amg jitter's counter (next_unique)


@dataclass
class ScalingRun:
    """What one run measured.  Keys of the dicts are (side, technique).

    ``setup_calls`` counts the technique's setup builds (warm-up, timing
    reps and the kept one; amg's one); for fsai, learned and gmg_learned
    each build runs one ``structured_setup``.  ``amg_builds`` holds per
    side the host seconds of amg's build by part (``to_scipy``, then
    ``build_amg``'s ``aggregate``, ``galerkin``, ``transfer`` and
    ``coarse``) and its hierarchy's row counts (``level_rows``).
    ``launches`` / ``plain_on_cuda`` are the kernel counters over the
    technique's setups, solves and sequences, and ``host_fallbacks``
    the host runtime's numpy fallbacks there.  ``seq_rows`` are the
    multi-RHS rows, ``details`` the reference's JSON (per shape and
    technique the iterations and total ms, per shape the crossover k).
    """

    rows: list = field(default_factory=list)
    setup_calls: dict = field(default_factory=dict)
    launches: dict = field(default_factory=dict)
    plain_on_cuda: dict = field(default_factory=dict)
    host_fallbacks: dict = field(default_factory=dict)
    learned_q: dict = field(default_factory=dict)  # side -> list
    seq_rows: list = field(default_factory=list)
    details: dict = field(default_factory=dict)
    amg_builds: dict = field(default_factory=dict)  # side -> dict


def scaling_problem(side: int, dtype=torch.float32, device=None,
                    sigma: float = SIGMA, rhs: str = "random",
                    problem: str = "poisson"):
    """The side^3 operator (sorted DIA bands; ``sigma`` 0: constant
    coefficients), its rhs and the known solution x* (None for the random
    rhs), rounded through float32 as the reference builds them.
    ``problem="hpcg"``: HPCG's operator, b = A 1 and x* = 1."""
    shape = (side, side, side)
    if problem == "hpcg":
        a = hpcg_operator(shape, dtype=dtype, device=device)
        x_star = torch.zeros(a.n_pad, dtype=dtype, device=device)
        x_star[:a.n] = 1.0
        return a, hpcg_rhs(a), x_star
    if problem != "poisson":
        raise ValueError(f"problem {problem!r} is not one of {PROBLEMS}")
    if sigma > 0:
        a = poisson_coeff_dia(shape, rng=np.random.default_rng(COEFF_SEED),
                              sigma=sigma, dtype=dtype, device=device)
    else:
        a = poisson_dia(shape, dtype=dtype, device=device)
    a = dia_sorted_by_offset(a)
    vec = np.zeros(a.n_pad, np.float32)
    vec[:a.n] = np.random.default_rng(RHS_SEED).standard_normal(a.n)
    vec = torch.tensor(vec, dtype=dtype, device=device)
    if rhs == "ax":
        return a, dia_matvec(a, vec), vec
    return a, vec, None


def scaling_operator(side: int, dtype=torch.float32, device=None):
    """The side^3 operator and the random rhs of the default run."""
    a, b, _ = scaling_problem(side, dtype, device)
    return a, b


def rhs_sequence(a, b: torch.Tensor, x_star, k: int) -> torch.Tensor:
    """The reference's k right-hand sides: with a known solution
    ``poisson_rhs_sequence`` from ``default_rng(7 + k)``; otherwise b
    itself random-walks (relative step 0.1 on the n rows, float32)."""
    rng = np.random.default_rng(SEQ_SEED + k)
    if x_star is not None:
        seq = poisson_rhs_sequence(a, k, rng, step=SEQ_STEP)[0]
    else:
        seq = np.zeros((k, a.n_pad), np.float32)
        cur = b.cpu().numpy().astype(np.float32)
        for t in range(k):
            seq[t] = cur
            cur = cur.copy()
            cur[:a.n] += SEQ_STEP * rng.standard_normal(a.n).astype(
                np.float32)
    return torch.as_tensor(seq, device=b.device).to(b.dtype)


def load_models(dtype=torch.float32, device=None, ckpt=None,
                smoother_ckpt=None):
    """(learned head, its pattern power, smoother head or None, its
    power).  The smoother defaults to ``deg0_p1.msgpack`` beside the
    learned checkpoint, if there is one."""
    ckpt = Path(ckpt) if ckpt else CHECKPOINT_DIR / CHECKPOINT
    smoother = (Path(smoother_ckpt) if smoother_ckpt
                else ckpt.parent / SMOOTHER_CHECKPOINT)
    models = []
    for path in (ckpt, smoother):
        if path is smoother and not path.exists():
            models += [None, 1]
            continue
        payload = load_checkpoint(path)
        model = neural_fsai_from_checkpoint(payload).to(device=device,
                                                        dtype=dtype)
        models += [model.eval(), int(payload["power"])]
    return tuple(models)


def next_unique() -> int:
    """A process-unique small integer (the amg setup's jitter)."""
    return next(_UNIQUE)


def amg_setup(a, record: dict | None = None):
    """The reference's amg setup: A jittered by ``next_unique() * 1.2e-7``
    in its values' dtype, its scipy CSR, and ``build_amg`` on the
    values' device; ``record`` gathers the host seconds by part and the
    hierarchy's row counts (the root's padded)."""
    t0 = time.perf_counter()
    jit = torch.tensor(next_unique() * 1.2e-7, dtype=a.vals.dtype)
    scale = (1.0 + jit).to(a.vals.device)
    csr = replace(a, vals=a.vals * scale).to_scipy()
    timings = {"to_scipy": time.perf_counter() - t0}
    m = build_amg(csr, n_pad=a.n_pad, dtype=a.vals.dtype,
                  device=a.vals.device, timings=timings)
    if record is not None:
        record.update(timings)
        record["level_rows"] = [lev.ell.n for lev in m.levels] + [
            int(m.coarse_inv.shape[0])]
    return m


def _setups(a, shape, models):
    """technique -> (apply_m, setup builder or None)."""
    learned, power, smoother, smoother_power = models
    plan = build_structured_plan(shape, power=power, a_offsets=a.offsets)

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
        "amg": (amg_apply, None),  # one host-timed build in run_scaling
    }


def write_csv(path: Path, rows: list, columns=CSV_COLUMNS) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w") as fio:
        fio.write(",".join(columns) + "\n")
        for row in rows:
            fio.write(",".join(str(row.get(k, "")) for k in columns) + "\n")


def crossover_k(seq_rows: list, side: int, k_solves) -> int | None:
    """The smallest k at which learned's total is at most every other
    technique's at the same k (the reference's measured crossover)."""
    for k in k_solves:
        at_k = {r["technique"]: r["total_s"] for r in seq_rows
                if r["k_solves"] == k and r["shape"] == f"{side}^3"}
        others = [v for t, v in at_k.items() if t != "learned"]
        if "learned" in at_k and others and at_k["learned"] <= min(others):
            return k
    return None


@torch.no_grad()
def run_scaling(device, shapes=SHAPES, dtype=torch.float32,
                reps: int = TIMING_REPS, out: Path | None = RESULTS_CSV,
                techniques=TECHNIQUES, sigma: float = SIGMA,
                rhs: str = "random", k_solves=(), seq_out: Path | None = None,
                ckpt=None, smoother_ckpt=None,
                with_amg: bool = False,
                problem: str = "poisson") -> ScalingRun:
    """Run the scaling comparison on ``device`` (see the module
    docstring); the kernel counters are reset per technique."""
    device = torch.device(device)
    models = load_models(dtype, device, ckpt, smoother_ckpt)
    if with_amg and "amg" not in techniques:
        techniques = (*techniques, "amg")
    if problem == "hpcg":
        techniques = tuple(t for t in techniques if t in HPCG_TECHNIQUES)
    run = ScalingRun()
    for side in shapes:
        shape = (side, side, side)
        a, b, x_star = scaling_problem(side, dtype, device, sigma, rhs,
                                       problem)
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
            if name == "amg":  # host-bound: one build on the host clock
                t0 = time.perf_counter()
                m_data = amg_setup(a, run.amg_builds.setdefault(side, {}))
                synchronize(device)
                setup_s = time.perf_counter() - t0
                calls[0] = 1
            elif build is not None:
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
            err = float("nan")
            if x_star is not None:  # from the unscaled fixed-trip solve
                err = float(torch.linalg.vector_norm(
                    fixed.x[:a.n] - x_star[:a.n])
                    / torch.linalg.vector_norm(x_star[:a.n]))
            solve_s = time_call(solve, device, reps=reps, warmup=0)
            row = {
                "shape": f"{side}^3", "technique": name, "n": a.n,
                "sigma": sigma, "iterations": iters, "setup_s": setup_s,
                "solve_s": solve_s, "total_s": setup_s + solve_s,
                "converged": converged, "x_rel_err": err,
            }
            if name == "learned":
                q = m_data[2].double().cpu().numpy()
                run.learned_q[side] = q.tolist()
                row["safeguard_fallback"] = bool(
                    np.allclose(q, np.eye(1, q.shape[0])[0]))
            run.rows.append(row)
            run.details[f"{side}_{name}"] = {
                "it": iters, "total_ms": (setup_s + solve_s) * 1e3}
            if out is not None:
                write_csv(Path(out), run.rows)
            for k in (() if name == "amg" else k_solves):
                b_seq = rhs_sequence(a, b, x_star, k)
                seq_trips = min(int(iters * 1.3) + 4, MAX_ITER)

                def sequence(_apply=apply_m, _m=m_data, _trips=seq_trips,
                             _b=b_seq):
                    return pcg_sequence_fixed_trips(
                        dia_matvec, a, _b, _apply, _m, rtol=RTOL,
                        max_iter=MAX_ITER, trips=_trips)

                _, its, ress = sequence()
                solves_s = time_call(sequence, device,
                                     reps=max(reps // 2, 1), warmup=0)
                run.seq_rows.append({
                    "shape": f"{side}^3", "technique": name, "n": a.n,
                    "sigma": sigma, "k_solves": k,
                    "iterations_mean": float(its.double().mean()),
                    "setup_s": setup_s, "solves_s": solves_s,
                    "total_s": setup_s + solves_s,
                    "converged": bool((ress < RTOL).all()),
                })
                if seq_out is not None:
                    write_csv(Path(seq_out), run.seq_rows, SEQ_COLUMNS)
            run.launches[key] = _backend.launch_counts()
            run.plain_on_cuda[key] = _backend.plain_cuda_counts()
            run.host_fallbacks[key] = _backend.host_fallback_counts()
            run.setup_calls[key] = calls[0]
        if k_solves:
            k = crossover_k(run.seq_rows, side, k_solves)
            if k is not None:
                run.details[f"{side}_crossover_k"] = k
    return run


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--shapes", default=",".join(map(str, SHAPES)))
    parser.add_argument("--ckpt", default=str(CHECKPOINT_DIR / CHECKPOINT))
    parser.add_argument("--smoother-ckpt", default=None)
    parser.add_argument("--reps", type=int, default=TIMING_REPS)
    parser.add_argument("--sigma", type=float, default=SIGMA,
                        help="lognormal contrast; 0 gives the constant-"
                        "coefficient ladder")
    parser.add_argument("--rhs", default="random", choices=["random", "ax"])
    parser.add_argument("--k-solves", default="",
                        help="sequence lengths of the multi-RHS protocol, "
                        "e.g. 2,4,8; empty: off")
    parser.add_argument("--seq-out", default=str(SEQ_CSV))
    parser.add_argument("--out", default=str(RESULTS_CSV))
    parser.add_argument("--no-gmg", action="store_true")
    parser.add_argument("--with-amg", action="store_true",
                        help="add the aggregation-AMG technique (host "
                        "setup)")
    parser.add_argument("--problem", default="poisson", choices=PROBLEMS,
                        help="hpcg: HPCG's 27-point operator with b = A 1 "
                        "(vanilla, jacobi, fsai, learned; --ckpt a width-14 "
                        "power-1 head)")
    parser.add_argument("--device", default=None,
                        help="'cpu' for the CPU; the card otherwise")
    args = parser.parse_args(argv)
    device = (torch.device(args.device) if args.device
              else _backend.device())
    ks = tuple(int(s) for s in args.k_solves.split(",") if s)
    techniques = tuple(t for t in TECHNIQUES
                       if not (args.no_gmg and t.startswith("gmg")))
    run = run_scaling(device, tuple(int(s) for s in args.shapes.split(",")),
                      reps=args.reps, out=Path(args.out),
                      techniques=techniques, sigma=args.sigma, rhs=args.rhs,
                      k_solves=ks, seq_out=Path(args.seq_out) if ks else None,
                      ckpt=args.ckpt, smoother_ckpt=args.smoother_ckpt,
                      with_amg=args.with_amg, problem=args.problem)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {name}; CSV {args.out}" + (f", {args.seq_out}" if ks
                                               else ""))
    print(f"{'shape':<6} {'technique':<12} {'iters':>6} {'setup_ms':>10} "
          f"{'solve_ms':>10} {'total_ms':>10} converged x_rel_err")
    for row in run.rows:
        print(f"{row['shape']:<6} {row['technique']:<12} "
              f"{row['iterations']:>6} {row['setup_s'] * 1e3:>10.3f} "
              f"{row['solve_s'] * 1e3:>10.3f} {row['total_s'] * 1e3:>10.3f} "
              f"{row['converged']} {row['x_rel_err']}")
    for row in run.seq_rows:
        print(f"{row['shape']:<6} {row['technique']:<12} k {row['k_solves']}"
              f" iterations_mean {row['iterations_mean']} total_ms "
              f"{row['total_s'] * 1e3:.3f} converged {row['converged']}")
    for side, parts in run.amg_builds.items():
        print(f"{side}^3 amg host setup (s): " + ", ".join(
            f"{k} {v}" for k, v in parts.items()))
    print("JSON:" + json.dumps(run.details))


if __name__ == "__main__":
    main()
