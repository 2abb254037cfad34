"""Iteration counts of the JAX reference for the rest of bench.py's protocol.

Runs the JAX package on the CPU in float32, with its numpy IC(0), level
and assembly paths (the C++ ``native`` library is switched off: the port
copies the numpy path), over the three parts of ``bench.py:main()`` that
the PyTorch port's first slices did not run:

* the per-case techniques ``incomplete_cholesky``,
  ``incomplete_cholesky_neumann`` and ``algebraic_multigrid`` on the
  sludge-pattern test split (500 cases from seed 69420 at
  ``mesh_cells=2``, the last 100), through the suite's ``_setup_*`` and
  ``preconditioned_conjugate_gradient``, with no timing;
* ``BenchmarkSuite.run_batched`` on the same split with bench.py's seven
  techniques and the flagship checkpoint: per technique the per-case
  iterations and success of the fixed-trip run, the trips and the M dtype
  its bf16-first / f32-fallback attempt settled on (timing reps cut to
  the minimum; ``chunk`` bounds memory, the counts do not depend on it);
* bench.py's ``_irregular_split``: 100 3-D castellated cases from seed
  69421 (odd cases permuted), the last 20, vanilla / jacobi / fsai /
  learned with the flagship checkpoint at pattern power 2, per case, and
  which cases took the generic FSAI plan; the same counts in float64 too
  (``iterations_f64``): on a few learned cases the float32 run takes one
  iteration more than the float64 one.

Writes ``tests/fixtures/torch_port/batched_iterations.json``; the port's
``chip_smoke.py`` holds its counts on the GPU against it.  About 30
minutes (the batched setups on the CPU) and 4 GB on 8 CPU cores;
``--irregular-only`` recomputes the irregular part of an existing file
(about two minutes).

    JAX_PLATFORMS=cpu python scripts/torch_port_batched_reference.py
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from deeppreconditioning_tpu import native  # noqa: E402

native.available = lambda: False  # the numpy paths the port copies

from deeppreconditioning_tpu.bench.suite import (  # noqa: E402
    BenchmarkSuite,
    _diag_apply,
    _fsai_range_setup_device,
    _fsai_setup_device,
    _neural_fsai_setup_device,
)
from deeppreconditioning_tpu.data.datasets import (  # noqa: E402
    SludgePatternDataSet,
)
from deeppreconditioning_tpu.data.fvm import (  # noqa: E402
    generate_sludge_case,
    generate_sludge_case_3d,
    save_case,
)
from deeppreconditioning_tpu.models import (  # noqa: E402
    NeuralFSAI,
    plan_builder_for,
)
from deeppreconditioning_tpu.ops.banded_factor import (  # noqa: E402
    band_spread,
)
from deeppreconditioning_tpu.ops.ic0 import (  # noqa: E402
    jacobi_preconditioner,
)
from deeppreconditioning_tpu.solvers.cg import (  # noqa: E402
    dense_matvec,
    ell_matvec,
    identity_apply,
    preconditioned_conjugate_gradient,
)
from deeppreconditioning_tpu.sparse import ELLMatrix  # noqa: E402
from deeppreconditioning_tpu.train.trainer import (  # noqa: E402
    load_checkpoint,
)

SEED = 69420
SAMPLES = 500
MESH_CELLS = 2
IRREGULAR_SEED = 69421
IRREGULAR_SAMPLES = 100
IRREGULAR_POWER = 2
TECHNIQUES = ("vanilla", "jacobi", "incomplete_cholesky",
              "incomplete_cholesky_neumann", "algebraic_multigrid",
              "fsai", "learned")
NEW_PERCASE = ("incomplete_cholesky", "incomplete_cholesky_neumann",
               "algebraic_multigrid")
IRREGULAR_TECHNIQUES = ("vanilla", "jacobi", "fsai", "learned")
CHUNK = 25
CHECKPOINT = REPO / "assets" / "checkpoints_fsai" / "best.msgpack"
OUT = REPO / "tests" / "fixtures" / "torch_port" / "batched_iterations.json"


def _model():
    payload = load_checkpoint(CHECKPOINT)
    model = NeuralFSAI(
        width=int(payload["width"]),
        hidden=int(payload.get("hidden", 64)),
        poly_degree=int(payload.get("poly_degree", 1)),
    )
    return model, payload["params"], int(payload.get("power", 4)) or 4


def _data_set(root: Path, family: str = "sludge_patterns"):
    return SludgePatternDataSet(
        stage="test", batch_size=1,
        specs=plan_builder_for("NeuralFSAI", None),
        shuffle=False, root=root, family=family,
    )


def _solve(suite, ell, b, apply_m, m_data):
    res = preconditioned_conjugate_gradient(
        ell_matvec, ell, b, apply_m, m_data,
        rtol=suite.rtol, max_iter=suite.max_iter,
        check_every=suite.check_every,
    )
    return int(res.iterations), bool(float(res.residual) < suite.rtol)


def _system(suite, index, n_pad, dtype=jnp.float32):
    a_sp, rhs, n0 = suite._reconstruct(index)
    ell = ELLMatrix.from_scipy(a_sp, n_pad=n_pad, dtype=dtype)
    b = np.zeros(n_pad)
    b[:n0] = rhs
    return a_sp, ell, jnp.asarray(b, dtype), n0


def percase_new(suite, data_set) -> dict:
    """Per-case counts of the three techniques the port adds."""
    n_pad = data_set.dof_pad
    out = {"iterations": {t: [] for t in NEW_PERCASE},
           "success": {t: [] for t in NEW_PERCASE}}
    for index in range(len(data_set)):
        batch = data_set[index]
        a_sp, ell, b, _ = _system(suite, index, n_pad)
        for name in NEW_PERCASE:
            apply_m, m_data, _, _ = getattr(suite, f"_setup_{name}")(
                a_sp, batch, ell, False, timing=True)
            iters, ok = _solve(suite, ell, b, apply_m, m_data)
            out["iterations"][name].append(iters)
            out["success"][name].append(ok)
    return out


def batched(suite) -> dict:
    """run_batched with the attempt each technique settled on."""
    settled = {}
    inner = suite._batched_setup

    def recording(name, setup_reps, chunk, m_dtype=None):
        settled[name] = "float32" if m_dtype is None else "bfloat16"
        return inner(name, setup_reps, chunk, m_dtype=m_dtype)

    suite._batched_setup = recording
    stats = suite.run_batched(reps=1, setup_reps=1, chunk=CHUNK)
    n_pad = suite._batched_common()["n_pad"]
    groups = suite._batched_fsai_inputs(
        suite.learned_power or suite.fsai_power, suite.model.width)
    d_max = max(band_spread(np.asarray(p.out_rows), n_pad)
                for _, p, _, _ in groups)
    return {
        "techniques": list(stats),
        "check_every": {t: suite._BATCHED_CHECK_EVERY[t] for t in stats},
        "learned_apply": ("banded" if d_max <= suite.banded_spread_cap
                          else "dense"),
        "learned_d_max": int(d_max),
        "plan_groups": {
            "fsai": [g[3] for g in suite._batched_fsai_inputs(
                suite.fsai_power,
                suite._fsai_meta(n_pad, suite.fsai_power)[0])],
            "learned": [g[3] for g in groups],
        },
        "m_dtype": settled,
        "trips": {t: s["trips"] for t, s in stats.items()},
        "mean_iterations": {t: s["iterations"] for t, s in stats.items()},
        "iterations": {t: [int(v) for v in s["iterations_per_case"]]
                       for t, s in stats.items()},
        "success": {t: s["success"] for t, s in stats.items()},
    }


def _irregular_counts(suite, data_set, model, params, dtype):
    """Per-case counts of the irregular techniques in ``dtype`` and the
    cases on the generic plan."""
    n_pad = data_set.dof_pad
    iterations = {t: [] for t in IRREGULAR_TECHNIQUES}
    success = {t: [] for t in IRREGULAR_TECHNIQUES}
    generic = {"fsai": [], "learned": []}
    for index in range(len(data_set)):
        batch = data_set[index]
        a_sp, ell, b, n0 = _system(suite, index, n_pad, dtype)
        n0_dev = jnp.int32(n0)
        d = np.zeros(n_pad)
        d[:n0] = jacobi_preconditioner(a_sp)
        kind_f, plan_f, op_f, sc_f = suite._fsai_plan(index, batch, ell)
        kind_l, plan_l, op_l, sc_l = suite._fsai_plan(
            index, batch, ell, width=model.width, power=IRREGULAR_POWER)
        for name, kind in (("fsai", kind_f), ("learned", kind_l)):
            if kind == "generic":
                generic[name].append(index)
        fsai_setup = (_fsai_range_setup_device if kind_f == "range"
                      else _fsai_setup_device)
        setups = {
            "vanilla": (identity_apply, None),
            "jacobi": (_diag_apply, jnp.asarray(d, dtype)),
            "fsai": (dense_matvec, fsai_setup(
                plan_f, op_f, sc_f, n0_dev, dtype=dtype)),
            "learned": (dense_matvec, _neural_fsai_setup_device(
                model, params, plan_l, op_l, sc_l, n0_dev, dtype=dtype)),
        }
        for name, (apply_m, m_data) in setups.items():
            iters, ok = _solve(suite, ell, b, apply_m, m_data)
            iterations[name].append(iters)
            success[name].append(ok)
    return iterations, success, generic


def irregular(model, params, root: Path) -> dict:
    """bench.py's _irregular_split per case, no timing, in float32 and
    in float64."""
    rng = np.random.default_rng(IRREGULAR_SEED)
    for i in range(IRREGULAR_SAMPLES):
        case = generate_sludge_case_3d(
            rng, mesh_cells=2, castellated=True, permute=bool(i % 2))
        save_case(case, root / "sludge_patterns_3d" / f"case_{i:04d}")
    data_set = _data_set(root, "sludge_patterns_3d")
    suite = BenchmarkSuite(
        data_set, model, params, techniques=IRREGULAR_TECHNIQUES,
        kappa_cases=0, fsai_power=IRREGULAR_POWER,
        learned_power=IRREGULAR_POWER,
    )
    n_pad = data_set.dof_pad
    iterations, success, generic = _irregular_counts(
        suite, data_set, model, params, jnp.float32)
    with jax.enable_x64(True):
        iterations_f64, _, generic_f64 = _irregular_counts(
            suite, data_set, model, params, jnp.float64)
    if generic_f64 != generic:
        raise RuntimeError("the plan kinds depend on the dtype")
    return {
        "seed": IRREGULAR_SEED,
        "samples": IRREGULAR_SAMPLES,
        "cases": len(data_set),
        "n_pad": n_pad,
        "fsai_power": IRREGULAR_POWER,
        "learned_power": IRREGULAR_POWER,
        "widths": {"fsai": suite._fsai_meta(n_pad, IRREGULAR_POWER)[0],
                   "learned": model.width},
        "range_h": suite._fsai_meta(n_pad, IRREGULAR_POWER)[1],
        "generic_cases": generic,
        "mean_iterations": {t: float(np.mean(v))
                            for t, v in iterations.items()},
        "iterations": iterations,
        "success": success,
        "mean_iterations_f64": {t: float(np.mean(v))
                                for t, v in iterations_f64.items()},
        "iterations_f64": iterations_f64,
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--irregular-only", action="store_true",
                        help="recompute the irregular part of OUT only")
    args = parser.parse_args()
    t0 = time.perf_counter()
    model, params, power = _model()
    if args.irregular_only:
        out = json.loads(OUT.read_text())
        with tempfile.TemporaryDirectory() as tmp:
            out["irregular"] = irregular(model, params, Path(tmp))
        OUT.write_text(json.dumps(out, indent=1) + "\n")
        print(json.dumps({k: out["irregular"][k] for k in (
            "mean_iterations", "mean_iterations_f64", "generic_cases")}))
        return
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        rng = np.random.default_rng(SEED)
        for i in range(SAMPLES):
            case = generate_sludge_case(rng, mesh_cells=MESH_CELLS)
            save_case(case, root / "sludge_patterns" / f"case_{i:04d}")
        data_set = _data_set(root)
        irr = irregular(model, params, root)
    print(f"irregular done {time.perf_counter() - t0:.0f} s", flush=True)
    # bench.py's suite: seven techniques, the learned pattern power from
    # the checkpoint, the classical fsai at its default power 4
    suite = BenchmarkSuite(
        data_set, model, params, techniques=TECHNIQUES, kappa_cases=0,
        learned_power=power,
    )
    per = percase_new(suite, data_set)
    print(f"per case done {time.perf_counter() - t0:.0f} s", flush=True)
    bat = batched(suite)
    print(f"batched done {time.perf_counter() - t0:.0f} s", flush=True)
    out = {
        "what": "JAX reference iteration counts, CPU float32, numpy "
                "IC(0) / levels / assembly",
        "seed": SEED,
        "samples": SAMPLES,
        "mesh_cells": MESH_CELLS,
        "cases": len(data_set),
        "n_pad": data_set.dof_pad,
        "fsai_power": suite.fsai_power,
        "learned_power": power,
        "check_every": suite.check_every,
        "ic_neumann_sweeps": suite.ic_neumann_sweeps,
        "rtol": suite.rtol,
        "max_iter": suite.max_iter,
        "chunk": CHUNK,
        "percase": {
            "mean_iterations": {t: float(np.mean(v))
                                for t, v in per["iterations"].items()},
            **per,
        },
        "batched": bat,
        "irregular": irr,
    }
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps({
        "percase": out["percase"]["mean_iterations"],
        "batched": bat["mean_iterations"], "m_dtype": bat["m_dtype"],
        "irregular": irr["mean_iterations"],
        "generic": irr["generic_cases"],
        "seconds": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
