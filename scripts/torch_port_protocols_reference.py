"""The JAX reference's counts for the batched and one-off protocols.

Runs the JAX package on the CPU in float32, with its numpy IC(0) and level
paths (the C++ ``native`` library switched off, as the other fixture
scripts do), and no timing: the reference's timing helper
(``utils.profiling.time_dispatch_chain``) is replaced by one that returns
0, so each setup is built once and each solve runs once.  Four parts, each
written to its own file in ``tests/fixtures/torch_port/`` and each
runnable alone (``--part``; several parts may run in parallel processes):

* ``frames`` -> ``frames_ic_iterations.json``: ``scripts/frames_bench.py``'s
  ``incomplete_cholesky`` row per case (200 frame cases from seed 69422,
  the last 40) through ``BenchmarkSuite.run`` with one kappa case: the
  iterations, success flags and case 0's kappa; the iterations in float64
  too.  About 1 minute.
* ``frames-batched`` -> ``frames_batched_iterations.json``: the script's
  ``run_batched`` (vanilla, jacobi, fsai, learned; the frames checkpoint at
  power 2, the default chunk of 100): per technique the per-case
  iterations and success of the fixed-trip run, its trips and the M dtype
  its bf16-first / f32-retry attempt settled on; the learned route (band
  form or dense, and the band spread) and the plan groups; the vanilla
  row in float64 too.  About 16 minutes, most of it the learned attempts.
* ``irregular-batched`` -> ``irregular_batched_iterations.json``:
  ``scripts/batched_probe.py --irregular``'s five techniques (vanilla,
  jacobi, incomplete_cholesky_neumann, fsai, learned) at power 2, chunk
  20, on bench.py's irregular split (100 3-D castellated cases from seed
  69421, odd ones permuted, the last 20), recorded as the frames part.
  About 1 minute.
* ``meshes`` -> ``compare_meshes.json``: ``scripts/compare_meshes.py``'s
  NeuralFSAI branch with one case per resolution (``default_rng(69)``,
  ``mesh_cells`` 2 to 6, the flagship checkpoint at its power 4): ``dof``,
  kappa(A) and kappa(M A), both float64 on the host, M from the JAX CPU
  float32 ``neural_fsai_case_setup``.  About 1.5 minutes.

The times are those of the four parts run at once, one process each, on
8 CPU cores.

The port's ``chip_smoke.py`` and its CPU tests hold their counts and kappas
against these files.

    JAX_PLATFORMS=cpu python scripts/torch_port_protocols_reference.py \
        [--part frames --part meshes ...]
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
sys.path.insert(0, str(REPO / "scripts"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from deeppreconditioning_tpu import native  # noqa: E402
from deeppreconditioning_tpu.utils import profiling  # noqa: E402

native.available = lambda: False  # the numpy paths the fixtures hold
# no timing reps: each setup and solve runs once
profiling.time_dispatch_chain = lambda step, reps=(3, 12), blocks=2: 0.0

from deeppreconditioning_tpu.bench.suite import (  # noqa: E402
    BenchmarkSuite,
)
from deeppreconditioning_tpu.data.datasets import (  # noqa: E402
    SludgePatternDataSet,
)
from deeppreconditioning_tpu.data.frames import (  # noqa: E402
    generate_frame_case,
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
from deeppreconditioning_tpu.train.trainer import (  # noqa: E402
    load_checkpoint,
)

FIXTURES = REPO / "tests" / "fixtures" / "torch_port"
FRAMES_SEED = 69422
FRAMES_SAMPLES = 200
FRAMES_POWER = 2
FRAMES_CHECKPOINT = REPO / "assets" / "checkpoints_frames" / "best.msgpack"
FRAMES_BATCHED = ("vanilla", "jacobi", "fsai", "learned")
FRAMES_CHUNK = 100  # run_batched's default, as frames_bench.py calls it
IRREGULAR_SEED = 69421
IRREGULAR_SAMPLES = 100
IRREGULAR_POWER = 2
PROBE_TECHNIQUES = ("vanilla", "jacobi", "incomplete_cholesky_neumann",
                    "fsai", "learned")
PROBE_CHUNK = 20  # batched_probe.py's default
FLAGSHIP_CHECKPOINT = REPO / "assets" / "checkpoints_fsai" / "best.msgpack"
MESHES_SEED = 69  # compare_meshes.py's
MESH_CELLS = (2, 3, 4, 5, 6)
OUTS = {
    "frames": FIXTURES / "frames_ic_iterations.json",
    "frames-batched": FIXTURES / "frames_batched_iterations.json",
    "irregular-batched": FIXTURES / "irregular_batched_iterations.json",
    "meshes": FIXTURES / "compare_meshes.json",
}
WHAT = "JAX reference, CPU float32, numpy IC(0) / levels, no timing"


def _model(checkpoint: Path):
    payload = load_checkpoint(checkpoint)
    model = NeuralFSAI(
        width=int(payload["width"]),
        hidden=int(payload.get("hidden", 64)),
        poly_degree=int(payload.get("poly_degree", 1)),
    )
    return model, payload["params"], payload


def _saved_split(root: Path, family: str, cases) -> SludgePatternDataSet:
    for i, case in enumerate(cases):
        save_case(case, root / family / f"case_{i:04d}")
    return SludgePatternDataSet(
        stage="test", batch_size=1,
        specs=plan_builder_for("NeuralFSAI", None),
        shuffle=False, root=root, family=family,
    )


def _frames_split(root: Path) -> SludgePatternDataSet:
    rng = np.random.default_rng(FRAMES_SEED)
    return _saved_split(root, "frame_structures",
                        [generate_frame_case(rng)
                         for _ in range(FRAMES_SAMPLES)])


def _irregular_split(root: Path) -> SludgePatternDataSet:
    rng = np.random.default_rng(IRREGULAR_SEED)
    return _saved_split(root, "sludge_patterns_3d", [
        generate_sludge_case_3d(rng, mesh_cells=2, castellated=True,
                                permute=bool(i % 2))
        for i in range(IRREGULAR_SAMPLES)])


def batched(suite, chunk: int) -> dict:
    """run_batched with the attempt each technique settled on (the
    ``recording`` wrapper of ``torch_port_batched_reference.py``)."""
    settled = {}
    inner = suite._batched_setup

    def recording(name, setup_reps, chunk, m_dtype=None):
        settled[name] = "float32" if m_dtype is None else "bfloat16"
        return inner(name, setup_reps, chunk, m_dtype=m_dtype)

    suite._batched_setup = recording
    stats = suite.run_batched(reps=1, setup_reps=1, chunk=chunk)
    n_pad = suite._batched_common()["n_pad"]
    groups = suite._batched_fsai_inputs(
        suite.learned_power or suite.fsai_power, suite.model.width)
    d_max = max(band_spread(np.asarray(p.out_rows), n_pad)
                for _, p, _, _ in groups)
    fsai_groups = suite._batched_fsai_inputs(
        suite.fsai_power, suite._fsai_meta(n_pad, suite.fsai_power)[0])
    return {
        "techniques": list(stats),
        "chunk": chunk,
        "check_every": {t: suite._BATCHED_CHECK_EVERY[t] for t in stats},
        "learned_apply": ("banded" if d_max <= suite.banded_spread_cap
                          else "dense"),
        "learned_d_max": int(d_max),
        "plan_groups": {
            "fsai": [[g[3], int(g[0].shape[0])] for g in fsai_groups],
            "learned": [[g[3], int(g[0].shape[0])] for g in groups],
        },
        "m_dtype": settled,
        "trips": {t: s["trips"] for t, s in stats.items()},
        "mean_iterations": {t: s["iterations"] for t, s in stats.items()},
        "iterations": {t: [int(v) for v in s["iterations_per_case"]]
                       for t, s in stats.items()},
        "success": {t: s["success"] for t, s in stats.items()},
    }


def frames_ic(root: Path) -> dict:
    """frames_bench.py's incomplete_cholesky row per case, in float32 and
    (``iterations_f64``) in float64: case 19's float32 run stops at
    9.997e-9 of the 1e-8 tolerance, three iterations before the float64
    one."""
    data_set = _frames_split(root)
    name = "incomplete_cholesky"

    def run(dtype, kappa_cases):
        suite = BenchmarkSuite(
            data_set, None, None, techniques=(name,), dtype=dtype,
            kappa_cases=kappa_cases, timing_reps=1, fsai_power=FRAMES_POWER,
            results_directory=root / "results",
        )
        suite.run()
        return suite

    suite = run(jnp.float32, 1)
    with jax.enable_x64(True):
        iterations_f64 = [int(v) for v in run(jnp.float64, 0).iterations[
            name]]
    return {
        "seed": FRAMES_SEED, "samples": FRAMES_SAMPLES,
        "cases": len(data_set), "n_pad": data_set.dof_pad,
        "technique": name,
        "mean_iterations": float(np.mean(suite.iterations[name])),
        "iterations": [int(v) for v in suite.iterations[name]],
        "success": [s == 100.0 for s in suite.successes[name]],
        "kappa_case0": float(suite.kappas[name][0]),
        "density_case0": float(suite.densities[name][0]),
        "mean_iterations_f64": float(np.mean(iterations_f64)),
        "iterations_f64": iterations_f64,
    }


def frames_batched(root: Path) -> dict:
    """frames_bench.py's run_batched, and its vanilla row again in float64
    (``vanilla_f64``: unpreconditioned CG on these systems takes a count
    set by rounding)."""
    data_set = _frames_split(root)
    model, params, payload = _model(FRAMES_CHECKPOINT)
    suite = BenchmarkSuite(
        data_set, model, params, techniques=FRAMES_BATCHED, kappa_cases=0,
        fsai_power=FRAMES_POWER,
        learned_power=int(payload.get("power", FRAMES_POWER)),
    )
    out = {"seed": FRAMES_SEED, "samples": FRAMES_SAMPLES,
           "cases": len(data_set), "n_pad": data_set.dof_pad,
           **batched(suite, FRAMES_CHUNK)}
    with jax.enable_x64(True):
        suite64 = BenchmarkSuite(data_set, None, None,
                                 techniques=("vanilla",), kappa_cases=0,
                                 dtype=jnp.float64, fsai_power=FRAMES_POWER)
        stats = suite64.run_batched(reps=1, setup_reps=1, m_dtype=None)
    out["vanilla_f64"] = [int(v) for v in
                          stats["vanilla"]["iterations_per_case"]]
    return out


def irregular_batched(root: Path) -> dict:
    """batched_probe.py --irregular's run_batched."""
    data_set = _irregular_split(root)
    model, params, _ = _model(FLAGSHIP_CHECKPOINT)
    suite = BenchmarkSuite(
        data_set, model, params, techniques=PROBE_TECHNIQUES,
        kappa_cases=0, fsai_power=IRREGULAR_POWER,
        learned_power=IRREGULAR_POWER,
    )
    return {"seed": IRREGULAR_SEED, "samples": IRREGULAR_SAMPLES,
            "cases": len(data_set), "n_pad": data_set.dof_pad,
            **batched(suite, PROBE_CHUNK)}


def meshes(root: Path) -> dict:
    """compare_meshes.py's NeuralFSAI branch, one case per resolution."""
    from compare_meshes import _kappa_for_case_fsai

    del root
    model, params, payload = _model(FLAGSHIP_CHECKPOINT)
    power = int(payload.get("power", 4)) or 4
    rng = np.random.default_rng(MESHES_SEED)
    rows = []
    for mesh_cells in MESH_CELLS:
        case = generate_sludge_case(rng, mesh_cells=mesh_cells)
        pre, post = _kappa_for_case_fsai(case, model, params, power)
        rows.append({"mesh_cells": mesh_cells,
                     "dof": int(case.matrix.shape[0]),
                     "kappa_pre": pre, "kappa_post": post})
        print(rows[-1], flush=True)
    return {"seed": MESHES_SEED, "cases_per_resolution": 1,
            "power": power, "width": model.width, "rows": rows}


PARTS = {"frames": frames_ic, "frames-batched": frames_batched,
         "irregular-batched": irregular_batched, "meshes": meshes}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--part", action="append", choices=list(PARTS),
                        help="the parts to (re)compute; default all")
    args = parser.parse_args()
    for part in args.part or list(PARTS):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            out = {"what": WHAT, **PARTS[part](Path(tmp))}
        out["seconds"] = time.perf_counter() - t0
        OUTS[part].parent.mkdir(parents=True, exist_ok=True)
        OUTS[part].write_text(json.dumps(out, indent=1) + "\n")
        print(json.dumps({part: {k: out[k] for k in out
                                 if k in ("mean_iterations", "m_dtype",
                                          "learned_apply", "learned_d_max",
                                          "kappa_case0", "seconds")}}),
              flush=True)


if __name__ == "__main__":
    main()
