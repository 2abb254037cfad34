"""Per-case PCG iterations of the JAX reference's conv models on the split.

Runs the JAX package on the CPU in float32 over the sludge-pattern test
split (500 cases from seed 69420 at ``mesh_cells=2``, the last 100) for
the learned technique of the conv families: the dense apply (M = L L^T)
for ``assets/checkpoints/best.msgpack`` (PreconditionerNet),
``assets/checkpoints_v2/best.msgpack`` (PreconditionerNet, fine-tuned)
and ``assets/checkpoints_unet/best.msgpack`` (PreconditionerSparseUNet),
and the factor apply (z = L (L^T r)) for the first.  It calls the
suite's ``_learned_setup_device`` / ``_learned_factor_values`` and
``preconditioned_conjugate_gradient`` directly, with no timing.

Writes ``tests/fixtures/torch_port/conv_iterations.json``: per run the
per-case iterations and success flags; the seed, ``n_pad``, each model's
level buckets and final-pattern widths, and whether the reference's
native host runtime built the plans.  The PyTorch port's
``chip_smoke.py`` holds its own counts on the GPU against this file.

    JAX_PLATFORMS=cpu python scripts/torch_port_conv_reference.py
"""

from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from deeppreconditioning_tpu import native  # noqa: E402
from deeppreconditioning_tpu.bench.suite import (  # noqa: E402
    BenchmarkSuite,
    _learned_factor_values,
    _learned_setup_device,
)
from deeppreconditioning_tpu.data.datasets import (  # noqa: E402
    SludgePatternDataSet,
)
from deeppreconditioning_tpu.data.fvm import (  # noqa: E402
    generate_sludge_case,
    save_case,
)
from deeppreconditioning_tpu.models import (  # noqa: E402
    PreconditionerNet,
    PreconditionerSparseUNet,
    plan_builder_for,
)
from deeppreconditioning_tpu.ops.factor_apply import (  # noqa: E402
    factor_normal_apply,
)
from deeppreconditioning_tpu.solvers.cg import (  # noqa: E402
    dense_matvec,
    ell_matvec,
    preconditioned_conjugate_gradient,
)
from deeppreconditioning_tpu.sparse import ELLMatrix  # noqa: E402
from deeppreconditioning_tpu.train.trainer import (  # noqa: E402
    load_checkpoint,
)

SEED = 69420
SAMPLES = 500
MESH_CELLS = 2
CHANNELS = (1, 16, 32, 64, 32, 16, 1)
CKPT = REPO / "assets"
# run name -> (model class name, checkpoint, learned_apply)
RUNS = {
    "precond_net": ("PreconditionerNet",
                    CKPT / "checkpoints" / "best.msgpack", "dense"),
    "precond_net_v2": ("PreconditionerNet",
                       CKPT / "checkpoints_v2" / "best.msgpack", "dense"),
    "sparse_unet": ("PreconditionerSparseUNet",
                    CKPT / "checkpoints_unet" / "best.msgpack", "dense"),
    "precond_net_factor": ("PreconditionerNet",
                           CKPT / "checkpoints" / "best.msgpack", "factor"),
}
MODELS = {"PreconditionerNet": PreconditionerNet,
          "PreconditionerSparseUNet": PreconditionerSparseUNet}
OUT = REPO / "tests" / "fixtures" / "torch_port" / "conv_iterations.json"


def main() -> None:
    data_sets = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        rng = np.random.default_rng(SEED)
        for i in range(SAMPLES):
            case = generate_sludge_case(rng, mesh_cells=MESH_CELLS)
            save_case(case, root / "sludge_patterns" / f"case_{i:04d}")
        for name in MODELS:
            data_sets[name] = SludgePatternDataSet(
                stage="test", batch_size=1,
                specs=plan_builder_for(name, CHANNELS),
                shuffle=False, root=root,
            )

    f32 = jnp.float32
    runs = {}
    models = {}
    for run, (model_name, checkpoint, apply) in RUNS.items():
        data_set = data_sets[model_name]
        model = MODELS[model_name](channels=CHANNELS)
        params = load_checkpoint(checkpoint)["params"]
        suite = BenchmarkSuite(data_set, model, params,
                               techniques=("learned",), kappa_cases=0,
                               learned_apply=apply)
        n_pad = data_set.dof_pad
        iterations, success = [], []
        for index in range(len(data_set)):
            batch = data_set[index]
            a_sp, rhs, n0 = suite._reconstruct(index)
            ell = ELLMatrix.from_scipy(a_sp, n_pad=n_pad, dtype=f32)
            b = np.zeros(n_pad)
            b[:n0] = rhs
            n0_dev = jnp.int32(n0)
            if apply == "factor":
                vals = _learned_factor_values(
                    model, suite.params, batch.features, batch.plans,
                    batch.scales, n0_dev, dtype=f32)
                apply_m = factor_normal_apply
                m_data = (suite._learned_plan(batch, ell), vals)
            else:
                apply_m = dense_matvec
                m_data, _ = _learned_setup_device(
                    model, suite.params, batch.features, batch.plans,
                    batch.scales, n0_dev, dtype=f32)
            res = preconditioned_conjugate_gradient(
                ell_matvec, ell, jnp.asarray(b, f32), apply_m, m_data,
                rtol=suite.rtol, max_iter=suite.max_iter,
                check_every=suite.check_every,
            )
            iterations.append(int(res.iterations))
            success.append(bool(float(res.residual) < suite.rtol))
        runs[run] = {
            "model": model_name,
            "checkpoint": str(checkpoint.relative_to(REPO)),
            "learned_apply": apply,
            "mean_iterations": float(np.mean(iterations)),
            "iterations": iterations,
            "success": success,
        }
        models[model_name] = {
            "nnz0_pad": data_set.nnz0_pad,
            "level_buckets": list(data_set._level_buckets),
            "final_widths": list(suite._learned_widths()),
        }
        print(run, runs[run]["mean_iterations"], flush=True)

    data_set = data_sets["PreconditionerNet"]
    out = {
        "what": "per-case PCG iterations of the JAX reference's conv "
                "models, CPU float32",
        "seed": SEED,
        "samples": SAMPLES,
        "mesh_cells": MESH_CELLS,
        "split": "test",
        "cases": len(data_set),
        "n_pad": data_set.dof_pad,
        "channels": list(CHANNELS),
        "native_plans": native.available(),
        "check_every": 8,
        "rtol": 1e-8,
        "max_iter": 1024,
        "models": models,
        "runs": runs,
    }
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    main()
