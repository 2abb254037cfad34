"""Per-case PCG iteration counts of the JAX reference on the frames split.

Runs the JAX package on the CPU in float32 (the port's dtype on the card)
over the frame-structure test split of ``scripts/frames_bench.py``: 200
cases from ``default_rng(69422)`` (``data/frames.generate_frame_case``),
the last 40, FSAI pattern power 2, and the frames NeuralFSAI checkpoint
(``assets/checkpoints_frames/best.msgpack``: width 41, degree 2, power 2)
for vanilla, jacobi, fsai and learned.  It calls the suite's device
setups (``_fsai_range_setup_device`` or ``_fsai_setup_device`` for a case
whose pattern does not fit the range plan, ``_neural_fsai_setup_device``)
and ``preconditioned_conjugate_gradient`` directly, with no timing.

Writes ``tests/fixtures/torch_port/frames_iterations.json``: the per-case
iterations and success flags, the seed, ``n_pad``, the static widths, the
range height ``H`` and which cases took the generic plan.  The PyTorch
port's ``chip_smoke.py`` holds its own counts on the GPU against this
file.

    JAX_PLATFORMS=cpu python scripts/torch_port_frames_reference.py
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
from deeppreconditioning_tpu.data.frames import (  # noqa: E402
    generate_frame_case,
)
from deeppreconditioning_tpu.data.fvm import save_case  # noqa: E402
from deeppreconditioning_tpu.models import (  # noqa: E402
    NeuralFSAI,
    plan_builder_for,
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

SEED = 69422
SAMPLES = 200
FSAI_POWER = 2
FAMILY = "frame_structures"
TECHNIQUES = ("vanilla", "jacobi", "fsai", "learned")
CHECKPOINT = REPO / "assets" / "checkpoints_frames" / "best.msgpack"
OUT = REPO / "tests" / "fixtures" / "torch_port" / "frames_iterations.json"


def main() -> None:
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        rng = np.random.default_rng(SEED)
        for i in range(SAMPLES):
            save_case(generate_frame_case(rng),
                      root / FAMILY / f"case_{i:04d}")
        data_set = SludgePatternDataSet(
            stage="test", batch_size=1,
            specs=plan_builder_for("NeuralFSAI", None),
            shuffle=False, root=root, family=FAMILY,
        )

    payload = load_checkpoint(CHECKPOINT)
    model = NeuralFSAI(
        width=int(payload["width"]),
        hidden=int(payload.get("hidden", 64)),
        poly_degree=int(payload.get("poly_degree", 1)),
    )
    params = payload["params"]
    power = int(payload.get("power", FSAI_POWER))
    # the suite here only supplies its host helpers (reconstruction,
    # dataset-global pattern metadata, per-case plans)
    suite = BenchmarkSuite(
        data_set, model, params, techniques=TECHNIQUES, kappa_cases=0,
        fsai_power=FSAI_POWER, learned_power=power,
    )
    n_pad = data_set.dof_pad
    f32 = jnp.float32
    iterations = {t: [] for t in TECHNIQUES}
    success = {t: [] for t in TECHNIQUES}
    generic = {"fsai": [], "learned": []}
    for index in range(len(data_set)):
        batch = data_set[index]
        a_sp, rhs, n0 = suite._reconstruct(index)
        ell = ELLMatrix.from_scipy(a_sp, n_pad=n_pad, dtype=f32)
        b = np.zeros(n_pad)
        b[:n0] = rhs
        b = jnp.asarray(b, f32)
        n0_dev = jnp.int32(n0)
        d = np.zeros(n_pad)
        d[:n0] = jacobi_preconditioner(a_sp)
        kind_f, plan_f, op_f, sc_f = suite._fsai_plan(index, batch, ell)
        kind_l, plan_l, op_l, sc_l = suite._fsai_plan(
            index, batch, ell, width=model.width, power=power
        )
        fsai_setup = (_fsai_range_setup_device if kind_f == "range"
                      else _fsai_setup_device)
        for name, kind in (("fsai", kind_f), ("learned", kind_l)):
            if kind == "generic":
                generic[name].append(index)
        setups = {
            "vanilla": (identity_apply, None),
            "jacobi": (_diag_apply, jnp.asarray(d, f32)),
            "fsai": (dense_matvec, fsai_setup(
                plan_f, op_f, sc_f, n0_dev, dtype=f32)),
            "learned": (dense_matvec, _neural_fsai_setup_device(
                model, params, plan_l, op_l, sc_l, n0_dev, dtype=f32)),
        }
        for name, (apply_m, m_data) in setups.items():
            res = preconditioned_conjugate_gradient(
                ell_matvec, ell, b, apply_m, m_data,
                rtol=suite.rtol, max_iter=suite.max_iter,
                check_every=suite.check_every,
            )
            iterations[name].append(int(res.iterations))
            success[name].append(bool(float(res.residual) < suite.rtol))

    widths = {
        "fsai": suite._fsai_meta(n_pad, FSAI_POWER)[0],
        "learned": model.width,
    }
    out = {
        "what": "per-case PCG iterations of the JAX reference on the "
                "frames split, CPU float32",
        "seed": SEED,
        "samples": SAMPLES,
        "family": FAMILY,
        "split": "test",
        "cases": len(data_set),
        "n_pad": n_pad,
        "widths": widths,
        "range_h": suite._fsai_meta(n_pad, FSAI_POWER)[1],
        "fsai_power": FSAI_POWER,
        "learned_power": power,
        "check_every": suite.check_every,
        "rtol": suite.rtol,
        "max_iter": suite.max_iter,
        "generic_cases": generic,
        "mean_iterations": {
            t: float(np.mean(v)) for t, v in iterations.items()
        },
        "iterations": iterations,
        "success": success,
    }
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps({"mean_iterations": out["mean_iterations"],
                      "generic_cases": generic, "widths": widths}))


if __name__ == "__main__":
    main()
