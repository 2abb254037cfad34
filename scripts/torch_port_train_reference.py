"""Reference run of one flagship NeuralFSAI training epoch, for the port.

    JAX_PLATFORMS=cpu python scripts/torch_port_train_reference.py

Runs the JAX package on the CPU in float32, step for step as
``train/trainer.py::train_neural_fsai`` does for one epoch, with the
flagship configuration of ``scripts/train_fsai.py`` and ``params.yaml``:
the train split of the 500 sludge-pattern cases generated from seed
69420 at ``mesh_cells`` 2 (written to a temporary folder, read back by
``SludgePatternDataSet``, shuffled with seed 69), batches of 4 (95 train,
5 validate), ``FSAIPlanProvider(power=4, width=24)``,
``NeuralFSAI(width=24, hidden=64, poly_degree=2)`` initialized with
``PRNGKey(69)``, ``pcg_loss`` over 16 steps, ``optax.adam(1e-4)``.  It
validates the held-out batches before and after the epoch.

Writes ``tests/fixtures/torch_port/train_init.msgpack`` (the init params
as a checkpoint payload, ``flax.serialization.to_bytes``) and
``tests/fixtures/torch_port/train_epoch.json`` (the split and the
configuration, the per-step losses, and the validation losses and
per-case iterations at init and after the epoch).  About 3 minutes on 8
CPU cores.
"""

import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import flax.serialization  # noqa: E402
import optax  # noqa: E402

from deeppreconditioning_tpu.data.datasets import (  # noqa: E402
    SludgePatternDataSet,
)
from deeppreconditioning_tpu.data.fvm import (  # noqa: E402
    generate_sludge_case,
    save_case,
)
from deeppreconditioning_tpu.models import (  # noqa: E402
    FSAIPlanProvider,
    NeuralFSAI,
    plan_builder_for,
)
from deeppreconditioning_tpu.train.trainer import (  # noqa: E402
    TrainState,
    _fsai_operands,
    _fsai_validate_device,
    fsai_train_step,
)

FIXTURES = REPO / "tests" / "fixtures" / "torch_port"
SEED = 69420  # bench.py's data seed
SAMPLES, MESH_CELLS = 500, 2
CONFIG = {"batch_size": 4, "width": 24, "hidden": 64, "poly_degree": 2,
          "power": 4, "range_h": 256, "loss": "pcg_loss", "pcg_steps": 16,
          "learning_rate": 1e-4, "select_by": "iterations", "seed": 69}


def validate(model, params, val_set, provider):
    losses, iters = [], []
    for i in range(len(val_set)):
        batch = val_set[i]
        plans = provider(i, batch)
        vl, vi = _fsai_validate_device(
            model, params, plans, batch.features[:, :, 0],
            batch.systems.to_dense(), batch.right_hand_sides)
        losses.append(float(vl))
        iters.extend(int(x) for x in np.asarray(vi))
    return {"val_losses": losses, "val_loss": float(np.mean(losses)),
            "iterations": iters}


def main() -> None:
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        rng = np.random.default_rng(SEED)
        for i in range(SAMPLES):
            save_case(generate_sludge_case(rng, mesh_cells=MESH_CELLS),
                      root / "sludge_patterns" / f"case_{i:04d}")
        full = SludgePatternDataSet(
            stage="train", batch_size=CONFIG["batch_size"],
            specs=plan_builder_for("NeuralFSAI", None), root=root,
            seed=CONFIG["seed"])
    n_batches = len(full)
    n_val = max(1, n_batches * 5 // 100)
    train = list(range(n_batches - n_val))
    val = [full[i] for i in range(n_batches - n_val, n_batches)]
    provider = FSAIPlanProvider(full, power=CONFIG["power"],
                                width=CONFIG["width"],
                                range_h=CONFIG["range_h"])
    model = NeuralFSAI(width=CONFIG["width"], hidden=CONFIG["hidden"],
                       poly_degree=CONFIG["poly_degree"])
    tx = optax.adam(CONFIG["learning_rate"])

    batch0 = full[train[0]]
    plans0 = provider(0, batch0)
    operand0 = _fsai_operands(plans0, batch0.features[:, :, 0],
                              batch0.systems.to_dense())[0]
    params = model.init(jax.random.PRNGKey(CONFIG["seed"]),
                        jax.tree.map(lambda x: x[0], plans0), operand0)
    FIXTURES.mkdir(parents=True, exist_ok=True)
    (FIXTURES / "train_init.msgpack").write_bytes(flax.serialization.to_bytes(
        {"params": params, "width": CONFIG["width"],
         "hidden": CONFIG["hidden"], "poly_degree": CONFIG["poly_degree"],
         "power": CONFIG["power"]}))
    print(f"data and init: {time.perf_counter() - t0:.1f} s, plan kind "
          f"{provider.kind}", flush=True)

    init = validate(model, params, val, provider)
    print(f"init validation: {init}", flush=True)
    state = TrainState(params, tx.init(params), jax.numpy.int32(0))
    losses = []
    for step, i in enumerate(train):
        batch = full[i]
        plans = provider(i, batch)
        state, loss = fsai_train_step(
            model, tx, state, plans, batch.features[:, :, 0],
            batch.systems.to_dense(), batch.right_hand_sides,
            CONFIG["loss"], CONFIG["pcg_steps"])
        losses.append(float(loss))
        if step % 10 == 0:
            print(f"step {step}: loss {losses[-1]:.6f} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
    epoch = validate(model, state.params, val, provider)
    print(f"epoch validation: {epoch}", flush=True)
    out = {
        "seed": SEED, "cases": SAMPLES, "mesh_cells": MESH_CELLS,
        "stage": "train", "split_cases": n_batches * CONFIG["batch_size"],
        "n_pad": int(full.dof_pad), "nnz0_pad": int(full.nnz0_pad),
        "train_batches": len(train), "val_batches": n_val,
        "plan_kind": provider.kind, "config": CONFIG,
        "platform": "JAX CPU float32",
        "step_losses": losses, "train_loss": float(np.mean(losses)),
        "init": init, "epoch": epoch,
    }
    (FIXTURES / "train_epoch.json").write_text(json.dumps(out, indent=1)
                                               + "\n")
    print(f"wrote the fixtures in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
