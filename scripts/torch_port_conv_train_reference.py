"""Reference run of one training epoch of the conv models, for the port.

    JAX_PLATFORMS=cpu python scripts/torch_port_conv_train_reference.py

Runs the JAX package on the CPU in float32, step for step as
``train/trainer.py::train`` does for one epoch, for ``PreconditionerNet``
and ``PreconditionerSparseUNet`` at ``params.yaml``'s channels
(1, 16, 32, 64, 32, 16, 1): the train split of the 500 sludge-pattern
cases generated from seed 69420 at ``mesh_cells`` 2 (written to a
temporary folder, read back by ``SludgePatternDataSet`` with the model's
``plan_builder_for`` specs, shuffled with seed 69), batches of 4 (95
train, 5 validate), the model initialized with ``PRNGKey(69)``,
``inverse_loss``, ``optax.adam(1e-3)`` at a constant rate.  After the
epoch it validates the held-out batches as ``validate`` does (the
inverse loss and the batched dense PCG with M = L L^T, at most 1024
iterations).

Writes ``tests/fixtures/torch_port/conv_train_init_precond_net.msgpack``
and ``conv_train_init_unet.msgpack`` (the init params as a checkpoint
payload with the channels, ``flax.serialization.to_bytes``) and
``conv_train_epoch.json``: the split (the shuffled case order), the
configuration, ``n_pad``, ``nnz0_pad``, per model the level buckets, the
per-step losses, and the validation losses and per-case iterations after
the epoch.  It took 137 s wall on 8 CPU cores (4.4 s of it the data,
13.7 s the plans of both models).
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

from deeppreconditioning_tpu import native  # noqa: E402
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
from deeppreconditioning_tpu.train.trainer import (  # noqa: E402
    TrainState,
    _validate_device,
    train_step,
)

FIXTURES = REPO / "tests" / "fixtures" / "torch_port"
SEED = 69420  # bench.py's data seed
SAMPLES, MESH_CELLS = 500, 2
CHANNELS = (1, 16, 32, 64, 32, 16, 1)
CONFIG = {"batch_size": 4, "channels": list(CHANNELS),
          "loss": "inverse_loss", "learning_rate": 1e-3,
          "schedule": "constant", "select_by": "loss", "seed": 69,
          "max_iter": 1024}
MODELS = {"PreconditionerNet": (PreconditionerNet, "precond_net"),
          "PreconditionerSparseUNet": (PreconditionerSparseUNet, "unet")}


def one_epoch(name, full, t0):
    cls, tag = MODELS[name]
    n_batches = len(full)
    n_val = max(1, n_batches * 5 // 100)
    train = range(n_batches - n_val)
    val = range(n_batches - n_val, n_batches)
    model = cls(channels=CHANNELS)
    tx = optax.adam(CONFIG["learning_rate"])
    batch0 = full[0]
    sample_plans = [jax.tree.map(lambda x: x[0], p) for p in batch0.plans]
    params = model.init(jax.random.PRNGKey(CONFIG["seed"]),
                        batch0.features[0], sample_plans)
    (FIXTURES / f"conv_train_init_{tag}.msgpack").write_bytes(
        flax.serialization.to_bytes({"params": params,
                                     "channels": list(CHANNELS)}))
    state = TrainState(params, tx.init(params), jax.numpy.int32(0))
    losses = []
    for step, i in enumerate(train):
        state, loss = train_step(model, tx, state, full[i], CONFIG["loss"])
        losses.append(float(loss))
        if step % 10 == 0:
            print(f"{name} step {step}: loss {losses[-1]:.6f} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
    val_losses, iterations = [], []
    for i in val:
        loss, its = _validate_device(model, state.params, full[i],
                                     max_iter=CONFIG["max_iter"])
        val_losses.append(float(loss))
        iterations.extend(int(x) for x in np.asarray(its))
    record = {
        "level_buckets": [int(b) for b in full._level_buckets],
        "step_losses": losses, "train_loss": float(np.mean(losses)),
        "val_losses": val_losses, "val_loss": float(np.mean(val_losses)),
        "val_iterations": iterations,
        "val_mean_iterations": float(np.mean(iterations)),
    }
    print(f"{name}: train loss {record['train_loss']:.6f} val loss "
          f"{record['val_loss']:.6f} val iterations "
          f"{record['val_mean_iterations']:.3f} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return record


def main() -> None:
    t0 = time.perf_counter()
    FIXTURES.mkdir(parents=True, exist_ok=True)
    data_sets = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        rng = np.random.default_rng(SEED)
        for i in range(SAMPLES):
            save_case(generate_sludge_case(rng, mesh_cells=MESH_CELLS),
                      root / "sludge_patterns" / f"case_{i:04d}")
        data_s = time.perf_counter() - t0
        for name in MODELS:
            data_sets[name] = SludgePatternDataSet(
                stage="train", batch_size=CONFIG["batch_size"],
                specs=plan_builder_for(name, CHANNELS), root=root,
                seed=CONFIG["seed"])
    full = data_sets["PreconditionerNet"]
    order = [int(f.name.split("_")[1]) for f in full.folders]
    assert order == [int(f.name.split("_")[1])
                     for f in data_sets["PreconditionerSparseUNet"].folders]
    n_batches = len(full)
    n_val = max(1, n_batches * 5 // 100)
    print(f"data {data_s:.1f} s, plans {time.perf_counter() - t0:.1f} s",
          flush=True)
    models = {name: one_epoch(name, data_sets[name], t0) for name in MODELS}
    out = {
        "seed": SEED, "cases": SAMPLES, "mesh_cells": MESH_CELLS,
        "stage": "train", "order": order,
        "split_cases": n_batches * CONFIG["batch_size"],
        "n_pad": int(full.dof_pad), "nnz0_pad": int(full.nnz0_pad),
        "train_batches": n_batches - n_val, "val_batches": n_val,
        "config": CONFIG, "native_plans": native.available(),
        "platform": "JAX CPU float32", "models": models,
    }
    (FIXTURES / "conv_train_epoch.json").write_text(json.dumps(out, indent=1)
                                                    + "\n")
    print(f"wrote the fixtures in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
