"""Data-parallel epochs of the JAX reference's trainers
(``deeppreconditioning_tpu/train/trainer.py``'s ``train`` and
``train_neural_fsai`` with ``mesh=``) for the PyTorch port.

Runs on the CPU over the 8-device virtual mesh the tests use
(``--xla_force_host_platform_device_count=8``, float64 enabled, as
``tests/conftest.py`` sets them), at ``tests/test_dp_training.py``'s
sizes: ``RandomSPDDataSet`` dof 24, batch 8, sparsity 0.8, 20 systems
unshuffled (train batch 0 trains, train batch 1 validates), three epochs
at patience 10.  The batches are widened to float64 (every float leaf);
the parameters stay float32 (Flax's ``param_dtype``), so the weights
round to float32 after every update.  In float32 the NeuralFSAI run's
second step is NaN on both mesh sizes (its first ``pcg_loss`` is -19.8,
the log of a residual at float32's floor), so the float32 epochs hold
nothing there:

* ``conv``: ``PreconditionerNet`` channels (1, 4, 4, 4, 1), data seed 0,
  ``inverse_loss``, lr 1e-3, init ``PRNGKey(0)``;
* ``fsai``: ``NeuralFSAI`` width 24, hidden 8 (degree 1), data seed 1,
  ``FSAIPlanProvider(power=2, width=24)`` ("auto" kind), ``pcg_loss``
  over 4 steps, lr 1e-4, init ``PRNGKey(1)``.

Each family trains on a mesh of 2 and of 3 devices (batch 8 on 3
devices is not divisible: ``dp_shard`` then replicates it, and the step
is still the global batch's).  Both sides start from the JAX init,
written as ``dp_<family>_init.msgpack`` (``{"params": ...}``, the port
reads it as ``init_from``).  Keeps, per run, the ``metrics.jsonl``
series (train loss, validation loss and mean iterations per epoch), the
step count and the final parameters (float32 values, as nested lists).

Writes ``tests/fixtures/torch_port/dp_train.json`` and the two init
checkpoints (about 1.5 minutes).

    JAX_PLATFORMS=cpu python scripts/torch_port_dp_reference.py
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
from pathlib import Path

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import numpy as np  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import flax.serialization  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from deeppreconditioning_tpu.data.datasets import (  # noqa: E402
    RandomSPDDataSet,
)
from deeppreconditioning_tpu.models import (  # noqa: E402
    FSAIPlanProvider,
    NeuralFSAI,
    PreconditionerNet,
    precond_net_specs,
)
from deeppreconditioning_tpu.train.trainer import (  # noqa: E402
    _fsai_operands,
    train,
    train_neural_fsai,
)

FIXTURES = REPO / "tests" / "fixtures" / "torch_port"
WORLDS = (2, 3)
CONFIG = {
    "dof": 24, "batch_size": 8, "sparsity": 0.8, "length": 20,
    "epochs": 3, "patience": 10,
    "conv": {"channels": [1, 4, 4, 4, 1], "data_seed": 0, "seed": 0,
             "loss": "inverse_loss", "learning_rate": 1e-3},
    "fsai": {"width": 24, "hidden": 8, "poly_degree": 1, "power": 2,
             "data_seed": 1, "seed": 1, "loss": "pcg_loss", "pcg_steps": 4,
             "learning_rate": 1e-4},
}


class View:
    """Batches ``indices`` of a data set, renumbered from 0, with every
    float leaf in float64, built once per batch (the plan provider keys
    on the batch's identity)."""

    def __init__(self, base, indices):
        self.base, self.indices = base, list(indices)
        self.batch_size = base.batch_size
        self._cache = {}

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        if i not in self._cache:
            b = self.base[self.indices[i]]
            f64 = jnp.float64
            self._cache[i] = b._replace(
                features=b.features.astype(f64),
                systems=b.systems.replace(
                    values=b.systems.values.astype(f64)),
                solutions=b.solutions.astype(f64),
                right_hand_sides=b.right_hand_sides.astype(f64),
                scales=b.scales.astype(f64))
        return self._cache[i]


def data_set(specs, seed):
    return RandomSPDDataSet(
        "train", dof=CONFIG["dof"], batch_size=CONFIG["batch_size"],
        specs=specs, sparsity=CONFIG["sparsity"], length=CONFIG["length"],
        seed=seed, shuffle=False)


def series(metrics_dir: Path) -> dict:
    out = {"train_loss": [], "val_loss": [], "val_iterations": []}
    names = {"train/loss/inverse": "train_loss",
             "val/loss/inverse": "val_loss",
             "val/metric/iterations": "val_iterations"}
    for line in (metrics_dir / "metrics.jsonl").read_text().splitlines():
        record = json.loads(line)
        if record["name"] in names:
            out[names[record["name"]]].append(record["value"])
    return out


def as_lists(tree):
    return jax.tree.map(lambda x: np.asarray(x).tolist(), tree)


def run_family(family: str, tmp: Path) -> dict:
    cfg = CONFIG[family]
    common = dict(max_epochs=CONFIG["epochs"], patience=CONFIG["patience"],
                  seed=cfg["seed"], loss=cfg["loss"],
                  learning_rate=cfg["learning_rate"])
    if family == "conv":
        ds = data_set(precond_net_specs(tuple(cfg["channels"])),
                      cfg["data_seed"])
        model = PreconditionerNet(channels=tuple(cfg["channels"]))
        batch0 = ds[0]
        sample_plans = [jax.tree.map(lambda x: x[0], p)
                        for p in batch0.plans]
        params = model.init(jax.random.PRNGKey(cfg["seed"]),
                            batch0.features[0], sample_plans)

        def trainer(mesh, init, out):
            return train(model, View(ds, range(1)), View(ds, range(1, 2)),
                         checkpoint_dir=out / "ckpt",
                         metrics_dir=out / "metrics", init_from=init,
                         mesh=mesh, **common)
    else:
        ds = data_set(precond_net_specs((1, 1, 1)), cfg["data_seed"])
        model = NeuralFSAI(width=cfg["width"], hidden=cfg["hidden"],
                           poly_degree=cfg["poly_degree"])
        plans0 = FSAIPlanProvider(ds, power=cfg["power"],
                                  width=cfg["width"])(0, ds[0])
        batch0 = ds[0]
        params = model.init(
            jax.random.PRNGKey(cfg["seed"]),
            jax.tree.map(lambda x: x[0], plans0),
            _fsai_operands(plans0, batch0.features[:, :, 0],
                           batch0.systems.to_dense())[0])

        def trainer(mesh, init, out):
            provider = FSAIPlanProvider(ds, power=cfg["power"],
                                        width=cfg["width"])
            state = train_neural_fsai(
                model, View(ds, range(1)), View(ds, range(1, 2)), provider,
                checkpoint_dir=out / "ckpt", metrics_dir=out / "metrics",
                init_from=init, mesh=mesh, pcg_steps=cfg["pcg_steps"],
                **common)
            trainer.kind = provider.kind
            return state

    init = FIXTURES / f"dp_{family}_init.msgpack"
    init.write_bytes(flax.serialization.to_bytes({"params": params}))
    runs = {}
    for k in WORLDS:
        out = tmp / f"{family}{k}"
        mesh = Mesh(np.array(jax.devices()[:k]), ("dp",))
        state = trainer(mesh, init, out)
        runs[str(k)] = {**series(out / "metrics"), "step": int(state.step),
                        "params": as_lists(jax.device_get(state.params))}
        print(family, k, runs[str(k)]["train_loss"],
              runs[str(k)]["val_iterations"], flush=True)
    result = {"n_pad": int(ds.dof_pad), "nnz0_pad": int(ds.nnz0_pad),
              "runs": runs}
    if family == "fsai":
        result["plan_kind"] = trainer.kind
    return result


def main() -> None:
    assert len(jax.devices()) >= max(WORLDS)
    with tempfile.TemporaryDirectory() as tmp:
        out = {"config": CONFIG, "worlds": list(WORLDS),
               "conv": run_family("conv", Path(tmp)),
               "fsai": run_family("fsai", Path(tmp))}
    path = FIXTURES / "dp_train.json"
    path.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
