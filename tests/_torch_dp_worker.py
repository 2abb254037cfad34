"""One rank of the PyTorch port's data-parallel trainer on the CPU over
gloo.

Spawned by ``tests/test_torch_dp_training.py`` with the env://
variables (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``)
and ``OUT`` (a folder).  In float64, from the JAX init checkpoints of
``scripts/torch_port_dp_reference.py``, on ``RandomSPDDataSet`` batches
of 8 systems of dof 24 (sparsity 0.8, 20 systems unshuffled; batch 0
trains, batch 1 validates):

* ``jax``: the fixture's two runs (``PreconditionerNet`` (1, 4, 4, 4, 1)
  with ``inverse_loss``, ``NeuralFSAI`` width 24, hidden 8 with
  ``pcg_loss`` over 4 steps), three epochs each through ``train`` /
  ``train_neural_fsai`` with ``world``;
* ``losses``: every loss (the conv family's five over two epochs, two
  steps, the second showing the generator state ``hutchinson_trace``
  leaves; the NeuralFSAI family's three over one) with ``world``, and in
  the world of 3 on rank 0 the same without it (one device, the whole
  batch: the reference of both worlds);
* ``empty`` (world 3 only): batches of 2, so rank 2's share is empty,
  one epoch of each family with ``world`` and, on rank 0, without;
* ``dryrun`` (world 2 only): ``python -m deeppreconditioning_tpu_torch.
  dryrun``'s ``main`` in the world this process is in.

Each rank checkpoints and logs into a folder of its own.  Every rank
writes ``rank<r>.json`` (its step losses, plan kinds, and the files in
its folders); rank 0 also writes ``runs.json`` (each run's records) and
``params.npz`` (each run's final parameters, and the gradients of its
last step, in the reference's tree, flattened to ``run/path`` and
``run/grad/path`` keys).  Imports no JAX.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from deeppreconditioning_tpu_torch.data.datasets import (  # noqa: E402
    RandomSPDDataSet,
)
from deeppreconditioning_tpu_torch.models import (  # noqa: E402
    PreconditionerNet,
    conv_params_to_jax,
    precond_net_specs,
)
from deeppreconditioning_tpu_torch.models import neural_fsai as nf  # noqa
from deeppreconditioning_tpu_torch.parallel import multihost  # noqa: E402
from deeppreconditioning_tpu_torch.train import trainer  # noqa: E402
from deeppreconditioning_tpu_torch.train.__main__ import (  # noqa: E402
    SubsetView,
)

FIXTURES = REPO / "tests" / "fixtures" / "torch_port"
CONFIG = json.loads((FIXTURES / "dp_train.json").read_text())["config"]
CONV_LOSSES = trainer.CONV_LOSSES
FSAI_LOSSES = trainer.FSAI_LOSSES
DEV = torch.device("cpu")


def data_set(family: str, batch_size: int = CONFIG["batch_size"]):
    cfg = CONFIG[family]
    channels = cfg["channels"] if family == "conv" else (1, 1, 1)
    return RandomSPDDataSet(
        "train", dof=CONFIG["dof"], batch_size=batch_size,
        specs=precond_net_specs(tuple(channels)), sparsity=CONFIG["sparsity"],
        length=CONFIG["length"], seed=cfg["data_seed"], shuffle=False,
        dtype=torch.float64)


def train_run(family: str, ds, world, out: Path, loss: str, epochs: int):
    """One run of ``family``'s trainer from the JAX init -> (state, plan
    kind or None).  The NeuralFSAI runs of one data set share its plan
    provider (its plans are the data set's; the kind settles once)."""
    cfg = CONFIG[family]
    kw = dict(learning_rate=cfg["learning_rate"], max_epochs=epochs,
              patience=CONFIG["patience"], seed=cfg["seed"], loss=loss,
              checkpoint_dir=out / "ckpt", metrics_dir=out / "metrics",
              init_from=FIXTURES / f"dp_{family}_init.msgpack", world=world)
    train_set, val_set = SubsetView(ds, range(1)), SubsetView(ds, range(1, 2))
    if family == "conv":
        model = PreconditionerNet(channels=tuple(cfg["channels"])).double()
        return trainer.train(model, train_set, val_set, **kw), None
    model = nf.NeuralFSAI(cfg["width"], cfg["hidden"],
                          cfg["poly_degree"]).double()
    if not hasattr(ds, "provider"):
        ds.provider = nf.FSAIPlanProvider(ds, power=cfg["power"],
                                          width=cfg["width"])
    provider = ds.provider
    state = trainer.train_neural_fsai(model, train_set, val_set, provider,
                                      pcg_steps=cfg["pcg_steps"], **kw)
    return state, provider.kind


def flat_params(model, prefix: str) -> dict:
    """The parameters and their last gradients (zeros where none) in the
    reference's tree, flattened."""
    to_jax = (conv_params_to_jax if isinstance(model, PreconditionerNet)
              else nf.params_to_jax)
    grads = {name: torch.zeros_like(p) if p.grad is None else p.grad
             for name, p in model.named_parameters()}
    out = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for key, value in tree.items():
                walk(value, f"{path}/{key}")
        else:
            out[path] = np.asarray(tree)

    walk(to_jax(model.state_dict()), prefix)
    walk(to_jax(grads), f"{prefix}/grad")
    return out


def record(state) -> dict:
    return {"step": state.step,
            "step_losses": [e["step_losses"] for e in state.epochs],
            "val_loss": [e["val_loss"] for e in state.epochs],
            "val_iterations": [e["val_mean_iterations"]
                               for e in state.epochs],
            "allreduce_ms": [e["allreduce_ms"] for e in state.epochs]}


def main() -> None:
    torch.set_num_threads(1)
    out = Path(os.environ["OUT"])
    assert multihost.initialize_if_needed(DEV)
    world = multihost.train_world(DEV)
    lead = world.rank == 0
    mine = {"kinds": {}, "step_losses": {}, "wrote": {}}
    runs, params = {}, {}

    def go(name, family, ds, loss, epochs, single):
        folder = out / name / f"rank{world.rank}"
        state, kind = train_run(family, ds, world, folder, loss, epochs)
        mine["step_losses"][name] = record(state)["step_losses"]
        mine["kinds"][name] = kind
        if lead:
            runs[name] = record(state)
            params.update(flat_params(state.model, name))
            if single:
                state, _ = train_run(family, ds, None, out / f"{name}_one",
                                     loss, epochs)
                runs[f"{name}/one"] = record(state)
                params.update(flat_params(state.model, f"{name}/one"))
        mine["wrote"][name] = sorted(
            str(p.relative_to(folder)) for p in folder.rglob("*")
            if p.is_file())

    sets = {family: data_set(family) for family in ("conv", "fsai")}
    for family in ("conv", "fsai"):
        go(f"jax/{family}", family, sets[family], CONFIG[family]["loss"],
           CONFIG["epochs"], single=False)
    for family, losses, epochs in (("conv", CONV_LOSSES, 2),
                                   ("fsai", FSAI_LOSSES, 1)):
        for loss in losses:
            go(f"losses/{family}/{loss}", family, sets[family], loss, epochs,
               single=world.size == 3)
    if world.size == 3:
        for family in ("conv", "fsai"):
            go(f"empty/{family}", family, data_set(family, batch_size=2),
               CONFIG[family]["loss"], 1, single=True)
    if world.size == 2:
        from deeppreconditioning_tpu_torch import dryrun

        result = dryrun.main(["--device", "cpu"])
        if lead:
            (out / "dryrun.json").write_text(json.dumps(result))
    out.mkdir(parents=True, exist_ok=True)
    (out / f"rank{world.rank}.json").write_text(json.dumps(mine))
    if lead:
        (out / "runs.json").write_text(json.dumps(runs))
        np.savez(out / "params.npz", **params)
    multihost.shutdown()


if __name__ == "__main__":
    main()
