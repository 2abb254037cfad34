"""The port's train stage.

    python -m deeppreconditioning_tpu_torch.train [--model NAME]
        [--device cpu] [--max-epochs N] [--dp N] ...
    torchrun --nproc-per-node N -m deeppreconditioning_tpu_torch.train \
        --dp N ...

Counterpart of ``scripts/train.py`` (``--device cpu`` is the explicit
CPU request, and without it the run needs the card).  ``--model``
(default ``params.yaml``'s ``model``, NeuralFSAI) picks the family, as
the reference script does.

``--dp N`` trains data-parallel over N ranks, for either family, as the
reference scripts' ``--dp`` does over N devices: 0 (the default) starts
no process group; N >= 1 reads the env:// variables ``torchrun
--nproc-per-node N`` sets (their ``WORLD_SIZE`` must be N), or, with
none set and N = 1, starts a group of this process alone.  Each rank
takes the card of its ``LOCAL_RANK`` (NCCL; gloo with ``--device
cpu``), its share of every batch, and the global batch's step
(``parallel/data_parallel``); rank 0 alone prints, logs and writes the
checkpoints.  The group is destroyed at the end.

``--model PreconditionerNet`` or ``PreconditionerSparseUNet`` trains a
conv model (``trainer.train``) with the reference script's flags:
``--max-epochs N``, ``--dp N``, ``--loss NAME`` (default ``params.loss``),
``--select-by loss|iterations``, ``--lr LR`` (default
``params.learning_rate``), ``--checkpoint-dir DIR``, ``--metrics-dir
DIR``, ``--init-from CKPT``; and the port's ``--device``, ``--family``
and ``--data-root``.  The model has
``params.channels``, the data set is ``params.data`` (the sludge-pattern
cases as ``PlannedDataSet``, or ``StAnDataSet``) with
``plan_builder_for(model, params.channels)``'s plans, the rate schedule
``params.schedule``, the patience ``params.patience``.  Checkpoints go to
``assets/results/torch/train/<model>/``, metrics to its ``metrics/``.

Without a conv ``--model`` it trains the NeuralFSAI family
(``trainer.train_neural_fsai``), as ``scripts/train_fsai.py`` (without
its ``--platform``): ``[--dp N] [--loss NAME] [--pcg-steps K]
[--width W] [--power P] [--poly-degree D] [--hidden H] [--lr LR]
[--patience N] [--checkpoint-dir DIR] [--metrics-dir DIR] [--select-by
loss|iterations] [--init-from CKPT] [--family F] [--plan-kind
auto|range|generic] [--data-root DIR] [--validate-init]``, with
``fsai_width`` / ``fsai_power`` from ``params.yaml`` and learning rate
``learning_rate / 10``.  Defaults give the flagship: width 24, hidden 64,
polynomial degree 2 (the committed checkpoint's; the script's default
degree is 1), power 4, ``pcg_loss`` over 16 steps, selection by
validation iterations.  Checkpoints go to ``assets/results/torch/train/``,
metrics to its ``metrics/``.

Either family trains the train split of ``number_samples`` cases,
shuffled with ``seed``, in batches of ``batch_size`` (95% train, the last
5% of batches validate), for one epoch unless ``--max-epochs`` says
otherwise (the reference script's default is params.yaml's
``max_epochs``, 200).  The cases are read from ``--data-root``'s
``<family>/case_*`` folders when there are any; otherwise the
sludge-pattern cases are generated in process from seed 69420 at
``mesh_cells``, as bench.py does.  Checkpoints (``latest.msgpack``,
``best.msgpack``) are in Flax's format.  One line per epoch: train loss,
validation loss and mean iterations, epoch seconds and B1 launches.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path
from typing import NamedTuple

import torch

from deeppreconditioning_tpu_torch import _backend
from deeppreconditioning_tpu_torch.config import get_model_class, params_show
from deeppreconditioning_tpu_torch.data.datasets import (
    PlannedDataSet,
    StAnDataSet,
)
from deeppreconditioning_tpu_torch.models import CONV_MODELS, plan_builder_for
from deeppreconditioning_tpu_torch.models.neural_fsai import (
    FSAIPlanProvider,
    NeuralFSAI,
)
from deeppreconditioning_tpu_torch.parallel import multihost
from deeppreconditioning_tpu_torch.train.trainer import (
    CONV_LOSSES,
    FSAI_LOSSES,
    TrainState,
    train,
    train_neural_fsai,
)

REPO = Path(__file__).resolve().parents[2]
RESULTS = REPO / "assets" / "results" / "torch" / "train"
CONV_FAMILIES = tuple(cls.__name__ for cls in CONV_MODELS)


class SubsetView:
    """Batches ``indices`` of a dataset, renumbered from 0."""

    def __init__(self, base, indices) -> None:
        self.base = base
        self.indices = list(indices)
        self.batch_size = base.batch_size

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i: int):
        return self.base[self.indices[i]]

    def share(self, i: int, cases: range):
        """Cases ``cases`` of batch ``i`` (``PlannedDataSet.share``)."""
        return self.base.share(self.indices[i], cases)


def parse_args(argv=None) -> argparse.Namespace:
    params = params_show(REPO / "params.yaml")
    prog = "python -m deeppreconditioning_tpu_torch.train"
    first = argparse.ArgumentParser(prog=prog, add_help=False)
    first.add_argument("--model", default=params.model,
                       choices=("NeuralFSAI",) + CONV_FAMILIES)
    model = first.parse_known_args(argv)[0].model
    parser = argparse.ArgumentParser(prog=prog, parents=[first])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--max-epochs", type=int, default=1,
                        help="epochs (default 1; the reference script's "
                        "default is params.yaml's max_epochs)")
    parser.add_argument("--family", default="sludge_patterns")
    parser.add_argument("--data-root", type=Path,
                        default=REPO / params.data_root)
    parser.add_argument("--init-from", type=Path, default=None,
                        help="start from this checkpoint's params (same "
                        "model settings), with a fresh optimizer")
    parser.add_argument("--dp", type=int, default=0,
                        help="data-parallel ranks (0 = single device, no "
                        "process group; N >= 1 under torchrun "
                        "--nproc-per-node N, or 1 alone)")
    if model in CONV_FAMILIES:
        results = RESULTS / model
        parser.add_argument("--loss", default=params.loss,
                            choices=CONV_LOSSES)
        parser.add_argument("--select-by", default="loss",
                            choices=["loss", "iterations"])
        parser.add_argument("--lr", type=float,
                            default=params.learning_rate)
    else:
        results = RESULTS
        parser.add_argument("--loss", default="pcg_loss",
                            choices=FSAI_LOSSES)
        parser.add_argument("--pcg-steps", type=int, default=16)
        parser.add_argument("--width", type=int, default=params.fsai_width)
        parser.add_argument("--power", type=int, default=params.fsai_power)
        parser.add_argument("--poly-degree", type=int, default=2)
        parser.add_argument("--hidden", type=int, default=64)
        parser.add_argument("--lr", type=float,
                            default=params.learning_rate / 10)
        parser.add_argument("--patience", type=int, default=params.patience)
        parser.add_argument("--select-by", default="iterations",
                            choices=["loss", "iterations"])
        parser.add_argument("--plan-kind", default="auto",
                            choices=["auto", "range", "generic"])
        parser.add_argument("--validate-init", action="store_true",
                            help="also validate the starting parameters")
    parser.add_argument("--checkpoint-dir", type=Path, default=results)
    parser.add_argument("--metrics-dir", type=Path,
                        default=results / "metrics")
    args = parser.parse_args(argv)
    args.params = params
    return args


def _cases(args):
    """None when ``--data-root`` holds the family's case folders, else the
    generated sludge-pattern cases."""
    if any((args.data_root / args.family).glob("case_*")):
        return None
    if args.family != "sludge_patterns":
        raise FileNotFoundError(
            f"no cases under {args.data_root / args.family}")
    from deeppreconditioning_tpu_torch.bench.__main__ import flagship_cases

    return flagship_cases()


def print_epoch(record: dict) -> None:
    if record["epoch"] < 0:
        print(f"init: val loss {record['val_loss']:.6f} val iterations "
              f"{record['val_mean_iterations']:.3f}")
        return
    print(f"epoch {record['epoch']}: train loss {record['train_loss']:.6f} "
          f"val loss {record['val_loss']:.6f} val iterations "
          f"{record['val_mean_iterations']:.3f} {record['seconds']:.2f} s "
          f"B1 launches {record['b1_launches']}", flush=True)


class TrainRun(NamedTuple):
    state: TrainState
    data_set: PlannedDataSet  # the whole train split
    plan_provider: FSAIPlanProvider | None  # NeuralFSAI only
    world: multihost.SolverWorld | None = None  # with --dp N >= 1
    backend: str | None = None  # the process group's, with --dp N >= 1


def _split(full: PlannedDataSet):
    """The 95/5 split at batch granularity: (train view, validation
    view)."""
    n_batches = len(full)
    n_val = max(1, n_batches * 5 // 100)
    return (SubsetView(full, range(n_batches - n_val)),
            SubsetView(full, range(n_batches - n_val, n_batches)))


def _conv_data_set(args, device, cases) -> PlannedDataSet:
    """``params.data``'s train split with the model's conv plans."""
    params = args.params
    specs = plan_builder_for(args.model, params.channels)
    if params.data == "StAnDataSet":
        return StAnDataSet(stage="train", batch_size=params.batch_size,
                           specs=specs, root=args.data_root,
                           seed=params.seed, device=device)
    if params.data != "SludgePatternDataSet":
        raise ValueError(f"the train stage reads no {params.data}")
    if cases is None:
        cases = _cases(args)
    return PlannedDataSet(
        stage="train", batch_size=params.batch_size, root=args.data_root,
        cases=cases, family=args.family, seed=params.seed, device=device,
        specs=specs,
    )


def start_world(dp: int, device: torch.device) -> bool:
    """Start the process group ``--dp`` asks for; returns whether one
    was started.  0: none.  N >= 1: from env:// when ``torchrun`` set
    its variables (``WORLD_SIZE`` must be N), else, for N = 1 only, a
    group of this process alone."""
    if dp < 0:
        raise ValueError(f"--dp {dp}: give 0 (no process group) or the "
                         "number of ranks")
    if dp == 0 or torch.distributed.is_initialized():
        return False
    if all(os.environ.get(k) for k in multihost.ENV_KEYS):
        size = int(os.environ["WORLD_SIZE"])
        if size != dp:
            raise ValueError(f"--dp {dp} in a world of {size} ranks: run "
                             f"torchrun --nproc-per-node {dp}")
        return multihost.initialize_if_needed(device)
    if dp != 1:
        raise ValueError(
            f"--dp {dp} needs {dp} ranks: run torchrun --nproc-per-node "
            f"{dp} (none of {', '.join(multihost.ENV_KEYS)} may be unset)")
    multihost.initialize_single(device)
    return True


def run(args: argparse.Namespace, cases=None) -> TrainRun:
    """Build the split (and the plan provider) and the model on the
    device, and train; ``cases`` (in-memory cases in generation order)
    skips the disk and the generation.  With ``--dp N >= 1`` the
    training runs in a process group of N ranks (``start_world``),
    destroyed at the end if this call started it."""
    dp = args.dp
    if args.device == "cpu":
        device = torch.device("cpu")
    else:
        device = multihost.rank_device("cuda") if dp else _backend.device()
    started = start_world(dp, device)
    try:
        world = None
        if dp:
            if torch.distributed.get_world_size() != dp:
                raise ValueError(f"--dp {dp} in a world of "
                                 f"{torch.distributed.get_world_size()}")
            world = multihost.train_world(device, dp)
        backend = torch.distributed.get_backend() if dp else None
        train_run = _train(args, device, cases, world)
        return train_run._replace(world=world, backend=backend)
    finally:
        if started:
            multihost.shutdown()


def _train(args, device, cases, world) -> TrainRun:
    params = args.params
    lead = world is None or world.rank == 0
    say = print if lead else (lambda *a, **k: None)
    on_epoch = print_epoch if lead else None
    if args.model in CONV_FAMILIES:
        full = _conv_data_set(args, device, cases)
        say(f"{args.model}: {len(full)} batches of {full.batch_size}, "
            f"n_pad {full.dof_pad}, level buckets {full.level_buckets}; "
            f"plans {full.plan_seconds:.2f} s (untimed prep)", flush=True)
        model = get_model_class(args.model)(
            channels=tuple(params.channels)).to(device)
        state = train(
            model, *_split(full),
            learning_rate=args.lr,
            patience=params.patience,
            max_epochs=args.max_epochs,
            checkpoint_dir=args.checkpoint_dir,
            metrics_dir=args.metrics_dir,
            seed=params.seed,
            loss=args.loss,
            schedule=params.schedule,
            select_by=args.select_by,
            init_from=args.init_from,
            on_epoch=on_epoch,
            world=world,
        )
        return TrainRun(state, full, None)
    if cases is None:
        cases = _cases(args)
    full = PlannedDataSet(
        stage="train", batch_size=params.batch_size, root=args.data_root,
        cases=cases, family=args.family, seed=params.seed, device=device,
    )
    provider = FSAIPlanProvider(full, power=args.power, width=args.width,
                                kind=args.plan_kind)
    model = NeuralFSAI(width=args.width, hidden=args.hidden,
                       poly_degree=args.poly_degree).to(device)
    state = train_neural_fsai(
        model, *_split(full), provider,
        learning_rate=args.lr,
        patience=args.patience,
        max_epochs=args.max_epochs,
        checkpoint_dir=args.checkpoint_dir,
        metrics_dir=args.metrics_dir,
        seed=params.seed,
        loss=args.loss,
        pcg_steps=args.pcg_steps,
        select_by=args.select_by,
        init_from=args.init_from,
        validate_init=args.validate_init,
        on_epoch=on_epoch,
        world=world,
    )
    return TrainRun(state, full, provider)


def main() -> None:
    train_run = run(parse_args())
    if train_run.world is None or train_run.world.rank == 0:
        print(f"final step: {train_run.state.step}")


if __name__ == "__main__":
    main()
