"""The port's train stage for the NeuralFSAI family.

    python -m deeppreconditioning_tpu_torch.train [--device cpu]
        [--max-epochs N] [--loss NAME] [--pcg-steps K] [--width W]
        [--power P] [--poly-degree D] [--hidden H] [--lr LR]
        [--patience N] [--checkpoint-dir DIR] [--metrics-dir DIR]
        [--select-by loss|iterations] [--init-from CKPT] [--family F]
        [--plan-kind auto|range|generic] [--data-root DIR]
        [--validate-init]

Counterpart of ``scripts/train_fsai.py`` (without its ``--dp`` and
``--platform``; ``--device cpu`` is the explicit CPU request, and without
it the run needs the card).  Settings come from ``params.yaml``: the
train split of ``number_samples`` cases, shuffled with ``seed``, in
batches of ``batch_size`` (95% train, the last 5% of batches validate),
``fsai_width`` / ``fsai_power``, learning rate ``learning_rate / 10``,
``patience``.  The cases are read from ``--data-root``'s
``<family>/case_*`` folders when there are any; otherwise the
sludge-pattern cases are generated in process from seed 69420 at
``mesh_cells``, as bench.py does.  Defaults give the flagship: width 24,
hidden 64, polynomial degree 2 (the committed checkpoint's; the script's
default degree is 1), power 4, ``pcg_loss`` over 16 steps, selection by
validation iterations, one epoch (``--max-epochs`` for more; the
reference script's default is params.yaml's ``max_epochs``, 200).
Checkpoints (``latest.msgpack``, ``best.msgpack``, Flax's format) go to
``assets/results/torch/train/``, metrics to its ``metrics/``.  One line
per epoch: train loss, validation loss and mean iterations, epoch
seconds and B1 launches.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import NamedTuple

import torch

from deeppreconditioning_tpu_torch import _backend
from deeppreconditioning_tpu_torch.config import params_show
from deeppreconditioning_tpu_torch.data.datasets import PlannedDataSet
from deeppreconditioning_tpu_torch.models.neural_fsai import (
    FSAIPlanProvider,
    NeuralFSAI,
)
from deeppreconditioning_tpu_torch.train.trainer import (
    FSAI_LOSSES,
    TrainState,
    train_neural_fsai,
)

REPO = Path(__file__).resolve().parents[2]
RESULTS = REPO / "assets" / "results" / "torch" / "train"


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


def parse_args(argv=None) -> argparse.Namespace:
    params = params_show(REPO / "params.yaml")
    parser = argparse.ArgumentParser(
        prog="python -m deeppreconditioning_tpu_torch.train")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--max-epochs", type=int, default=1)
    parser.add_argument("--loss", default="pcg_loss", choices=FSAI_LOSSES)
    parser.add_argument("--pcg-steps", type=int, default=16)
    parser.add_argument("--width", type=int, default=params.fsai_width)
    parser.add_argument("--power", type=int, default=params.fsai_power)
    parser.add_argument("--poly-degree", type=int, default=2)
    parser.add_argument("--hidden", type=int, default=64)
    parser.add_argument("--lr", type=float,
                        default=params.learning_rate / 10)
    parser.add_argument("--patience", type=int, default=params.patience)
    parser.add_argument("--checkpoint-dir", type=Path, default=RESULTS)
    parser.add_argument("--metrics-dir", type=Path,
                        default=RESULTS / "metrics")
    parser.add_argument("--select-by", default="iterations",
                        choices=["loss", "iterations"])
    parser.add_argument("--init-from", type=Path, default=None,
                        help="start from this checkpoint's params "
                        "(same width / hidden / poly-degree)")
    parser.add_argument("--family", default="sludge_patterns")
    parser.add_argument("--plan-kind", default="auto",
                        choices=["auto", "range", "generic"])
    parser.add_argument("--data-root", type=Path,
                        default=REPO / params.data_root)
    parser.add_argument("--validate-init", action="store_true",
                        help="also validate the starting parameters")
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
    plan_provider: FSAIPlanProvider


def run(args: argparse.Namespace, cases=None) -> TrainRun:
    """Build the split, the plan provider and the model on the device,
    and train; ``cases`` (in-memory cases in generation order) skips the
    disk and the generation."""
    device = (torch.device("cpu") if args.device == "cpu"
              else _backend.device())
    params = args.params
    if cases is None:
        cases = _cases(args)
    full = PlannedDataSet(
        stage="train", batch_size=params.batch_size, root=args.data_root,
        cases=cases, family=args.family, seed=params.seed, device=device,
    )
    n_batches = len(full)
    n_val = max(1, n_batches * 5 // 100)
    train_set = SubsetView(full, range(n_batches - n_val))
    val_set = SubsetView(full, range(n_batches - n_val, n_batches))
    provider = FSAIPlanProvider(full, power=args.power, width=args.width,
                                kind=args.plan_kind)
    model = NeuralFSAI(width=args.width, hidden=args.hidden,
                       poly_degree=args.poly_degree).to(device)
    state = train_neural_fsai(
        model, train_set, val_set, provider,
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
        on_epoch=print_epoch,
    )
    return TrainRun(state, full, provider)


def main() -> None:
    print(f"final step: {run(parse_args()).state.step}")


if __name__ == "__main__":
    main()
