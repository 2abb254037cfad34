"""The port's test stage: the benchmark suite on the test split.

    python -m deeppreconditioning_tpu_torch.test [--device cpu]
        [--model NAME] [--checkpoint CKPT] [--kappa-cases N]
        [--techniques LIST|all] [--timing-reps N] [--family F]
        [--fsai-power P] [--results-dir DIR]

Counterpart of ``scripts/test.py`` (the reference's test stage).  The
model is ``params.yaml``'s ``model`` unless ``--model`` names another
(``NeuralFSAI``, ``PreconditionerNet`` or ``PreconditionerSparseUNet``);
the checkpoint is ``checkpoint_dir/best.msgpack`` unless ``--checkpoint``
names another.  A NeuralFSAI checkpoint gives its width, hidden size,
polynomial degree and pattern power; a conv model takes ``params.yaml``'s
``channels`` and the data set is built with its plans.  The test split
is read from ``data_root``'s ``<family>/case_*`` folders when there are
any; otherwise the sludge-pattern cases are generated in process from
seed 69420, as bench.py does.  Techniques default to vanilla, jacobi,
incomplete_cholesky and learned; ``all`` runs the reference's eight
(``bench.suite.ALL_TECHNIQUES``: bench.py's seven and incomplete_lu).

Writes ``table.csv``, ``totals.csv`` and ``eigenvalues.csv`` under
``assets/results/torch/`` (or ``--results-dir``) and prints one summary
line per technique.  Runs on the card; ``--device cpu`` is the explicit
CPU request, and without it and without a card it raises.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from deeppreconditioning_tpu_torch import _backend
from deeppreconditioning_tpu_torch.bench.suite import (
    ALL_TECHNIQUES,
    RESULTS_DIRECTORY,
    BenchmarkSuite,
)
from deeppreconditioning_tpu_torch.config import (
    get_dataset_class,
    params_show,
)
from deeppreconditioning_tpu_torch.models import (
    conv_model_from_checkpoint,
    plan_builder_for,
)
from deeppreconditioning_tpu_torch.models.neural_fsai import (
    neural_fsai_from_checkpoint,
)
from deeppreconditioning_tpu_torch.train.checkpoint import load_checkpoint

REPO = Path(__file__).resolve().parents[1]


def parse_args(argv=None) -> argparse.Namespace:
    params = params_show(REPO / "params.yaml")
    parser = argparse.ArgumentParser(
        prog="python -m deeppreconditioning_tpu_torch.test")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--model", default=params.model,
                        help="override params.yaml's model")
    parser.add_argument("--kappa-cases", type=int, default=5)
    parser.add_argument(
        "--techniques", default="vanilla,jacobi,incomplete_cholesky,learned",
        help="comma list; 'all' = the reference's eight techniques",
    )
    parser.add_argument("--checkpoint", type=Path, default=None)
    parser.add_argument("--timing-reps", type=int, default=10)
    parser.add_argument("--family", default="sludge_patterns")
    parser.add_argument("--fsai-power", type=int, default=0,
                        help="override the fsai pattern power (0: default)")
    parser.add_argument("--results-dir", type=Path, default=None)
    args = parser.parse_args(argv)
    args.params = params
    return args


def _cases(root: Path, family: str):
    """None when ``root`` holds the family's case folders, else the
    generated sludge-pattern cases."""
    if any((root / family).glob("case_*")):
        return None
    if family != "sludge_patterns":
        raise FileNotFoundError(f"no cases under {root / family}")
    from deeppreconditioning_tpu_torch.bench.__main__ import flagship_cases

    return flagship_cases()


def run(args: argparse.Namespace, cases=None,
        learned_apply: str = "dense") -> BenchmarkSuite:
    """Build the test split (with the conv model's plans) and the model,
    run the suite, write its tables; ``cases``: in-memory cases in
    generation order, in place of the disk and the generation.  The conv
    plans' build time (the data set's ``plan_seconds``) is kept in
    ``prep_seconds["conv_plans"]``."""
    device = (torch.device("cpu") if args.device == "cpu"
              else _backend.device())
    params = args.params
    root = REPO / params.data_root
    if cases is None:
        cases = _cases(root, args.family)
    data_set = get_dataset_class(params.data)(
        stage="test", root=root, cases=cases, family=args.family,
        specs=(None if args.model == "NeuralFSAI"
               else plan_builder_for(args.model, params.channels)),
    )
    payload = load_checkpoint(args.checkpoint or (
        REPO / params.checkpoint_dir / "best.msgpack"))
    suite_kwargs = {}
    if args.model == "NeuralFSAI":
        model = neural_fsai_from_checkpoint(payload)
        # the learned pattern power is the checkpoint's; the classical
        # fsai baseline keeps its own
        suite_kwargs["learned_power"] = int(payload.get("power", 4)) or 4
    else:
        model = conv_model_from_checkpoint(args.model, payload,
                                           channels=params.channels)
    if args.fsai_power:
        suite_kwargs["fsai_power"] = args.fsai_power
        if args.model == "NeuralFSAI":
            suite_kwargs["learned_power"] = min(
                suite_kwargs["learned_power"], args.fsai_power)
    techniques = (ALL_TECHNIQUES if args.techniques == "all"
                  else tuple(args.techniques.split(",")))
    suite = BenchmarkSuite(
        data_set, model,
        techniques=techniques,
        device=device,
        kappa_cases=args.kappa_cases,
        timing_reps=args.timing_reps,
        learned_apply=learned_apply,
        results_directory=args.results_dir or RESULTS_DIRECTORY,
        **suite_kwargs,
    )
    if data_set.specs is not None:
        suite.prep_seconds["conv_plans"] = data_set.plan_seconds
    suite.run()
    suite.dump_csv()
    return suite


def main() -> None:
    suite = run(parse_args())
    for name, stats in suite.summary().items():
        print(f"{name}: iters={stats['iterations']:.1f} "
              f"total={stats['total'] * 1e3:.2f}ms "
              f"kappa={stats['kappa']:.3g} "
              f"success={stats['success']:.0f}%")


if __name__ == "__main__":
    main()
