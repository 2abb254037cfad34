"""The port's pipeline runner: generate, train, test with content-addressed
stage skipping.

    python -m deeppreconditioning_tpu_torch.repro [--force] [--adopt]
        [--stages generate,train,test] [--device cuda|cpu]

Counterpart of ``scripts/repro.py`` (the reference's ``dvc repro``):
the port's three entry points run in dependency order,

    generate  python -m deeppreconditioning_tpu_torch.generate_data
              -> <data_root>/sludge_patterns/
    train     python -m deeppreconditioning_tpu_torch.train
              --max-epochs <max_epochs>
              -> assets/results/torch/train[/<model>]/best.msgpack
    test      python -m deeppreconditioning_tpu_torch.test --checkpoint
              <the train stage's best.msgpack>
              -> assets/results/torch/table.csv

and a stage is skipped only when its record matches the lock: the
``params.yaml`` keys it declares, the content hash of every dependency and
the content hash of every output (a file's sha256; a folder's, over its
sorted (relative path, file hash) listing).  Editing a declared key or
regenerating an upstream output reruns the stages downstream of it.
``--adopt`` records the current state without running anything (the
``dvc commit`` analog).  The lock is the port's own,
``assets/results/torch/repro.lock``; the reference's ``repro.lock`` is
never written.  ``--device`` goes to the train and test stages (the
generate stage runs on the host).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import List

from deeppreconditioning_tpu_torch.config import params_flat
from deeppreconditioning_tpu_torch.models import CONV_MODELS

REPO = Path(__file__).resolve().parents[1]
LOCK = Path("assets") / "results" / "torch" / "repro.lock"


def _hash_file(path: Path) -> str:
    h = hashlib.sha256()
    with path.open("rb") as fio:
        for chunk in iter(lambda: fio.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def path_sig(path: Path) -> str:
    """Content hash of a file or a folder tree ("missing" if absent)."""
    if not path.exists():
        return "missing"
    if path.is_file():
        return _hash_file(path)
    h = hashlib.sha256()
    for f in sorted(p for p in path.rglob("*") if p.is_file()):
        h.update(str(f.relative_to(path)).encode())
        h.update(_hash_file(f).encode())
    return h.hexdigest()


@dataclass
class Stage:
    """One pipeline stage: its module, the params keys it declares, its
    dependencies and outputs (paths under ``REPO``)."""

    name: str
    module: str
    params_keys: List[str]
    deps: List[Path] = field(default_factory=list)
    outs: List[Path] = field(default_factory=list)
    args: List[str] = field(default_factory=list)

    def record(self, params: dict) -> dict:
        """The current (params, deps, outs) content signature."""
        def rel(p: Path) -> str:
            return str(p.relative_to(REPO))

        return {
            "params": {k: params.get(k) for k in self.params_keys},
            "deps": {rel(p): path_sig(p) for p in self.deps},
            "outs": {rel(p): path_sig(p) for p in self.outs},
        }


def should_skip(stage: Stage, params: dict, lock: dict) -> bool:
    """True iff the lock's entry matches the current content state and
    every output exists."""
    entry = lock.get(stage.name)
    if entry is None:
        return False
    if not all(p.exists() for p in stage.outs):
        return False
    return entry == stage.record(params)


def load_lock(path: Path) -> dict:
    return json.loads(path.read_text()) if path.exists() else {}


def save_lock(path: Path, lock: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(lock, indent=1, sort_keys=True))


def build_stages(params: dict, device: str) -> List[Stage]:
    """The three stages of ``params`` (a ``params_flat`` dict)."""
    data_dir = REPO / params["data_root"] / "sludge_patterns"
    train_dir = REPO / "assets" / "results" / "torch" / "train"
    if params["model"] in (cls.__name__ for cls in CONV_MODELS):
        train_dir = train_dir / params["model"]
    ckpt = train_dir / "best.msgpack"
    table = REPO / "assets" / "results" / "torch" / "table.csv"
    # the params -> stage mapping of scripts/repro.py (dvc.yaml's)
    return [
        Stage("generate", "deeppreconditioning_tpu_torch.generate_data",
              ["data", "number_samples", "resolution", "mesh_cells",
               "data_root"],
              outs=[data_dir]),
        Stage("train", "deeppreconditioning_tpu_torch.train",
              ["model", "data", "channels", "batch_size", "learning_rate",
               "patience", "loss", "schedule", "seed", "fsai_power",
               "fsai_width", "max_epochs", "checkpoint_dir"],
              deps=[data_dir], outs=[ckpt],
              args=["--device", device, "--max-epochs",
                    str(params["max_epochs"])]),
        Stage("test", "deeppreconditioning_tpu_torch.test",
              ["model", "data", "channels", "fsai_power", "fsai_width",
               "results_dir"],
              deps=[data_dir, ckpt], outs=[table],
              args=["--device", device, "--checkpoint", str(ckpt)]),
    ]


def _run(stage: Stage) -> None:
    cmd = [sys.executable, "-m", stage.module, *stage.args]
    print(f"$ {' '.join(cmd)}", flush=True)
    subprocess.run(cmd, check=True, cwd=REPO)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog="python -m deeppreconditioning_tpu_torch.repro")
    parser.add_argument("--force", action="store_true",
                        help="run the stages even if the lock matches")
    parser.add_argument("--adopt", action="store_true",
                        help="record the current params, dependencies and "
                        "outputs as the lock's state without running")
    parser.add_argument("--stages", default="generate,train,test")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    wanted = args.stages.split(",")

    params = params_flat(REPO / "params.yaml")
    lock_path = REPO / LOCK
    lock = load_lock(lock_path)
    for stage in build_stages(params, args.device):
        if stage.name not in wanted:
            continue
        if args.adopt:
            if all(p.exists() for p in stage.outs):
                lock[stage.name] = stage.record(params)
                save_lock(lock_path, lock)
                print(f"{stage.name}: adopted current state")
            else:
                print(f"{stage.name}: outputs missing, not adopted")
            continue
        if not args.force and should_skip(stage, params, lock):
            print(f"{stage.name}: lock matches, skipping")
            continue
        _run(stage)
        lock[stage.name] = stage.record(params)
        save_lock(lock_path, lock)


if __name__ == "__main__":
    main()
