"""The flagship training epoch of the PyTorch port through ``train --dp N``
at several world sizes, one card a rank, held against world size 1.

    python3 scripts/torch_dp_scaling.py [--ranks 1 4] [--device cpu]
        [-- TRAIN ARGS ...]

For each N of ``--ranks`` it starts ``python -m torch.distributed.run
--nproc-per-node N`` on this script's worker (env:// from torchrun; each
rank on the card of its ``LOCAL_RANK``, NCCL, or gloo with ``--device
cpu``), which runs ``python -m deeppreconditioning_tpu_torch.train --dp
N --validate-init --init-from tests/fixtures/torch_port/train_init.msgpack``
with the train arguments after ``--`` (none: ``chip_smoke.py`` phase
4f's epoch, the flagship NeuralFSAI on the 400 generated sludge cases,
numpy FVM assembly) and writes rank 0's epoch records to
``build/dp_scaling/world<N>.json``.  Then it prints, for each N, the step
losses' largest relative difference from world size 1's (held to
``STEP_RTOL``: the sum order of the gradients changes with N), the
validation iterations against world size 1's, the step median, the
all-reduce median (CUDA events), the epoch seconds and B1's launches on
rank 0, with the card's name and power limit on every line, and exits 1
if a world's losses or validation iterations are off.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

OUT = REPO / "build" / "dp_scaling"
INIT = REPO / "tests" / "fixtures" / "torch_port" / "train_init.msgpack"
STEP_RTOL = 1e-3  # chip_smoke.py's TRAIN_STEP_RTOL
ITERS_CASE = 1  # chip_smoke.py's TRAIN_ITERS_CASE


def card_line(device: str) -> str:
    if device == "cpu":
        return "CPU"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def worker(out: Path, train_argv: list[str]) -> None:
    """One rank: the train entry point's run; rank 0 writes the records."""
    from deeppreconditioning_tpu_torch import _backend
    from deeppreconditioning_tpu_torch.data.fvm import numpy_assembly
    from deeppreconditioning_tpu_torch.train import __main__ as entry

    size = int(os.environ["WORLD_SIZE"])
    args = entry.parse_args([
        "--dp", str(size), "--validate-init", "--init-from", str(INIT),
        "--checkpoint-dir", str(out.parent / f"ckpt{size}"),
        "--metrics-dir", str(out.parent / f"metrics{size}"), *train_argv])
    with numpy_assembly():
        run = entry.run(args)
    if run.world.rank == 0:
        out.write_text(json.dumps({
            "world": size, "backend": run.backend,
            "batch_size": run.data_set.batch_size,
            "b1_launches": _backend.launch_counts()["gauss_jordan"],
            "epochs": run.state.epochs}))


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--ranks", type=int, nargs="+", default=[1, 4])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--worker", type=Path, default=None)
    parser.add_argument("train", nargs="*")
    args = parser.parse_args()
    train_argv = list(args.train) + (["--device", "cpu"]
                                     if args.device == "cpu" else [])
    if args.worker is not None:
        worker(args.worker, train_argv)
        return
    if 1 not in args.ranks:
        raise SystemExit("--ranks must hold 1, the world the others are "
                         "held against")
    OUT.mkdir(parents=True, exist_ok=True)
    card = card_line(args.device)
    records = {}
    for n in args.ranks:
        out = OUT / f"world{n}.json"
        out.unlink(missing_ok=True)
        env = dict(os.environ, OMP_NUM_THREADS="1")
        subprocess.run(
            [sys.executable, "-m", "torch.distributed.run",
             "--nproc-per-node", str(n), "--master-port",
             str(29500 + n), str(Path(__file__).resolve()), "--device",
             args.device, "--worker", str(out), "--", *args.train],
            check=True, env=env, cwd=REPO, timeout=1800)
        records[n] = json.loads(out.read_text())
    one = records[1]["epochs"]
    failed = False
    for n, rec in records.items():
        rel, iters_gap = [], 0
        for got, want in zip(rec["epochs"], one):
            if "step_losses" in want:
                a = np.asarray(got["step_losses"])
                b = np.asarray(want["step_losses"])
                rel.append(float((np.abs(a - b) / np.abs(b)).max()))
            iters_gap = max(iters_gap, int(np.abs(
                np.subtract(got["val_iterations"],
                            want["val_iterations"])).max()))
        last = rec["epochs"][-1]
        worst = max(rel) if rel else 0.0
        ok = worst <= STEP_RTOL and iters_gap <= ITERS_CASE
        failed |= not ok
        allreduce = np.asarray(last["allreduce_ms"])
        print(f"world {n} ({rec['backend']}, {rec['batch_size'] // n}-"
              f"{-(-rec['batch_size'] // n)} cases a rank): step losses "
              f"against world 1: worst rel {worst:.3e} (limit {STEP_RTOL});"
              f" validation iterations {last['val_mean_iterations']:.3f}, "
              f"max |delta| per case {iters_gap} (limit {ITERS_CASE}); step "
              f"median {np.median(last['step_seconds']) * 1e3:.3f} ms, "
              f"all-reduce median {np.median(allreduce):.4f} ms (min "
              f"{allreduce.min():.4f}); epoch {last['seconds']:.2f} s; "
              f"rank 0's B1 launches {rec['b1_launches']} "
              f"{'ok' if ok else 'OFF'} [{card}]", flush=True)
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
