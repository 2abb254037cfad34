"""The frame-structure family on the card: per case, then batched.

    python -m deeppreconditioning_tpu_torch.bench.frames

Counterpart of ``scripts/frames_bench.py``: 200 frame stiffness systems
from ``default_rng(69422)`` (``data/frames``; 6 dof per node, n 300-750,
``n_pad`` 768) generated in memory, the last 40 as the test split,
classical FSAI on tril(|A|^2) and the frames NeuralFSAI checkpoint
(``assets/checkpoints_frames/best.msgpack``: width 41, hidden 64, degree
2, power 2).  Per case, the script's five techniques: vanilla, jacobi,
incomplete_cholesky (IC(0) in the host runtime, two level-scheduled
solves), fsai and learned; the 9 cases whose pattern does not fit the
range plan take the generic ``FSAIPlan`` for fsai and learned.  Timing as
the script's: median of 10 timed runs per case (one for IC), dense kappa
for the first case.  Then ``run_batched`` over the split (vanilla, jacobi,
fsai, learned; bf16 first; the learned factor in band form, its generic
group's bands from ``extract_bands``).  Writes ``table.csv``,
``totals.csv`` and ``batched.csv`` under ``assets/results/torch/frames/``
and prints the script's JSON line.  Needs a CUDA device; there is no CPU
path here.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from deeppreconditioning_tpu_torch import _backend
from deeppreconditioning_tpu_torch.bench.suite import (
    RESULTS_DIRECTORY,
    BenchmarkSuite,
)
from deeppreconditioning_tpu_torch.data.datasets import SludgePatternDataSet
from deeppreconditioning_tpu_torch.data.frames import generate_frame_case
from deeppreconditioning_tpu_torch.models.neural_fsai import (
    neural_fsai_from_checkpoint,
)
from deeppreconditioning_tpu_torch.train.checkpoint import load_checkpoint

REPO = Path(__file__).resolve().parents[2]
SEED = 69422  # scripts/frames_bench.py's data seed
SAMPLES = 200
FSAI_POWER = 2
TECHNIQUES = ("vanilla", "jacobi", "incomplete_cholesky", "fsai",
              "learned")
CHECKPOINT = REPO / "assets" / "checkpoints_frames" / "best.msgpack"
RESULTS = RESULTS_DIRECTORY / "frames"
TIMING_REPS = 10
KAPPA_CASES = 1
BATCHED_REPS = 10  # run_batched's defaults, as the script calls it
BATCHED_SETUP_REPS = 20


def generate_frame_cases(samples: int = SAMPLES, seed: int = SEED,
                         solve: bool = True):
    """The frame cases in generation order (one rng stream); ``solve``
    False skips the ground-truth solutions, which no technique reads."""
    rng = np.random.default_rng(seed)
    return [generate_frame_case(rng, solve=solve) for _ in range(samples)]


def frames_suite(device, results_directory: Path = RESULTS,
                 dtype=torch.float32, timing_reps: int = TIMING_REPS,
                 cases=None) -> BenchmarkSuite:
    """The suite over the frames test split (of ``cases``, by default the
    script's 200) with the frames checkpoint, not yet run;
    ``timing_reps`` timed runs per case and technique."""
    if cases is None:
        cases = generate_frame_cases()
    data_set = SludgePatternDataSet(stage="test", cases=cases)
    payload = load_checkpoint(CHECKPOINT)
    return BenchmarkSuite(
        data_set, neural_fsai_from_checkpoint(payload),
        techniques=TECHNIQUES,
        dtype=dtype,
        device=device,
        timing_reps=timing_reps,
        kappa_cases=KAPPA_CASES,
        fsai_power=FSAI_POWER,
        learned_power=int(payload.get("power", FSAI_POWER)),
        results_directory=results_directory,
    )


def run(device: torch.device, results_directory: Path = RESULTS,
        timing_reps: int = TIMING_REPS, reps: int = BATCHED_REPS,
        setup_reps: int = BATCHED_SETUP_REPS) -> BenchmarkSuite:
    """Build the frames split and the learned model, run the suite per
    case and then ``run_batched`` (``reps`` solves, ``setup_reps``
    builds), return it."""
    suite = frames_suite(device, results_directory, timing_reps=timing_reps)
    suite.run()
    suite.run_batched(reps=reps, setup_reps=setup_reps)
    return suite


def summary_line(suite: BenchmarkSuite) -> dict:
    """The script's JSON line: per technique the mean iterations, kappa,
    total ms and success, and under ``batched`` the batched means."""
    out = {
        name: {"iterations": round(s["iterations"], 2),
               "kappa": round(s["kappa"], 2),
               "total_ms": round(s["total"] * 1e3, 3),
               "success": s["success"]}
        for name, s in suite.summary().items()
    }
    out["batched"] = {
        name: {"iterations": round(s["iterations"], 2),
               "total_ms": round(s["total_batch"] * 1e3, 2),
               "success": s["success"]}
        for name, s in suite.batched.items()
    }
    return out


def main() -> None:
    device = _backend.device()
    suite = run(device)
    suite.dump_csv()
    suite.dump_csv_batched()
    print(f"device: {torch.cuda.get_device_name(device)}; "
          f"{len(suite.data_set)} frame cases, n_pad "
          f"{suite.data_set.dof_pad}, generic plan on cases "
          f"{sorted(suite.generic_cases['fsai'])}")
    print(f"{'technique':<20} {'iters':>8} {'setup_ms':>10} "
          f"{'solve_ms':>10} {'total_ms':>10} {'success%':>9}")
    for name, s in suite.summary().items():
        print(f"{name:<20} {s['iterations']:>8.2f} "
              f"{s['setup']*1e3:>10.3f} {s['duration']*1e3:>10.3f} "
              f"{s['total']*1e3:>10.3f} {s['success']:>9.1f}")
    print(json.dumps(summary_line(suite)))


if __name__ == "__main__":
    main()
