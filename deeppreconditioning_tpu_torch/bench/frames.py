"""The frame-structure family per case on the card.

    python -m deeppreconditioning_tpu_torch.bench.frames

Counterpart of ``scripts/frames_bench.py``'s per-case run: 200 frame
stiffness systems from ``default_rng(69422)`` (``data/frames``; 6 dof per
node, n 300-750, ``n_pad`` 768) generated in memory, the last 40 as the
test split, classical FSAI on tril(|A|^2) and the frames NeuralFSAI
checkpoint (``assets/checkpoints_frames/best.msgpack``: width 41, hidden
64, degree 2, power 2).  Techniques: vanilla, jacobi, fsai, learned; the
9 cases whose pattern does not fit the range plan take the generic
``FSAIPlan`` for fsai and learned.  Timing as the reference's script:
median of 10 timed runs per case, dense kappa for the first case.  Writes
``table.csv`` / ``totals.csv`` under ``assets/results/torch/frames/`` and
prints the per-technique means.

Not here yet: the script's ``incomplete_cholesky`` row and its batched
protocol (ROADMAP A19).  Needs a CUDA device; there is no CPU path here.
"""

from __future__ import annotations

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
TECHNIQUES = ("vanilla", "jacobi", "fsai", "learned")
CHECKPOINT = REPO / "assets" / "checkpoints_frames" / "best.msgpack"
RESULTS = RESULTS_DIRECTORY / "frames"
TIMING_REPS = 10
KAPPA_CASES = 1


def generate_frame_cases(samples: int = SAMPLES, seed: int = SEED):
    """The frame cases in generation order (one rng stream)."""
    rng = np.random.default_rng(seed)
    return [generate_frame_case(rng) for _ in range(samples)]


def frames_suite(device, results_directory: Path = RESULTS,
                 dtype=torch.float32,
                 timing_reps: int = TIMING_REPS) -> BenchmarkSuite:
    """The suite over the frames test split with the frames checkpoint,
    not yet run; ``timing_reps`` timed runs per case and technique."""
    data_set = SludgePatternDataSet(stage="test", cases=generate_frame_cases())
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
        timing_reps: int = TIMING_REPS) -> BenchmarkSuite:
    """Build the frames split and the learned model, run the suite,
    return it."""
    suite = frames_suite(device, results_directory, timing_reps=timing_reps)
    suite.run()
    return suite


def main() -> None:
    device = _backend.device()
    suite = run(device)
    suite.dump_csv()
    print(f"device: {torch.cuda.get_device_name(device)}; "
          f"{len(suite.data_set)} frame cases, n_pad "
          f"{suite.data_set.dof_pad}, generic plan on cases "
          f"{sorted(suite.generic_cases['fsai'])}")
    print(f"{'technique':<10} {'iters':>8} {'setup_ms':>10} "
          f"{'solve_ms':>10} {'total_ms':>10} {'success%':>9}")
    for name, s in suite.summary().items():
        print(f"{name:<10} {s['iterations']:>8.2f} {s['setup']*1e3:>10.3f} "
              f"{s['duration']*1e3:>10.3f} {s['total']*1e3:>10.3f} "
              f"{s['success']:>9.1f}")


if __name__ == "__main__":
    main()
