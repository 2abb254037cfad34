"""bench.py's irregular split per case on the card.

    python -m deeppreconditioning_tpu_torch.bench.irregular

Counterpart of ``bench.py::_irregular_split``: 100 3-D castellated
pressure-Poisson cases from ``default_rng(69421)`` at ``mesh_cells=2``,
the odd ones with a randomly permuted numbering (``data/fvm.
generate_sludge_case_3d``), generated in memory; the last 20 as the test
split; vanilla, jacobi, fsai and learned with the flagship checkpoint
(``assets/checkpoints_fsai/best.msgpack``), both FSAI patterns at power 2
(3-D power-4 patterns exceed practical widths).  The range plan refuses
the permuted cases, so the generic ``FSAIPlan`` carries fsai and learned
there.  Timing as bench.py: median of 10 timed runs per case, no dense
kappa.  Writes ``table.csv`` / ``totals.csv`` under
``assets/results/torch/irregular/`` and prints the per-technique means.
Needs a CUDA device; there is no CPU path here.
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
from deeppreconditioning_tpu_torch.data.fvm import generate_sludge_case_3d
from deeppreconditioning_tpu_torch.models.neural_fsai import (
    neural_fsai_from_checkpoint,
)
from deeppreconditioning_tpu_torch.train.checkpoint import load_checkpoint

REPO = Path(__file__).resolve().parents[2]
SEED = 69421  # bench.py's _ensure_dataset_3d
SAMPLES = 100
MESH_CELLS = 2
POWER = 2
TECHNIQUES = ("vanilla", "jacobi", "fsai", "learned")
CHECKPOINT = REPO / "assets" / "checkpoints_fsai" / "best.msgpack"
RESULTS = RESULTS_DIRECTORY / "irregular"
TIMING_REPS = 10
KAPPA_CASES = 0


def generate_irregular_cases(samples: int = SAMPLES, seed: int = SEED,
                             mesh_cells: int = MESH_CELLS):
    """The 3-D castellated cases in generation order, odd ones
    permuted."""
    rng = np.random.default_rng(seed)
    return [generate_sludge_case_3d(rng, mesh_cells=mesh_cells,
                                    castellated=True, permute=bool(i % 2))
            for i in range(samples)]


def irregular_suite(device, results_directory: Path = RESULTS,
                    dtype=torch.float32, cases=None,
                    timing_reps: int = TIMING_REPS) -> BenchmarkSuite:
    """The suite over the irregular test split (of ``cases``, by default
    bench.py's 100) with the flagship checkpoint, not yet run;
    ``timing_reps`` timed runs per case and technique."""
    if cases is None:
        cases = generate_irregular_cases()
    data_set = SludgePatternDataSet(stage="test", cases=cases)
    return BenchmarkSuite(
        data_set, neural_fsai_from_checkpoint(load_checkpoint(CHECKPOINT)),
        techniques=TECHNIQUES,
        dtype=dtype,
        device=device,
        timing_reps=timing_reps,
        kappa_cases=KAPPA_CASES,
        fsai_power=POWER,
        learned_power=POWER,
        results_directory=results_directory,
    )


def run(device: torch.device, results_directory: Path = RESULTS,
        timing_reps: int = TIMING_REPS) -> BenchmarkSuite:
    """Build the irregular split and the learned model, run the suite,
    return it."""
    suite = irregular_suite(device, results_directory, timing_reps=timing_reps)
    suite.run()
    return suite


def main() -> None:
    device = _backend.device()
    suite = run(device)
    suite.dump_csv()
    print(f"device: {torch.cuda.get_device_name(device)}; "
          f"{len(suite.data_set)} irregular cases, n_pad "
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
