"""The port's entry point: bench.py's flagship protocol on the sludge split.

    python -m deeppreconditioning_tpu_torch.bench

Generates the sludge-pattern cases in memory (seed 69420;
``number_samples`` and ``mesh_cells`` from ``params.yaml``: 500 cases at
2), takes the 100-case test split, loads the NeuralFSAI checkpoint named
by ``params.yaml`` (``checkpoint_dir/best.msgpack``; its pattern power is
the learned technique's), and on the card runs

* the per-case suite for bench.py's seven techniques (vanilla, jacobi,
  incomplete_cholesky, incomplete_cholesky_neumann, algebraic_multigrid,
  fsai, learned; median of 3 timed runs per case, one for the IC and AMG
  techniques, no dense kappa), writing ``table.csv`` / ``totals.csv``;
* then the batched protocol (``run_batched``: the whole split per
  technique, bf16 first, setup median of ``SETUP_REPS`` builds, solve
  median of ``SOLVE_REPS`` fixed-trip runs), writing ``batched.csv``;

under ``assets/results/torch/``, and prints the per-technique means, the
batched table, the ``learned_vs_jacobi`` / ``learned_vs_fsai`` batched
ratios and the untimed input preparation (``input_prep_s``).  The
irregular split is ``python -m deeppreconditioning_tpu_torch.bench.
irregular``.  Needs a CUDA device; there is no CPU path here.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from deeppreconditioning_tpu_torch import _backend
from deeppreconditioning_tpu_torch.bench.suite import (
    RESULTS_DIRECTORY,
    TECHNIQUES,
    BenchmarkSuite,
)
from deeppreconditioning_tpu_torch.config import params_show
from deeppreconditioning_tpu_torch.data.datasets import SludgePatternDataSet
from deeppreconditioning_tpu_torch.data.fvm import generate_sludge_case
from deeppreconditioning_tpu_torch.models.neural_fsai import (
    neural_fsai_from_checkpoint,
)
from deeppreconditioning_tpu_torch.train.checkpoint import load_checkpoint

REPO = Path(__file__).resolve().parents[2]
SEED = 69420  # the reference benchmark's data seed (bench.py)
TIMING_REPS = 3  # the suite times its HOST_BOUND_TECHNIQUES once
KAPPA_CASES = 0
SETUP_REPS = 5  # batched setup builds timed after the warm-up build
SOLVE_REPS = 5  # batched fixed-trip solves timed


def generate_cases(samples: int, seed: int, mesh_cells: int):
    """The sludge-pattern cases in generation order (one rng stream)."""
    rng = np.random.default_rng(seed)
    return [generate_sludge_case(rng, mesh_cells=mesh_cells)
            for _ in range(samples)]


def flagship_suite(
    device: torch.device,
    results_directory: Path = RESULTS_DIRECTORY,
    techniques: tuple = TECHNIQUES,
) -> BenchmarkSuite:
    """The suite over the sludge test split with the flagship checkpoint,
    as bench.py builds it, not yet run."""
    params = params_show(REPO / "params.yaml")
    if params.model != "NeuralFSAI":
        raise NotImplementedError(
            f"model {params.model}: only NeuralFSAI is ported")
    cases = generate_cases(params.number_samples, SEED, params.mesh_cells)
    data_set = SludgePatternDataSet(stage="test", cases=cases)
    payload = load_checkpoint(REPO / params.checkpoint_dir / "best.msgpack")
    return BenchmarkSuite(
        data_set, neural_fsai_from_checkpoint(payload),
        techniques=techniques,
        device=device,
        timing_reps=TIMING_REPS,
        kappa_cases=KAPPA_CASES,
        learned_power=int(payload.get("power", 4)) or 4,
        results_directory=results_directory,
    )


def run(
    device: torch.device,
    results_directory: Path = RESULTS_DIRECTORY,
    techniques: tuple = TECHNIQUES,
) -> BenchmarkSuite:
    """Build the test split and the learned model, run the per-case
    suite, return it."""
    suite = flagship_suite(device, results_directory, techniques)
    suite.run()
    return suite


def run_batched(suite: BenchmarkSuite) -> dict:
    """The batched protocol on ``suite``'s split, as bench.py runs it."""
    return suite.run_batched(reps=SOLVE_REPS, setup_reps=SETUP_REPS)


def batched_ratios(batched: dict) -> dict:
    """bench.py's ``batched_ratios``: other / learned batched totals."""
    learned = batched.get("learned")
    if learned is None:
        return {}
    return {f"learned_vs_{other}": batched[other]["total_batch"]
            / learned["total_batch"]
            for other in ("jacobi", "fsai") if other in batched}


def main() -> None:
    device = _backend.device()
    suite = run(device)
    suite.dump_csv()
    print(f"device: {torch.cuda.get_device_name(device)}; "
          f"{len(suite.data_set)} cases, n_pad {suite.data_set.dof_pad}")
    print(f"{'technique':<28} {'iters':>8} {'setup_ms':>10} "
          f"{'solve_ms':>10} {'total_ms':>10} {'success%':>9}")
    for name, s in suite.summary().items():
        print(f"{name:<28} {s['iterations']:>8.2f} {s['setup']*1e3:>10.3f} "
              f"{s['duration']*1e3:>10.3f} {s['total']*1e3:>10.3f} "
              f"{s['success']:>9.1f}")
    batched = run_batched(suite)
    suite.dump_csv_batched()
    print(f"batched: {'technique':<28} {'iters':>8} {'setup_ms':>10} "
          f"{'solve_ms':>10} {'total_ms':>10} {'M':>9}")
    for name, s in batched.items():
        print(f"batched: {name:<28} {s['iterations']:>8.2f} "
              f"{s['setup_batch']*1e3:>10.3f} {s['solve_batch']*1e3:>10.3f} "
              f"{s['total_batch']*1e3:>10.3f} {s['m_dtype']:>9}")
    print(f"batched ratios: {batched_ratios(batched)}")
    print(f"input_prep_s: {suite.prep_seconds}")


if __name__ == "__main__":
    main()
