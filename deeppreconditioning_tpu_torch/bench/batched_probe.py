"""The batched protocol on one split, per technique.

    python -m deeppreconditioning_tpu_torch.bench.batched_probe \
        [--irregular] [--reps 10] [--setup-reps 20] [--chunk 20]

Counterpart of ``scripts/batched_probe.py``: ``run_batched`` over the
sludge test split (bench.py's 500 cases from seed 69420, the last 100) or,
with ``--irregular``, over bench.py's irregular split (100 3-D castellated
cases from seed 69421, odd ones permuted, the last 20), both generated in
memory, with the flagship checkpoint and the script's five techniques:
vanilla, jacobi, incomplete_cholesky_neumann, fsai and learned (fsai at
power 4 and learned at the checkpoint's power on the sludge split, both
at power 2 on the irregular one).  ``chunk`` bounds the cases per setup
call.  The irregular split's band spread is past the band form's cap, so
its learned M is built dense.  Prints one line per technique, the
``learned_vs_jacobi`` / ``learned_vs_fsai`` ratios of the batched totals
and the mean iterations.  Needs a CUDA device; there is no CPU path here.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch

from deeppreconditioning_tpu_torch import _backend
from deeppreconditioning_tpu_torch.bench.__main__ import flagship_cases
from deeppreconditioning_tpu_torch.bench.irregular import (
    generate_irregular_cases,
)
from deeppreconditioning_tpu_torch.bench.suite import (
    RESULTS_DIRECTORY,
    BenchmarkSuite,
)
from deeppreconditioning_tpu_torch.data.datasets import SludgePatternDataSet
from deeppreconditioning_tpu_torch.models.neural_fsai import (
    neural_fsai_from_checkpoint,
)
from deeppreconditioning_tpu_torch.train.checkpoint import load_checkpoint

REPO = Path(__file__).resolve().parents[2]
CHECKPOINT = REPO / "assets" / "checkpoints_fsai" / "best.msgpack"
TECHNIQUES = ("vanilla", "jacobi", "incomplete_cholesky_neumann", "fsai",
              "learned")
RESULTS = RESULTS_DIRECTORY / "probe"
REPS = 10
SETUP_REPS = 20  # run_batched's default, as the script calls it
CHUNK = 20


def probe_suite(device, irregular: bool = False, cases=None,
                results_directory: Path = RESULTS) -> BenchmarkSuite:
    """The suite over the sludge (or irregular) test split with the
    flagship checkpoint, not yet run; ``cases``: the split's generated
    cases, if the caller has them."""
    if cases is None:
        cases = (generate_irregular_cases() if irregular
                 else flagship_cases())
    payload = load_checkpoint(CHECKPOINT)
    return BenchmarkSuite(
        SludgePatternDataSet(stage="test", cases=cases),
        neural_fsai_from_checkpoint(payload),
        techniques=TECHNIQUES,
        device=device,
        kappa_cases=0,
        fsai_power=2 if irregular else 4,
        learned_power=(2 if irregular
                       else int(payload.get("power", 4))),
        results_directory=results_directory,
    )


def run(device, irregular: bool = False, reps: int = REPS,
        setup_reps: int = SETUP_REPS, chunk: int = CHUNK, cases=None,
        results_directory: Path = RESULTS,
        verbose: bool = False) -> BenchmarkSuite:
    """``run_batched`` on the probe's suite; returns the suite (its
    records in ``suite.batched``)."""
    suite = probe_suite(device, irregular, cases, results_directory)
    suite.run_batched(reps=reps, setup_reps=setup_reps, chunk=chunk,
                      verbose=verbose)
    return suite


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--irregular", action="store_true")
    parser.add_argument("--reps", type=int, default=REPS)
    parser.add_argument("--setup-reps", type=int, default=SETUP_REPS)
    parser.add_argument("--chunk", type=int, default=CHUNK)
    args = parser.parse_args()
    device = _backend.device()
    family = "sludge_patterns_3d" if args.irregular else "sludge_patterns"
    print(f"=== batched dense protocol, family={family} on "
          f"{torch.cuda.get_device_name(device)} ===", flush=True)
    t0 = time.perf_counter()
    stats = run(device, args.irregular, args.reps, args.setup_reps,
                args.chunk, verbose=True).batched
    print(f"wall: {time.perf_counter() - t0:.1f}s")
    tot = {k: v["total_batch"] for k, v in stats.items()}
    print(f"learned_vs_jacobi: {tot['jacobi'] / tot['learned']:.3f}"
          f"  learned_vs_fsai: {tot['fsai'] / tot['learned']:.3f}")
    print("iterations:", {k: round(v["iterations"], 2)
                          for k, v in stats.items()}, flush=True)


if __name__ == "__main__":
    main()
