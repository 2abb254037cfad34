#!/usr/bin/env python3
"""The host-bound paths that launch kernel B2, timed on a card.

    python3 scripts/torch_b2_paths.py [--repo PATH] [--steps N] [--release-gil]

Imports ``deeppreconditioning_tpu_torch`` from ``--repo`` (default: this
checkout), so two versions of the port can be timed in turns in one call
on one card (unpack the other into a git-ignored directory with
``git archive``).  It runs:

- the 128^3 scaling table (``bench.scaling.run_scaling`` at its defaults,
  six techniques, medians of 5): setup, solve and total ms, iterations
  and B2 launches per technique;
- the w-13 structured trainer at its defaults (12^3, 32 samples) for
  ``--steps`` steps (default 60, no checkpoint written): the step median
  ms over the steps after the first 10, and the B2 launches per step.

``--release-gil`` rebinds B2's C entry the ctypes default way, releasing
the GIL around each call, where the port keeps it (this checkout's port
only).  Prints the card's name and power limit.  Needs a CUDA device.
"""

import argparse
import ctypes
import statistics
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
WARM_STEPS = 10


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repo", default=str(REPO))
    parser.add_argument("--steps", type=int, default=60)
    parser.add_argument("--release-gil", action="store_true")
    args = parser.parse_args()
    repo = Path(args.repo).resolve()
    sys.path.insert(0, str(repo))
    from deeppreconditioning_tpu_torch import _backend
    from deeppreconditioning_tpu_torch.bench import scaling
    from deeppreconditioning_tpu_torch.train import structured
    sys.path.insert(1, str(REPO))
    from chip_smoke import card_line

    card = card_line()
    dev = _backend.device()
    lib = _backend.kernel_library()
    if args.release_gil:
        lib.dp_dia_spmv_f32 = ctypes.CFUNCTYPE(
            ctypes.c_int, *[ctypes.c_void_p] * 5)(("dp_dia_spmv_f32", lib))
    print(f"port from {repo}{', GIL released' * args.release_gil} [{card}]")
    run = scaling.run_scaling(dev, (128,), out=None)
    for row in run.rows:
        key = (128, row["technique"])
        print(f"  128^3 {row['technique']:<12} iters {row['iterations']:4d} "
              f"setup {row['setup_s'] * 1e3:8.3f} solve "
              f"{row['solve_s'] * 1e3:8.3f} total {row['total_s'] * 1e3:8.3f}"
              f" ms; B2 launches {run.launches[key]['dia_spmv']}")
    _backend.reset_launch_counts()
    trained = structured.run(structured.parse_args(
        ["--steps", str(args.steps), "--out", ""]), log=lambda _: None)
    steps = trained.step_seconds[WARM_STEPS:]
    b2 = _backend.launch_counts()["dia_spmv"] / args.steps
    print(f"  w-13 structured step median "
          f"{statistics.median(steps) * 1e3:.3f} ms over steps "
          f"{WARM_STEPS}..{args.steps - 1} (min {min(steps) * 1e3:.3f}); "
          f"B2 launches a step {b2:.1f} [{card}]")


if __name__ == "__main__":
    main()
