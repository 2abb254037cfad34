#!/usr/bin/env python3
"""The port's irregular split in float64 beside the JAX reference's.

    python3 scripts/torch_irregular_f64.py

Runs bench.py's irregular split (``python -m deeppreconditioning_tpu_torch.
bench.irregular``'s suite: 100 3-D castellated cases from seed 69421, odd
ones permuted, the 20-case test split, vanilla / jacobi / fsai / learned
at pattern power 2) through the port on the CPU in float64, one timed run
per case, and holds every technique's per-case iterations and successes
against the fixture's float64 counts (``iterations_f64`` in
``tests/fixtures/torch_port/batched_iterations.json``: the JAX package's
suite on the CPU in float64, ``scripts/torch_port_batched_reference.py``).
Prints per technique both means and the cases that differ, and exits 1 if
any case differs.  Equal counts say that where the port's float32 run on
a card and the JAX float32 run differ, the difference is float32
rounding, not the port's algebra.  ~1 GB; a few minutes on 8 cores.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from deeppreconditioning_tpu_torch.bench import irregular  # noqa: E402

FIXTURE = (REPO / "tests" / "fixtures" / "torch_port"
           / "batched_iterations.json")
RESULTS = REPO / "build" / "irregular_f64"


def main() -> None:
    ref = json.loads(FIXTURE.read_text())["irregular"]
    t0 = time.perf_counter()
    suite = irregular.irregular_suite("cpu", RESULTS, dtype=torch.float64)
    suite.timing_reps = 1
    suite.run()
    print(f"irregular split in float64 on the CPU: {len(suite.data_set)} "
          f"cases, n_pad {suite.data_set.dof_pad}, "
          f"{time.perf_counter() - t0:.1f} s; generic plan on "
          f"{sorted(suite.generic_cases['learned'])} (fixture "
          f"{ref['generic_cases']['learned']})")
    differ = False
    for name in irregular.TECHNIQUES:
        got = np.asarray(suite.iterations[name])
        want = np.asarray(ref["iterations_f64"][name])
        ok = [s == 100.0 for s in suite.successes[name]]
        cases = np.flatnonzero(got != want).tolist()
        differ |= bool(cases) or ok != ref["success"][name]
        print(f"  {name:<8} port f64 mean {got.mean():.3f}, JAX f64 "
              f"{want.mean():.3f}, JAX f32 {np.mean(ref['iterations'][name]):.3f}"
              f"; cases that differ from JAX f64: {cases}; success "
              f"{np.mean(ok) * 100:.0f}%")
    sys.exit(1 if differ else 0)


if __name__ == "__main__":
    main()
