"""The host setups before and after the host runtime, interleaved on the card.

    python3 scripts/torch_host_setup_timing.py [--ilu-cases 5]

On the flagship split (500 sludge cases from seed 69420, the 100-case test
split, the suite ``python -m deeppreconditioning_tpu_torch.bench``
builds) it times the same work twice in one process, once with the host
steps in the port's host runtime (``native``: IC(0), ICT, trisolve
levels) and once on their numpy versions, in the order native, numpy,
numpy, native, so that drift across the run falls on both:

* per case, every case: the incomplete_cholesky setup as the suite times
  it (``time_call`` with one warm-up and one timed run: IC(0), the two
  level schedules and their copy to the card); the incomplete_lu setup on
  the first ``--ilu-cases`` cases (the numpy ICT is dense, about a second
  a case);
* batched: ``run_batched`` for incomplete_cholesky_neumann and
  algebraic_multigrid (one timed setup build each, solve median of 5),
  whose ``total_batch`` are bench.py's batched totals; AMG's setup has no
  native step, and its per-case aggregation (``ops/amg._aggregate``) is
  timed alone beside it.

Each route's calls are checked in the host runtime's counters (native
calls and no fallback, or the reverse).  Prints the card's name and power
limit and one line per measurement (per-case medians over the cases, per
route the two runs).
"""

from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from deeppreconditioning_tpu_torch import _backend, native  # noqa: E402
from deeppreconditioning_tpu_torch.bench.__main__ import (  # noqa: E402
    SETUP_REPS,
    SOLVE_REPS,
    flagship_cases,
    flagship_suite,
)
from deeppreconditioning_tpu_torch.ops.amg import _aggregate  # noqa: E402
from deeppreconditioning_tpu_torch.utils.profiling import (  # noqa: E402
    time_call,
)

ROUTES = ("native", "numpy", "numpy", "native")
BATCHED = ("incomplete_cholesky_neumann", "algebraic_multigrid")


@contextlib.contextmanager
def route(name):
    """The host steps on ``name``'s route; checks the counters after."""
    saved = native.available
    if name == "numpy":
        native.available = lambda: False
    _backend.reset_launch_counts()
    try:
        yield
    finally:
        native.available = saved
    calls = sum(_backend.host_call_counts().values())
    fallbacks = sum(_backend.host_fallback_counts().values())
    other, own = (fallbacks, calls) if name == "native" else (calls,
                                                              fallbacks)
    if other or not own:
        raise AssertionError(f"route {name}: {calls} native calls, "
                             f"{fallbacks} numpy fallbacks")


def per_case(suite, name, cases, dev):
    """Seconds of technique ``name``'s per-case setup on ``cases``, as
    ``run`` times it."""
    setup_fn = getattr(suite, f"_setup_{name}")
    out = []
    for index in cases:
        a_sp, ell, _ = suite._system(index)
        out.append(time_call(lambda: setup_fn(index, a_sp, ell, False,
                                              timing=True), dev, reps=1))
    return out


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--ilu-cases", type=int, default=5)
    args = parser.parse_args()
    dev = _backend.device()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    native.require()
    suite = flagship_suite(
        dev, REPO / "build" / "host_setup_timing",
        ("incomplete_cholesky", "incomplete_cholesky_neumann",
         "incomplete_lu", "algebraic_multigrid"), flagship_cases())
    n_cases = len(suite.data_set)
    with route("native"):  # warm-up: allocations, library handles
        per_case(suite, "incomplete_cholesky", range(2), dev)

    ic = {r: [] for r in set(ROUTES)}
    ilu = {r: [] for r in set(ROUTES)}
    for r in ROUTES:
        with route(r):
            ic[r].append(per_case(suite, "incomplete_cholesky",
                                  range(n_cases), dev))
            ilu[r].append(per_case(suite, "incomplete_lu",
                                   range(args.ilu_cases), dev))
    for label, store, cases in (("incomplete_cholesky", ic, n_cases),
                                ("incomplete_lu", ilu, args.ilu_cases)):
        print(f"per-case {label} setup, {cases} cases, median ms per run "
              f"(native, numpy, numpy, native): " + ", ".join(
                  f"{np.median(store[r][i]) * 1e3:.3f}"
                  for r, i in zip(ROUTES, (0, 0, 1, 1)))
              + f" [{card}]")

    batched = {r: [] for r in set(ROUTES)}
    for r in ROUTES:
        with route(r):
            out = suite.run_batched(techniques=BATCHED, reps=SOLVE_REPS,
                                    setup_reps=SETUP_REPS)
            batched[r].append({k: dict(v) for k, v in out.items()})
    for name in BATCHED:
        runs = [batched[r][i][name] for r, i in zip(ROUTES, (0, 0, 1, 1))]
        print(f"batched {name} (native, numpy, numpy, native): setup ms "
              + ", ".join(f"{x['setup_batch'] * 1e3:.3f}" for x in runs)
              + "; solve ms " + ", ".join(
                  f"{x['solve_batch'] * 1e3:.3f}" for x in runs)
              + "; total ms " + ", ".join(
                  f"{x['total_batch'] * 1e3:.3f}" for x in runs)
              + f"; iterations {runs[0]['iterations']} [{card}]")
    a_sps = suite._batched_common()["a_sps"]
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        for a_sp in a_sps:
            _aggregate(a_sp.tocsr(), 0.08)
        times.append(time.perf_counter() - t0)
    print(f"batched algebraic_multigrid: the {len(a_sps)} cases' "
          f"aggregation alone (numpy, host clock, median of 3) "
          f"{np.median(times) * 1e3:.3f} ms [{card}]")


if __name__ == "__main__":
    main()
