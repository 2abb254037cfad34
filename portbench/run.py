"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout.  The cell, its configuration, its
traffic mix and its per-layer metrics are found by name from
``BENCHMARK.json`` (see ``portbench/README.md``).  The last line of
standard output is the result, one JSON object; the numbers compared
with the reference, each beside its limit, are also the last lines of
standard error.  Exits 2 on a bad argument, 3 without the CUDA cards the
cell asks for, 4 if the port cannot be imported, 5 if ``jax``,
``jaxlib``, ``flax`` or the JAX package was loaded, 6 if the run failed;
none of these prints a result.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _say(*lines) -> None:
    for line in lines:
        print(line, file=sys.stderr, flush=True)


def _finite(obj):
    """JSON has no infinity: an infinite tail reads as 1e300."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return 1e300 if obj > 0 else -1e300
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_finite(v) for v in obj]
    return obj


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    # the caches of the port stay inside the checkout, at fixed paths
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(ROOT / "build" / "triton_cache"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    from portbench.harness.spec import load_cell

    try:
        chips = load_cell(args.workload).chips
    except (KeyError, FileNotFoundError) as err:
        _say(f"portbench: {err}")
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _say(f"portbench: the cell needs {chips} CUDA device(s); "
             f"cuda available {torch.cuda.is_available()}, "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
             " found")
        return 3
    try:
        import deeppreconditioning_tpu_torch  # noqa: F401
    except ImportError as err:
        _say(f"portbench: the port does not import: {err}")
        return 4
    from portbench.harness.loop import jax_modules, run_cell

    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), START)
    except Exception as err:  # noqa: BLE001  (the reason, then no result)
        import traceback

        traceback.print_exc()
        _say(f"portbench: the run failed: {err!r}")
        return 6
    found = jax_modules()
    if found:
        _say(f"portbench: loaded in this process: {', '.join(found)}")
        return 5
    _say(*(f"check {name} {value!r} limit {limit!r}"
           for name, value, limit in result.checks))
    print(json.dumps(_finite(result.line)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
