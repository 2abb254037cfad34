#!/usr/bin/env python3
"""The host's cost of the port's tracer (``utils/tracing.py``), per call.

    python3 scripts/torch_tracing_overhead.py [--calls N] [--device cpu]

With no profiler recording it times, in ns a call (host clock over
``--calls`` back-to-back calls, the least of ``ROUNDS`` rounds): an
empty loop, the gate ``torch.autograd._profiler_enabled()``, one
``span`` entered and left, one ``count``, and one ungated
``torch.profiler.record_function`` for scale; the span and the counter
are also given with the empty loop taken off.  Then, under a
``torch.profiler`` of the CPU and the card, one ``span`` with its CUDA
event pair and one ``count``, in us a call (``ON_CALLS`` calls, the
events resolved by ``snapshot`` outside the timing).  Prints one JSON
line, with the card's name and power limit (``nvidia-smi``) on a card.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from deeppreconditioning_tpu_torch.utils import tracing  # noqa: E402

ROUNDS = 7
ON_CALLS = 2000


def _least_ns(body, calls: int) -> float:
    best = float("inf")
    for _ in range(ROUNDS):
        t0 = time.perf_counter_ns()
        body(calls)
        best = min(best, (time.perf_counter_ns() - t0) / calls)
    return best


def _loop(calls):
    for _ in range(calls):
        pass


def _gate(calls):
    enabled = torch.autograd._profiler_enabled
    for _ in range(calls):
        enabled()


def _spans(device):
    def body(calls):
        span = tracing.span
        for _ in range(calls):
            with span("pcg.chunk", device):
                pass
    return body


def _counts(calls):
    count = tracing.count
    for _ in range(calls):
        count("pcg.system_iterations", 8)


def _record_function(calls):
    record_function = torch.profiler.record_function
    for _ in range(calls):
        with record_function("pcg.chunk"):
            pass


def _card() -> dict:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name, limit = (part.strip() for part in out.split(","))
    return {"name": name, "power_limit": limit}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--calls", type=int, default=1_000_000)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: pass --device cpu", file=sys.stderr)
        return 2
    tracing.reset()
    off = {"loop": _least_ns(_loop, args.calls),
           "gate": _least_ns(_gate, args.calls),
           "span": _least_ns(_spans(device), args.calls),
           "count": _least_ns(_counts, args.calls),
           "record_function": _least_ns(_record_function,
                                        args.calls // 20)}
    assert tracing.snapshot() == {"spans": {}, "counters": {}}
    off["span_less_loop"] = off["span"] - off["loop"]
    off["count_less_loop"] = off["count"] - off["loop"]

    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=activities):
        on_span = _least_ns(_spans(device), ON_CALLS)
        on_count = _least_ns(_counts, ON_CALLS)
    snap = tracing.snapshot()
    tracing.reset()
    line = {"off_ns": off,
            "on_us": {"span": on_span * 1e-3, "count": on_count * 1e-3},
            "on_spans_recorded": snap["spans"]["pcg.chunk"]["calls"],
            "calls": args.calls, "device": str(device),
            "python": sys.version.split()[0], "torch": torch.__version__}
    if device.type == "cuda":
        line["card"] = _card()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
