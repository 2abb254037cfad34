"""The reader of the device kernels a multigrid V-cycle costs inside the
PCG solves: every kernel launched while a ``pcg.solve`` span of the port
was open on the host, over the cycles those solves ran.  The apply is one
V-cycle, made at the start of a solve and in each iteration executed,
masked ones included, so the cycles are the port's counter
``pcg.system_iterations`` plus the calls of its span ``pcg.solve``.

A kernel belongs to a solve by the host time of the call that launched
it, matched through the profiler's correlation id, as in
``harness/operators.py``, whose trace lookup this reads (the chrome trace
the harness wrote for the view's cell).  The count holds each
iteration's own kernels too (the operator product, dots and updates): it
is the chain of kernels a cycle and its iteration put on the card, which a
fused smoother or coarse cycle would shorten.  None without the counter
or the span, without a card, or where a kernel's launch call is missing
from the trace.
"""

from __future__ import annotations

import bisect
import json

from portbench.harness import operators
from portbench.harness.program import recorded


def solve_kernel_count(events: list):
    """How many kernels were launched inside a ``pcg.solve`` span, from a
    chrome trace's events; None without a span, or where a kernel's
    launch call is not in the events."""
    launched, solves, kernels = {}, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat"), e.get("args") or {}
        if cat == "kernel":
            kernels.append(args.get("correlation"))
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launched[args["correlation"]] = float(e["ts"])
        elif cat == "user_annotation" and e.get("name") == operators.SOLVE:
            a = float(e["ts"])
            solves.append((a, a + float(e.get("dur", 0.0))))
    if not solves:
        return None
    solves.sort()
    starts = [a for a, _ in solves]
    count = 0
    for corr in kernels:
        t = launched.get(corr)
        if t is None:
            return None
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= solves[i][1]:
            count += 1
    return count


def kernels_per_cycle(view):
    """Kernels launched inside the solves over the cycles they ran."""
    snap = recorded(view)
    if snap is None or view.peaks is None or not view.records:
        return None
    solves = snap["spans"].get(operators.SOLVE, {}).get("calls", 0)
    iterations = snap["counters"].get("pcg.system_iterations", 0)
    cycles = iterations + solves if iterations and solves else 0
    path = operators.trace_path(view)
    if cycles <= 0 or path is None or not path.is_file():
        return None
    count = solve_kernel_count(json.loads(path.read_text())["traceEvents"])
    return None if count is None else count / cycles
