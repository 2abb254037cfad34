"""Readers of the products with the system's operator inside the PCG
solves: the kernel B2 launches at the operator's band count
(``dia_spmv_kernel<bands, R>``) made while a ``pcg.solve`` span of the
port was open on the host.

A kernel belongs to a solve by the host time of the call that launched it
(a ``cudaLaunchKernel``, or the ``cudaGraphLaunch`` that replayed it),
matched through the correlation id the profiler gives both, and not by
the kernel's own start: the card's clock sits up to a millisecond off the
host's in a trace, enough to move a solve's first products out of its
span.  The chrome trace of the run is read again for those ids (the
harness keeps none), found by the cell's configuration and mix names in
``BENCHMARK.json``; a kernel whose launch call is missing gives None.

The runner names the operator's band count (``Cell.operator_bands``) and
the least work of one product (``Cell.operator_work()``).  The count of
those launches must equal the port's counter ``pcg.operator_products``
(the products the solves enqueued, the preconditioner's included), or
the readers give None: launches of another operator with the same band
count, or a port without the counter.
"""

from __future__ import annotations

import bisect
import json
import re

from portbench.harness.loop import OUT_DIR
from portbench.harness.program import recorded
from portbench.harness.spec import ROOT

KERNEL = re.compile(r"dia_spmv_kernel<(\d+),")
SOLVE = "pcg.solve"


def trace_path(view):
    """The chrome trace the harness wrote for the view's cell, or None."""
    names = (view.cell.config.get("name"), view.cell.traffic.get("name"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        if (w["config"], w["traffic"]) == names:
            return OUT_DIR / f"{w['name']}.trace.json"
    return None


def solve_kernels(events: list, bands: int):
    """(operator launches' seconds, their count, every kernel's seconds)
    of the kernels launched inside a ``pcg.solve`` span, from a chrome
    trace's events; None without a span, or where a kernel's launch call
    is not in the events."""
    launched, solves, kernels = {}, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat"), e.get("args") or {}
        if cat == "kernel":
            kernels.append((e.get("name", ""), args.get("correlation"),
                            float(e.get("dur", 0.0))))
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launched[args["correlation"]] = float(e["ts"])
        elif cat == "user_annotation" and e.get("name") == SOLVE:
            a = float(e["ts"])
            solves.append((a, a + float(e.get("dur", 0.0))))
    if not solves:
        return None
    solves.sort()
    starts = [a for a, _ in solves]
    op_us = all_us = 0.0
    launches = 0
    for name, corr, dur in kernels:
        t = launched.get(corr)
        if t is None:
            return None
        i = bisect.bisect_right(starts, t) - 1
        if i < 0 or t > solves[i][1]:
            continue
        all_us += dur
        hit = KERNEL.search(name)
        if hit and int(hit.group(1)) == bands:
            op_us += dur
            launches += 1
    return op_us * 1e-6, launches, all_us * 1e-6


def _checked(view):
    """``solve_kernels`` of the view's trace where its launches are the
    port's operator products, else None; read once a view."""
    if "operator_kernels" not in vars(view):
        view.operator_kernels = None
        bands = getattr(view.cell, "operator_bands", None)
        snap = recorded(view)
        path = trace_path(view) if bands is not None else None
        if (snap is not None and view.peaks is not None and view.records
                and path is not None and path.is_file()):
            got = solve_kernels(
                json.loads(path.read_text())["traceEvents"], bands)
            products = snap["counters"].get("pcg.operator_products", 0)
            if got is not None and got[0] > 0 and got[1] == products:
                view.operator_kernels = got
    return view.operator_kernels


def operator_roofline(view):
    """The operator products' share of their roofline, in %: the least
    time of the products counted over the device time of their
    launches."""
    got = _checked(view)
    if got is None:
        return None
    seconds, launches, _ = got
    return 100.0 * launches * view.cell.operator_work().bound_s(
        view.peaks) / seconds


def operator_share(view):
    """100 x the operator products' device time over the device time of
    every kernel launched inside the ``pcg.solve`` spans, in %."""
    got = _checked(view)
    if got is None or got[2] <= 0:
        return None
    return 100.0 * got[0] / got[2]
