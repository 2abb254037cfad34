"""The traced slice: ``torch.profiler`` over a steady part of the window,
and what the harness reads from its chrome trace.

Device activity is every event of the categories ``kernel``,
``gpu_memcpy`` and ``gpu_memset``; ``busy_s`` is the length of their
union inside the slice.  Launch calls are the CUDA API calls that start
a kernel or a graph, counted inside the requests' annotations (not in
the harness's work between them).  An idle gap is a stretch of the
slice with no device activity, named by the innermost host operation
that was running at its middle.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_WORDS = ("LaunchKernel", "GraphLaunch", "LaunchCooperativeKernel")


@dataclass
class DeviceTrace:
    kernels: list  # (name, start_us, dur_us)
    intervals: list  # merged (start_us, end_us) of device activity
    launch_calls: int  # inside the requests' annotations
    host_ops: list  # (start_us, end_us, name) on the busiest host thread
    t0_us: float
    t1_us: float
    per_name: dict = field(default_factory=dict)  # name -> seconds

    @property
    def window_s(self) -> float:
        return (self.t1_us - self.t0_us) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.intervals) * 1e-6

    def kernel_seconds(self, word: str) -> tuple[float, int]:
        """(seconds, launches) of the kernels whose name holds ``word``."""
        hits = [d for name, _, d in self.kernels if word in name]
        return sum(hits) * 1e-6, len(hits)

    def idle_gaps(self) -> list:
        """[(start_us, end_us)] between device activity, slice ends
        included."""
        gaps, cursor = [], self.t0_us
        for a, b in self.intervals:
            if a > cursor:
                gaps.append((cursor, a))
            cursor = max(cursor, b)
        if self.t1_us > cursor:
            gaps.append((cursor, self.t1_us))
        return gaps

    def host_ops_at(self, times: list) -> list:
        """The innermost host operation running at each of ``times``
        (sorted), by one sweep over the nested operations."""
        ops = sorted(self.host_ops, key=lambda o: (o[0], -o[1]))
        out, stack, i = [], [], 0
        for t in times:
            while i < len(ops) and ops[i][0] <= t:
                stack.append(ops[i])
                i += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            out.append(stack[-1][2] if stack else "host: no operation")
        return out

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.per_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = self.idle_gaps()
        names = self.host_ops_at([0.5 * (a + b) for a, b in gaps])
        by_host = {}
        for (a, b), name in zip(gaps, names):
            by_host[name] = by_host.get(name, 0.0) + (b - a) * 1e-6
        gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[n[:160], s] for n, s in gaps]}


def read_chrome_trace(path: Path, bounds: str) -> DeviceTrace:
    """Parse an exported trace.  The slice runs from the start of the
    first host annotation named ``bounds`` to the end of the last."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    dev, kernels, host, launches, spans = [], [], {}, [], []
    lo, hi = float("inf"), float("-inf")  # of the ``bounds`` annotations
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat"), e.get("name", "")
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((a, b))
            if cat == "kernel":
                kernels.append((name, a, b - a))
        elif cat in ("cuda_runtime", "cuda_driver"):
            if any(word in name for word in LAUNCH_WORDS):
                launches.append(a)
        elif cat in ("cpu_op", "user_annotation"):
            host.setdefault(e.get("tid"), []).append((a, b, name))
            if name == bounds:
                lo, hi = min(lo, a), max(hi, b)
                spans.append((a, b))
    if lo > hi:
        raise ValueError(f"no {bounds!r} annotation in {path}")
    t0, t1 = lo, hi
    merged = []
    for a, b in sorted(dev):
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    per_name = {}
    for name, _, d in kernels:
        per_name[name] = per_name.get(name, 0.0) + d * 1e-6
    main = max(host.values(), key=len) if host else []
    return DeviceTrace(kernels, [tuple(m) for m in merged],
                       _count_inside(sorted(launches), sorted(spans)), main,
                       t0, t1, per_name)


def _count_inside(times: list, spans: list) -> int:
    """How many of ``times`` (sorted) fall inside one of ``spans``
    (sorted, disjoint)."""
    count, i = 0, 0
    for t in times:
        while i < len(spans) and spans[i][1] < t:
            i += 1
        if i < len(spans) and spans[i][0] <= t:
            count += 1
    return count
