"""One run of one cell: set-up, the measured window, the check, the line.

The loop is closed with one caller: request k starts when the harness
calls the port (after the runner's untimed ``prepare`` and a
synchronize) and ends after ``torch.cuda.synchronize()`` with the
request's results on the card.  A request fails if a system in it did not
reach the tolerance, if a plain version or a numpy fallback ran on the
card while it ran (the port's ``_backend`` counters), or if its sampled
comparison with the reference failed; it then counts in ``failed`` and as
an infinite latency in the tail.

With ``trace`` the window runs as without it, and ``torch.profiler``
(CPU and CUDA activities) covers the requests of a steady slice of it:
from the mix's ``trace_start_s`` into the window, for ``trace_slice_s``
after the profiler has started (a window that ends inside the slice is
drawn out to its end); the per-layer
metrics and the breakdown are read from that slice, CUDA events time the
runner's spans there, and the chrome trace is written under
``portbench/out/``.
"""

from __future__ import annotations

import contextlib
import gc
import math
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from portbench.harness import spec as spec_mod
from portbench.harness.trace import read_chrome_trace
from portbench.work import card_peaks

JAX_NAMES = ("jax", "jaxlib", "flax", "deeppreconditioning_tpu")
REQUEST_ANNOTATION = "portbench.request"
OUT_DIR = spec_mod.BENCH_DIR / "out"


class Spans:
    """The runner's spans around its calls into the port: CUDA events
    and a profiler label while a traced request runs, nothing otherwise."""

    def __init__(self, device: torch.device) -> None:
        self.on = False
        self.events: list = []
        self.cuda = device.type == "cuda"

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        with torch.profiler.record_function(f"portbench.{name}"):
            if self.cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                yield
                end.record()
            else:  # the CPU tests: the host clock is the device clock
                start = time.perf_counter()
                yield
                end = time.perf_counter()
        self.events.append((name, start, end))

    def collect(self) -> dict:
        """Milliseconds by span name of the finished request."""
        out = {}
        for name, start, end in self.events:
            ms = (start.elapsed_time(end) if self.cuda
                  else (end - start) * 1e3)
            out[name] = out.get(name, 0.0) + ms
        self.events = []
        return out


@dataclass
class Record:
    k: int
    seconds: float
    outcome: object  # the runner's summary: no large tensor
    fault: bool = False  # a plain version or fallback ran on the card
    traced: bool = False
    spans: dict = field(default_factory=dict)
    systems: int = 0
    converged: int = 0
    iterations: list = field(default_factory=list)
    info: dict = field(default_factory=dict)  # the runner's, for ``work``
    failed: bool = False


@dataclass
class View:
    """What a per-layer metric's reader reads."""

    records: list  # the traced slice's requests
    trace: object  # DeviceTrace
    cell: object  # the runner's Cell
    peaks: object  # CardPeaks
    launch_counts: dict  # the port's kernel launches over the slice


def _counter_total(backend) -> int:
    return (sum(backend.plain_cuda_counts().values())
            + sum(backend.host_fallback_counts().values()))


def jax_modules() -> list:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(JAX_NAMES))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _percentile(values: list, q: float) -> float:
    """The q-th percentile with linear interpolation; inf stays inf."""
    if not values:
        return float("nan")
    v = np.sort(np.asarray(values, dtype=np.float64))
    pos = (len(v) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    if lo == hi or v[hi] == v[lo]:
        return float(v[lo])
    if math.isinf(v[hi]):
        return float("inf")
    return float(v[lo] + (v[hi] - v[lo]) * (pos - lo))


@dataclass
class RunResult:
    line: dict
    checks: list  # (name, value, limit)
    records: list
    cell: object = None  # the runner's Cell, its program state released
    kept: dict = field(default_factory=dict)  # the sampled requests
    samples: dict = field(default_factory=dict)  # k -> compared numbers


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             start_time: float, device=None, root=spec_mod.ROOT,
             bench_dir=spec_mod.BENCH_DIR, sizes: dict | None = None,
             fault: str | None = None) -> RunResult:
    """Run ``workload`` once.  ``device`` None takes the card (the
    benchmark's runs); the CPU tests pass "cpu", ``sizes`` overrides of
    the configuration's and the mix's numbers, and ``fault`` a fault to
    plant in the timed path (``runners``' ``FAULTS``)."""
    from deeppreconditioning_tpu_torch import _backend

    spec = spec_mod.load_cell(workload, root, bench_dir)
    config, traffic = dict(spec.config), dict(spec.traffic)
    for key, value in (sizes or {}).items():
        (traffic if key in traffic else config)[key] = value
    device = torch.device("cuda", 0) if device is None else torch.device(
        device)
    runner = spec_mod.load_runner(traffic["runner"], bench_dir)
    spans = Spans(device)
    cell = runner.Cell(config, traffic, seed, device, spans, fault=fault)
    cell.warm()
    _sync(device)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    sample_rng = np.random.default_rng([int(seed), 3])
    sampled = {0} | set(sample_rng.choice(
        int(traffic["sample_within"]), size=int(traffic["sample_requests"]),
        replace=False).tolist())

    profiler, slice_t0, slice_done = None, None, not trace
    t_start = float(traffic.get("trace_start_s", 0.0))
    t_len = float(traffic.get("trace_slice_s", 0.0))
    if t_start >= seconds:
        t_start = 0.0
    records, kept = [], {}
    launches_before = launches_after = None
    counter = _counter_total(_backend)
    setup_s = time.perf_counter() - start_time
    gc.disable()  # no collector pause inside the window
    w0 = time.perf_counter()
    k = 0
    while True:
        now = time.perf_counter() - w0
        if k and now >= seconds and slice_done:
            break
        if not slice_done and profiler is None and now >= t_start:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=activities)
            profiler.start()
            launches_before = _backend.launch_counts()
            spans.on = True
            slice_t0 = time.perf_counter()
        elif profiler is not None and (
                time.perf_counter() - slice_t0 >= t_len):
            profiler.stop()
            launches_after = _backend.launch_counts()
            spans.on, slice_done = False, True
            trace_profiler, profiler = profiler, None
            continue
        inputs = cell.prepare(k)
        _sync(device)
        t0 = time.perf_counter()
        with (torch.profiler.record_function(REQUEST_ANNOTATION)
              if spans.on else contextlib.nullcontext()):
            outcome = cell.request(k, inputs)
            _sync(device)
        t1 = time.perf_counter()
        total = _counter_total(_backend)
        if k in sampled:
            kept[k] = cell.keep(k, outcome)
        rec = Record(k, t1 - t0, cell.summarize(outcome),
                     fault=total != counter, traced=spans.on)
        del outcome  # the program's results go unless sampled
        counter = total
        if spans.on:
            rec.spans = spans.collect()
        records.append(rec)
        k += 1
    window_s = time.perf_counter() - w0
    gc.enable()
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)

    for rec in records:
        rec.systems, rec.converged, rec.iterations, rec.info = (
            cell.outcome(rec.outcome))
        rec.failed = rec.fault or rec.converged < rec.systems
    trace_view = None
    if trace:
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        path = OUT_DIR / f"{workload}.trace.json"
        trace_profiler.export_chrome_trace(str(path))
        del trace_profiler
        dev_trace = read_chrome_trace(path, REQUEST_ANNOTATION)
        slice_records = [r for r in records if r.traced]
        trace_view = View(
            slice_records, dev_trace, cell,
            card_peaks(torch.cuda.get_device_name(device))
            if device.type == "cuda" else None,
            {key: launches_after[key] - launches_before[key]
             for key in launches_after})
    mods = jax_modules()

    # the check: the program's state goes first, then the reference runs
    cell.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks, sample_values = cell.check(kept)
    for k_s, values in sample_values.items():
        if any(values[name] > limit or not math.isfinite(values[name])
               for name, limit in cell.limits.items() if name in values):
            records[k_s].failed = True

    failed = sum(r.failed for r in records)
    lat_ms = [math.inf if r.failed else r.seconds * 1e3 for r in records]
    solved = sum(r.systems for r in records if not r.failed)
    stepped = sum(r.systems for r in records)
    rate, p95 = solved / window_s, _percentile(lat_ms, 95)
    e2e = {"setup_s": setup_s, "solves_per_s": rate, "solve_p95_ms": p95,
           "case_solves_per_s": rate, "case_solve_p95_ms": p95,
           "train_cases_per_s": stepped / window_s}
    metrics, breakdown = {}, None
    if trace:
        for m in spec.per_layer:
            value = spec_mod.load_reader(m["name"], bench_dir)(trace_view)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        breakdown = trace_view.trace.breakdown()
    else:
        for m in spec.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]],
                                  "unit": m["unit"]}
    correct = (failed == 0 and not mods
               and all(v <= lim for _, v, lim in checks))
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": spec.chips, "memory_peak_bytes": int(memory_peak)}
    if trace_view is not None:
        dev["busy_s"] = trace_view.trace.busy_s
        dev["window_s"] = trace_view.trace.window_s
    line = {"correct": bool(correct), "attempted": len(records),
            "failed": int(failed), "metrics": metrics, "device": dev}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["route"] = cell.route()
    line["window_s"] = window_s
    if mods:
        line["jax_modules"] = mods
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, value, limit in checks}
    return RunResult(line, checks, records, cell, kept, sample_values)
