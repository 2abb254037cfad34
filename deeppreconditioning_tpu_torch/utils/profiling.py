"""Timing of synchronized calls and the roofline of streaming kernels.

On a CUDA device each timed span is bracketed by CUDA events recorded on
the current stream and read after the end event completes, so the time
covers the device work the calls enqueued (host waits inside a call, such
as PCG's once-per-chunk read, included).  On the CPU the host clock is the
device clock.  Either way the result is the time on the device the
tensors live on, and callers report that device next to it.

Two protocols for a streaming kernel (``time_stream``): *resident* repeats
one operand, which the 50 MB L2 may then hold between calls; *cold*
cycles a pool of operand copies whose total exceeds twice the L2
(``cold_pool_size``), so every call reads its operand from HBM.
``RooflineReport`` relates a time to the card's HBM bandwidth, looked up
from the card's name (``hbm_bandwidth_gb_s``).
"""

from __future__ import annotations

import math
import statistics
import time
from dataclasses import dataclass
from typing import Callable, Sequence

import torch

L2_BYTES = 50 * 1000 * 1000  # H100 L2 cache
STREAM_CALLS, STREAM_ROUNDS = 50, 5  # calls per timed span, spans
# Published HBM bandwidth per card (NVIDIA data sheets); more specific
# names first, since every entry is matched as a substring.
HBM_GB_S = (
    ("H100 NVL", 3900.0),
    ("H100 PCIe", 2000.0),
    ("H100", 3350.0),  # SXM5, HBM3: "NVIDIA H100 80GB HBM3"
    ("H200", 4800.0),
)


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_call(fn: Callable[[], object], device: torch.device,
              reps: int = 3, warmup: int = 1) -> float:
    """Median seconds of ``fn()`` over ``reps`` runs after ``warmup``."""
    for _ in range(warmup):
        fn()
    synchronize(device)
    times = []
    for _ in range(max(reps, 1)):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e-3)
        else:
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _span_seconds(fn: Callable[[int], object], device: torch.device,
                  calls: int) -> float:
    """Seconds of ``fn(0) ... fn(calls - 1)`` back to back (one timed
    span, events on a CUDA device)."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(calls):
            fn(i)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e-3
    t0 = time.perf_counter()
    for i in range(calls):
        fn(i)
    return time.perf_counter() - t0


def time_stream(fn: Callable[..., object], pool: Sequence[tuple],
                device: torch.device) -> float:
    """Per-call seconds of ``fn(*pool[i % len(pool)])`` over
    ``STREAM_CALLS`` back-to-back calls, median of ``STREAM_ROUNDS``
    spans after one warm-up call per pool entry.  One pool entry is the
    resident protocol; a pool of ``cold_pool_size`` copies is the cold
    one."""
    for args in pool:
        fn(*args)
    synchronize(device)
    spans = [
        _span_seconds(lambda i: fn(*pool[i % len(pool)]), device,
                      STREAM_CALLS)
        for _ in range(STREAM_ROUNDS)
    ]
    return statistics.median(spans) / STREAM_CALLS


def cold_pool_size(operand_bytes: int) -> int:
    """Copies of an operand whose total exceeds twice the L2 (at least
    two, so no call reads the operand the previous call left in L2)."""
    return max(2, math.floor(2 * L2_BYTES / operand_bytes) + 1)


def hbm_bandwidth_gb_s(device_name: str) -> float:
    """The card's published HBM bandwidth in GB/s, from its name."""
    for key, gb_s in HBM_GB_S:
        if key in device_name:
            return gb_s
    raise ValueError(f"HBM bandwidth of {device_name!r} is not known")


@dataclass
class RooflineReport:
    """Measured against light-speed throughput for a streaming kernel."""

    name: str
    seconds: float
    nnz: int
    bytes_moved: int
    flops: int
    hbm_gb_s: float

    @property
    def gnnz_per_s(self) -> float:
        return self.nnz / self.seconds / 1e9

    @property
    def achieved_gb_s(self) -> float:
        return self.bytes_moved / self.seconds / 1e9

    @property
    def bandwidth_fraction(self) -> float:
        return self.achieved_gb_s / self.hbm_gb_s

    def summary(self) -> dict:
        return {
            "kernel": self.name,
            "time_us": self.seconds * 1e6,
            "gnnz_per_s": self.gnnz_per_s,
            "achieved_gb_s": self.achieved_gb_s,
            "bandwidth_fraction": self.bandwidth_fraction,
            "gflop_per_s": self.flops / self.seconds / 1e9,
        }
