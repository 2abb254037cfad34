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
``RooflineReport`` relates a time to the card's HBM bandwidth.  Every
peak of the card comes from one lookup by its name (``card_peaks``).

A kernel's *kernel-only* time (``time_graph``) replays a CUDA graph of
back-to-back launches, so no host time between launches enters it.  Its
bound (``KernelWork.bound``) is the least time the card could take for the
same work: the larger of its minimum bytes over the HBM bandwidth and its
flops over the peak of the units it runs on (float32 outside the tensor
cores, or 3xTF32 on them; float64 outside them, ``fp64_tflop_s``);
``gauss_jordan_work``, ``dia_work`` and
``bsr_work`` count the bytes and flops that the inputs need.
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
GRAPH_CALLS, GRAPH_ROUNDS = 20, 5  # launches per graph, timed replays


@dataclass(frozen=True)
class CardPeaks:
    """A card's published peaks: HBM bandwidth (GB/s), dense float32 outside
    the tensor cores and dense TF32 on them (TFLOP/s)."""

    hbm_gb_s: float
    fp32_tflop_s: float
    tf32_tflop_s: float

    @property
    def tf32x3_tflop_s(self) -> float:
        """A 3xTF32 product issues three TF32 products per float32 one."""
        return self.tf32_tflop_s / 3


# NVIDIA data sheets, dense rates without sparsity; more specific names
# first, since every entry is matched as a substring.
CARD_PEAKS = (
    ("H100 NVL", CardPeaks(3900.0, 60.0, 417.5)),
    ("H100 PCIe", CardPeaks(2000.0, 51.0, 378.0)),
    ("H100", CardPeaks(3350.0, 67.0, 495.0)),  # SXM5: "NVIDIA H100 80GB HBM3"
    ("H200", CardPeaks(4800.0, 67.0, 495.0)),
)


# Dense float64 outside the tensor cores (TFLOP/s; NVIDIA data sheets):
# the rate of B1's float64 instance, whose multiply-adds are scalar DFMAs
# (the FP64 tensor-core rate, twice this, is for matrix products).
FP64_TFLOP_S = (("H100 NVL", 30.0), ("H100 PCIe", 26.0), ("H100", 34.0),
                ("H200", 34.0))


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


def time_graph(fn: Callable[[], object], device: torch.device) -> float:
    """Kernel-only seconds per call of ``fn()`` on a CUDA device:
    ``GRAPH_CALLS`` launches captured in one CUDA graph after a warm-up call
    on a side stream, median of ``GRAPH_ROUNDS`` timed replays.  The
    operands are the same in every launch (resident)."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn()
    graph.replay()
    torch.cuda.synchronize(device)
    times = []
    for _ in range(GRAPH_ROUNDS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e-3 / GRAPH_CALLS)
    del graph
    return statistics.median(times)


def cold_pool_size(operand_bytes: int) -> int:
    """Copies of an operand whose total exceeds twice the L2 (at least
    two, so no call reads the operand the previous call left in L2)."""
    return max(2, math.floor(2 * L2_BYTES / operand_bytes) + 1)


def card_peaks(device_name: str) -> CardPeaks:
    """The card's published peaks, from its name."""
    for key, peaks in CARD_PEAKS:
        if key in device_name:
            return peaks
    raise ValueError(f"peaks of {device_name!r} are not known")


def fp64_tflop_s(device_name: str) -> float:
    """The card's published float64 rate outside the tensor cores."""
    for key, rate in FP64_TFLOP_S:
        if key in device_name:
            return rate
    raise ValueError(f"peaks of {device_name!r} are not known")


def hbm_bandwidth_gb_s(device_name: str) -> float:
    """The card's published HBM bandwidth in GB/s, from its name."""
    return card_peaks(device_name).hbm_gb_s


@dataclass(frozen=True)
class KernelWork:
    """The least a kernel call must do: bytes moved (each input read once,
    each output written once) and flops."""

    bytes: int
    flops: int

    def bound(self, hbm_gb_s: float, tflop_s: float) -> tuple[float, str]:
        """(seconds, roof): the larger of bytes over ``hbm_gb_s`` and flops
        over ``tflop_s``, and which of the two ("bytes" or "operations")
        binds."""
        by_bytes = self.bytes / (hbm_gb_s * 1e9)
        by_flops = self.flops / (tflop_s * 1e12)
        if by_flops > by_bytes:
            return by_flops, "operations"
        return by_bytes, "bytes"


def gauss_jordan_work(n: int, w: int, itemsize: int = 4) -> KernelWork:
    """B1 on n systems of width w: read S (w x w) and e (w), write y (w),
    ``itemsize`` bytes an element (4 float32, 8 float64).  Unpivoted
    Gauss–Jordan on [S | e] updates, at step k, columns k + 1 .. w of the
    w - 1 other rows: (w - 1) w (w + 1) flops per system."""
    return KernelWork(bytes=itemsize * n * (w * w + 2 * w),
                      flops=(w - 1) * w * (w + 1) * n)


def dia_work(bands: int, n_pad: int) -> KernelWork:
    """B2 on ``bands`` bands of n_pad rows: read the bands and x, write y;
    one multiply-add per band and row."""
    return KernelWork(bytes=4 * (bands + 2) * n_pad,
                      flops=2 * bands * n_pad)


def bsr_work(blocks: int, n_pad: int, bs: int, m: int) -> KernelWork:
    """B3 on the ``blocks`` non-sentinel blocks of size bs and m columns:
    read those blocks, X (n_pad x m) and write Y once; 2 bs^2 m flops per
    block.  A slot that holds the sentinel adds zero, so the product needs
    neither its bytes nor its flops."""
    return KernelWork(bytes=4 * (blocks * bs * bs + 2 * n_pad * m),
                      flops=2 * blocks * bs * bs * m)


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
