#!/usr/bin/env python3
"""Kernel B2's per-call host path on a card, piece by piece.

    python3 scripts/torch_dia_host_path.py [--repo PATH]

On three operators, the structured trainer's batch (32 samples of 12^3,
7 bands, n_pad 2048), a 32^3 7-band operator (the size of the 128^3
multigrid's 32^3 Galerkin level) and the 128^3 7-band operator, it times:

- host microseconds per call (host clock over ``CALLS`` back-to-back
  calls, median of ``ROUNDS`` spans, each ended by a synchronize) of
  ``dia_matvec`` and of the library call ``chip_smoke.py`` holds it
  against (``csr @ x``, block-diagonal for the batch);
- the per-call time ``chip_smoke.py``'s ``measure`` reports (CUDA events
  around one call, median of ``EVENT_CALLS``) of both;
- with this checkout's port, the pieces of the wrapper alone: a cached
  launch-plan lookup, x's checks, ``torch.empty_like``, the two ways to
  read the current stream (``torch.cuda.current_stream(dev).cuda_stream``
  and ``torch._C._cuda_getCurrentRawStream(index)``), the ctypes call
  that returns at once (a null plan; bound as the port binds it, keeping
  the GIL, and the ctypes default way, releasing it), the ctypes call
  that launches (its arguments made beforehand), and one PyTorch kernel
  launch (``x.neg()``) for scale; then it checks that both stream reads
  return the capture stream inside ``torch.cuda.graph`` (where
  ``utils/profiling.time_graph`` captures B2).

``--repo`` imports ``deeppreconditioning_tpu_torch`` from another
checkout (unpacked with ``git archive`` into a git-ignored directory), so
an earlier wrapper is timed the same way in the same call; only the two
per-call rows are timed for it.  Prints the card's name and power limit.
Needs a CUDA device.
"""

import argparse
import ctypes
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
CALLS, ROUNDS, EVENT_CALLS = 2000, 5, 200


def host_us(fn, device) -> float:
    """Median host microseconds per call over ROUNDS spans of CALLS."""
    fn()
    torch.cuda.synchronize(device)
    spans = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize(device)
        spans.append((time.perf_counter() - t0) / CALLS * 1e6)
    return statistics.median(spans)


def event_us(fn, device) -> float:
    """Median of EVENT_CALLS single-call spans between CUDA events."""
    fn()
    torch.cuda.synchronize(device)
    times = []
    for _ in range(EVENT_CALLS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3)
    return statistics.median(times)


def pieces(dia_spmv, lib, a, x, dev) -> dict:
    """Host microseconds of each piece of the launch-plan wrapper."""
    plan = dia_spmv.launch_plan(a)
    vals, index = a.vals, dev.index

    def lookup():
        return a.launch_plan.key == (vals.data_ptr(), vals.shape,
                                     vals.dtype, vals.device)

    def x_checks():
        return (x.get_device() != plan.device_index
                or x.dtype != torch.float32 or x.shape != plan.x_shape
                or not x.is_contiguous() or (torch.is_grad_enabled()
                                             and x.requires_grad))

    released = ctypes.CFUNCTYPE(ctypes.c_int, *[ctypes.c_void_p] * 5)(
        ("dp_dia_spmv_f32", lib))
    y = torch.empty_like(x)
    args = (plan.key[0], x.data_ptr(), y.data_ptr(), plan.params_ptr,
            torch._C._cuda_getCurrentRawStream(index))
    return {
        "plan lookup": host_us(lookup, dev),
        "x checks": host_us(x_checks, dev),
        "empty_like": host_us(lambda: torch.empty_like(x), dev),
        "current_stream().cuda_stream": host_us(
            lambda: torch.cuda.current_stream(dev).cuda_stream, dev),
        "_cuda_getCurrentRawStream": host_us(
            lambda: torch._C._cuda_getCurrentRawStream(index), dev),
        "ctypes call, null plan": host_us(
            lambda: lib.dp_dia_spmv_f32(0, 0, 0, 0, 0), dev),
        "the same, releasing the GIL": host_us(
            lambda: released(0, 0, 0, 0, 0), dev),
        "ctypes call, launch": host_us(
            lambda: lib.dp_dia_spmv_f32(*args), dev),
        "x.neg()": host_us(x.neg, dev),
    }


def check_capture(dia_spmv, a, x, dev) -> None:
    """Both stream reads name the capture stream while a graph captures."""
    index = dev.index
    outside = torch._C._cuda_getCurrentRawStream(index)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        raw = torch._C._cuda_getCurrentRawStream(index)
        wrapped = torch.cuda.current_stream(dev).cuda_stream
        y = dia_spmv.dia_matvec(a, x)
    graph.replay()
    torch.cuda.synchronize(dev)
    same = torch.equal(y, a.matvec(x))
    print(f"under capture: raw stream {raw:#x}, current_stream "
          f"{wrapped:#x}, outside {outside:#x}; replay equals the plain "
          f"product: {same}")
    if raw != wrapped or raw == outside or not same:
        raise AssertionError("the raw stream does not follow the capture")


@torch.no_grad()
def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repo", default=str(REPO))
    args = parser.parse_args()
    port = Path(args.repo).resolve()
    sys.path.insert(0, str(port))
    from deeppreconditioning_tpu_torch import _backend
    from deeppreconditioning_tpu_torch.data.poisson import poisson_coeff_dia
    from deeppreconditioning_tpu_torch.ops import dia_spmv
    from deeppreconditioning_tpu_torch.train import structured
    sys.path.insert(1, str(REPO))
    from chip_smoke import card_line, dia_csr

    dev = _backend.device()
    card = card_line()
    print(f"port from {port}; card: {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    lib = _backend.kernel_library()
    with_plan = hasattr(dia_spmv, "launch_plan")
    a, _ = structured.make_data((12, 12, 12), 32, (1.0, 1.0), "random", 69,
                                device=dev)
    rng = np.random.default_rng(0)
    operators = [("batched 32 x 7 x 2048", a)] + [
        (f"{side}^3 7 bands", poisson_coeff_dia((side,) * 3, rng=rng,
                                               device=dev))
        for side in (32, 128)]
    for label, a in operators:
        x = torch.randn(tuple(a.vals.shape[:-2]) + (a.n_pad,), device=dev)
        csr = dia_csr(a)
        flat = x.reshape(-1)
        rows = {
            "dia_matvec": (host_us(lambda: dia_spmv.dia_matvec(a, x), dev),
                           event_us(lambda: dia_spmv.dia_matvec(a, x), dev)),
            "library csr @ x": (host_us(lambda: csr @ flat, dev),
                                event_us(lambda: csr @ flat, dev)),
        }
        head = label
        if with_plan:
            geom = dia_spmv.launch_plan(a).geometry
            head += (f": tile {geom.tile} rows ({geom.threads} threads x "
                     f"{geom.rows}), grid {geom.tiles} x {geom.batch}, "
                     f"windows {[4 * c for _, c, _ in geom.windows]} "
                     f"floats, {geom.smem_bytes} B shared")
        print(f"{head} [{card}]")
        for name, (host, event) in rows.items():
            print(f"  {name:<30} host {host:7.2f} us a call, events "
                  f"{event:7.2f} us a call")
        if with_plan:
            print("  pieces (host us a call): " + ", ".join(
                f"{name} {us:.2f}"
                for name, us in pieces(dia_spmv, lib, a, x, dev).items()))
    if with_plan:
        check_capture(dia_spmv, a, x, dev)
    print(card_line())


if __name__ == "__main__":
    main()
