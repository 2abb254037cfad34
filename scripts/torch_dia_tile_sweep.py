#!/usr/bin/env python3
"""Kernel B2's kernel-only time for every tile it can take, on a card.

    python3 scripts/torch_dia_tile_sweep.py [--operators NAME,...] [--rows R]

On the operators ``chip_smoke.py`` checks B2 on (the SpMV section's
512^2, 128^3, 256^3 and 128^3 factor halves, the Galerkin levels of the
128^3 scaling operator, the structured trainer's batch and its A^T), for
every rows-per-thread R and CTA size the launch plan allows
(``ops/dia_spmv.tile_geometry`` with ``rows`` and ``threads`` pinned), it
checks the result bit for bit against the plain version and prints the
kernel-only time (``utils/profiling.time_graph``: 20 launches in a CUDA
graph, median of 5 replays) beside the bound; the plan's own choice is
marked.  For scale it also times the floor of a launch in such a graph:
one PyTorch kernel on a single float.  Prints the card's name and power
limit.  Needs a CUDA device.
"""

import argparse
import ctypes
import dataclasses
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from chip_smoke import card_line  # noqa: E402
from deeppreconditioning_tpu_torch import _backend  # noqa: E402
from deeppreconditioning_tpu_torch.bench import scaling  # noqa: E402
from deeppreconditioning_tpu_torch.bench.spmv import (  # noqa: E402
    spmv_operators,
)
from deeppreconditioning_tpu_torch.ops import dia_spmv  # noqa: E402
from deeppreconditioning_tpu_torch.ops.gmg import (  # noqa: E402
    galerkin_coarse_dia,
)
from deeppreconditioning_tpu_torch.train import (  # noqa: E402
    structured as structured_train,
)
from deeppreconditioning_tpu_torch.utils.profiling import (  # noqa: E402
    card_peaks,
    dia_work,
    time_graph,
)


def operators(dev):
    yield from spmv_operators(dev)
    a, _ = scaling.scaling_operator(128, device=dev)
    shape = (128, 128, 128)
    while min(shape) >= 32:
        a = galerkin_coarse_dia(a, shape)
        shape = tuple(s // 2 for s in shape)
        yield f"gmg_coarse_{shape[0]}^3", a
    a, _ = structured_train.make_data((12, 12, 12), 32, (1.0, 1.0),
                                      "random", 69, device=dev)
    yield "batched_forward", a
    yield "batched_backward", a.transpose()


@torch.no_grad()
def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--operators", default="",
                        help="comma-separated names to keep (default: all)")
    parser.add_argument("--rows", type=int, default=None,
                        help="time this R only")
    args = parser.parse_args()
    keep = set(filter(None, args.operators.split(",")))
    dev = _backend.device()
    card = card_line()
    print(f"card: {card}")
    _backend.kernel_library()
    hbm = card_peaks(torch.cuda.get_device_name(dev)).hbm_gb_s
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, a in operators(dev):
        if keep and name not in keep:
            continue
        x = torch.randn(tuple(a.vals.shape[:-2]) + (a.n_pad,), device=dev,
                        generator=gen)
        ref = a.matvec(x)
        plan = dia_spmv.launch_plan(a)
        own = plan.geometry
        rows_total = x.numel()
        bound = dia_work(len(a.offsets), rows_total).bytes / (hbm * 1e9)
        print(f"{name}: {len(a.offsets)} bands, {rows_total} rows, bound "
              f"{bound * 1e3:.4f} ms (bytes) [{card}]")
        top = dia_spmv.max_rows_per_thread(len(a.offsets))
        for rows in (r for r in (4, 2, 1)
                     if r <= top and args.rows in (None, r)):
            for threads in dia_spmv.CTA_THREADS:
                try:
                    geom = dia_spmv.tile_geometry(
                        own.offsets, own.n_pad, own.batch, rows=rows,
                        threads=threads)
                except ValueError:
                    continue
                if (geom.rows, geom.threads) != (rows, threads):
                    continue  # the windows do not fit at this tile
                a.launch_plan = dataclasses.replace(
                    plan, geometry=geom,
                    params_ptr=ctypes.addressof(geom.params))
                equal = torch.equal(dia_spmv.dia_matvec(a, x), ref)
                only = time_graph(lambda: dia_spmv.dia_matvec(a, x), dev)
                mark = " (plan)" if (rows, threads) == (
                    own.rows, own.threads) else ""
                print(f"  R {rows} threads {threads:3d} tile {geom.tile:5d} "
                      f"CTAs {geom.tiles * geom.batch:6d} shared "
                      f"{geom.smem_bytes:6d} B: kernel only "
                      f"{only * 1e3:.4f} ms, share {bound / only:.3f}, "
                      f"bit-equal {equal}{mark}")
                if not equal:
                    raise AssertionError(f"B2 differs on {name} at R {rows}"
                                         f", {threads} threads")
        a.launch_plan = plan
        del x, ref
    one = torch.zeros(1, device=dev)
    floor = time_graph(lambda: one.add_(1.0), dev)
    print(f"graph floor, one 1-float PyTorch kernel a launch: "
          f"{floor * 1e3:.4f} ms [{card}]")
    print(card_line())


if __name__ == "__main__":
    main()
