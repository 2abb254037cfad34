"""Distributed-PCG scaling benchmark on the 3-D Poisson system.

    python -m deeppreconditioning_tpu_torch.scaling_bench [--grid 64]
        [--precond none|jacobi|block_jacobi_ic|fsai] [--mode auto|halo|
        allgather] [--reps 5] [--sweeps 8] [--out PATH] [--device cuda|cpu]
    torchrun --nproc-per-node 4 -m deeppreconditioning_tpu_torch.scaling_bench

Counterpart of ``scripts/scaling_bench.py``: ``pcg_sharded`` (float32,
``max_iter`` 256) on the 7-point Poisson system of ``--grid``^3 cells
(n 262 144 at 64) with b standard normal from seed 0, at every shard
count 1, 2, 4, ... up to the ranks there are, each on the first ranks
of the world.  ``--mode auto`` takes halo mode where the halo fits a
shard's rows (the matrix's bandwidth, grid^2), else allgather.
Preconditioners: ``none``; ``jacobi`` (shard-local 1/diag);
``block_jacobi_ic`` (each rank's diagonal block in IC(0), ``--sweeps``
Neumann sweeps, ``parallel/block_jacobi.py``); ``fsai`` (the exact
sharded FSAI apply, ``parallel/fsai.py``, of the factor on tril(A)
(pattern power 1) built as the reference builds it: the generic plan on
the host, then one batched Gauss-Jordan through ``ops/fsai.
fsai_values_lookup``, which on the card is kernel B1 at w 4 and N 262 144).

Started without the env:// variables it runs alone, in a process group
of world size 1 (NCCL on the card, gloo with ``--device cpu``); under
``torchrun`` each rank takes the card of its ``LOCAL_RANK``.  Every solve
is timed as the median of ``--reps`` runs (CUDA events on the card).
As in the reference, the speedup and efficiency columns are written only
when more than one rank ran on real devices; on one card the CSV holds the
world-1 row and the communication model: bytes sent per shard per PCG
iteration, float32 (the reference's model, scripts/scaling_bench.py:14-19)

    halo SpMV:      2 exchanged slabs x halo rows   = 8 * halo bytes
    CG scalars:     3 all-reduces of 1 scalar        = 12 bytes
    FSAI apply:     2 more halo slabs                = 8 * fsai_halo bytes
    allgather SpMV: the whole vector                 = 4 * n_total bytes

(the port reduces its 4 scalars an iteration in 2 all-reduces of 2).
Writes ``assets/results/torch/scaling[_<precond>].csv``.
"""

from __future__ import annotations

import argparse
import csv
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable

import numpy as np
import scipy.sparse as sp
import torch

from deeppreconditioning_tpu_torch import _backend
from deeppreconditioning_tpu_torch.ops.fsai import (
    FSAIPlan,
    build_fsai_plan,
    fsai_values_lookup,
    tril_power_pattern,
)
from deeppreconditioning_tpu_torch.parallel import multihost
from deeppreconditioning_tpu_torch.parallel.block_jacobi import (
    block_jacobi_apply,
    build_block_jacobi_ic,
)
from deeppreconditioning_tpu_torch.parallel.fsai import (
    build_sharded_fsai,
    fsai_apply,
    make_fsai_sharded_apply,
)
from deeppreconditioning_tpu_torch.parallel.partition import (
    pad_vector,
    shard_ell_rows,
)
from deeppreconditioning_tpu_torch.parallel.pcg import (
    diag_local,
    identity_local,
    pcg_sharded,
)
from deeppreconditioning_tpu_torch.sparse.dia import poisson_dia
from deeppreconditioning_tpu_torch.sparse.ell import ELLMatrix
from deeppreconditioning_tpu_torch.utils.profiling import time_call

REPO = Path(__file__).resolve().parents[1]
RESULTS = REPO / "assets" / "results" / "torch"
PRECONDS = ("none", "jacobi", "block_jacobi_ic", "fsai")
SHARD_COUNTS = (1, 2, 4, 8, 16, 32)
MAX_ITER = 256
ITEMSIZE = 4  # float32


def scaling_system(grid: int):
    """(A as scipy CSR, b) of the benchmark: the Poisson operator of
    grid^3 cells and b ~ N(0, 1) from seed 0, float32 values."""
    dia = poisson_dia((grid, grid, grid))
    a = dia.to_scipy().tocsr()
    b = np.random.default_rng(0).standard_normal(dia.n).astype(np.float32)
    return a, b


def fsai_plan_inputs(a: sp.csr_matrix) -> tuple[FSAIPlan, np.ndarray]:
    """The generic FSAI plan on tril(A) (pattern power 1) and A's tril
    value vector, float32, as the reference's scaling bench builds them
    (sites sorted by (row, col), unit diagonal on the padding to a
    multiple of 8); host, numpy."""
    n = a.shape[0]
    coo = a.tocoo()
    keep = coo.row >= coo.col
    order = np.argsort(coo.row[keep].astype(np.int64) * n + coo.col[keep])
    l0_r = coo.row[keep][order].astype(np.int32)
    l0_c = coo.col[keep][order].astype(np.int32)
    l0_v = coo.data[keep][order].astype(np.float32)
    n_pad = ((n + 7) // 8) * 8
    pad = np.arange(n, n_pad, dtype=np.int32)
    l0_r = np.concatenate([l0_r, pad])
    l0_c = np.concatenate([l0_c, pad])
    l0_v = np.concatenate([l0_v, np.ones(n_pad - n, np.float32)])
    pr, pc = tril_power_pattern(l0_r, l0_c, n_pad, power=1)
    return build_fsai_plan(l0_r, l0_c, pr, pc, n_pad), l0_v


def fsai_columns(a: sp.csr_matrix, device):
    """The FSAI factor on tril(A): (out_rows, c_vals, width), numpy.  The
    local solves run on ``device`` in one batched Gauss-Jordan
    (``fsai_values_lookup``; B1 on the card)."""
    plan, l0_v = fsai_plan_inputs(a)
    with torch.no_grad():
        c_vals = fsai_values_lookup(plan.to(device),
                                    torch.as_tensor(l0_v, device=device))
    return plan.out_rows, c_vals.cpu().numpy(), plan.width


def comm_bytes(mode: str, halo: int, n_total: int,
               fsai_halo: int | None = None) -> int:
    """Bytes sent per shard per PCG iteration (the module's model)."""
    if mode == "halo":
        comm = 2 * halo * ITEMSIZE + 3 * ITEMSIZE
    else:
        comm = n_total * ITEMSIZE + 3 * ITEMSIZE
    if fsai_halo is not None:
        comm += 2 * fsai_halo * ITEMSIZE
    return comm


@dataclass
class BenchSolve:
    """One rank's solve of the benchmark: ``run()`` is one
    ``pcg_sharded`` call on this rank's rows ``b`` with the preconditioner
    data ``m_data``; ``single_apply(m_data, r)`` applies the same
    operator on one device with no exchange."""

    run: Callable[[], Any]
    mode: str
    comm_bytes: int
    b: torch.Tensor
    m_data: Any
    single_apply: Callable


def solver_setup(a, b_host, world, precond, mode="auto", sweeps=8,
                 columns=None, dtype=torch.float32) -> BenchSolve:
    """This rank's solve of the benchmark on ``world``; ``mode`` auto
    takes halo where the halo fits; ``columns``: ``fsai_columns``' result
    (for ``fsai``)."""
    dev = world.device
    ell = ELLMatrix.from_scipy(a, dtype=dtype)
    sharded = shard_ell_rows(ell, world.size)
    if mode == "auto":
        mode = ("halo" if sharded.halo <= sharded.rows_per_shard
                else "allgather")
    r = sharded.rows_per_shard
    rows = slice(world.rank * r, (world.rank + 1) * r)
    shard = sharded.shard(world.rank, dev, dtype)
    b = torch.as_tensor(pad_vector(b_host, sharded.n_total)[rows],
                        device=dev).to(dtype)
    fsai_halo = None
    if precond == "none":
        apply_m, m_data = identity_local, None
    elif precond == "jacobi":
        d = np.zeros(sharded.n_total)
        d[:a.shape[0]] = 1.0 / a.diagonal()
        apply_m = diag_local
        m_data = torch.as_tensor(d[rows], device=dev).to(dtype)
    elif precond == "block_jacobi_ic":
        apply_m = block_jacobi_apply
        m_data = build_block_jacobi_ic(a, world.size, sharded.n_total,
                                       world.rank, sweeps=sweeps).to(
                                           dev, dtype)
    elif precond == "fsai":
        sf = build_sharded_fsai(columns[0], columns[1], world.size,
                                n_total=sharded.n_total)
        apply_m = make_fsai_sharded_apply(world)
        m_data = sf.shard(world.rank, dev, dtype)
        fsai_halo = sf.halo
    else:
        raise ValueError(f"unknown preconditioner {precond!r}")

    def run():
        return pcg_sharded(world, shard, b, m_data, apply_m, mode=mode,
                           max_iter=MAX_ITER)

    return BenchSolve(
        run=run, mode=mode,
        comm_bytes=comm_bytes(mode, sharded.halo, sharded.n_total,
                              fsai_halo),
        b=b, m_data=m_data,
        single_apply=fsai_apply if precond == "fsai" else apply_m)


def run_bench(device, grid: int = 64, precond: str = "none",
              mode: str = "auto", reps: int = 5, sweeps: int = 8,
              log=print) -> list[dict]:
    """Every shard count up to the world's size; the rows on rank 0 (the
    other ranks return [])."""
    a, b_host = scaling_system(grid)
    columns = None
    if precond == "fsai":
        columns = fsai_columns(a, device)
        log(f"fsai factor: width {columns[2]}, {a.shape[0]:,} columns")
    world_size = torch.distributed.get_world_size()
    real = torch.device(device).type == "cuda"
    rows = []
    for s in (c for c in SHARD_COUNTS if c <= world_size):
        world = multihost.solver_world(device, s)
        if world is None:
            continue
        solve = solver_setup(a, b_host, world, precond, mode, sweeps,
                             columns)
        used, comm = solve.mode, solve.comm_bytes
        res = solve.run()
        seconds = time_call(solve.run, torch.device(device), reps=reps)
        row = {"shards": s, "mode": used, "precond": precond,
               "platform": "gpu" if real else "cpu", "n": a.shape[0],
               "iterations": int(res.iterations), "seconds": seconds,
               "comm_bytes_per_iter_per_shard": comm}
        if world.rank == 0:
            if real and world_size > 1 and s > 1:
                row["speedup_vs_1"] = rows[0]["seconds"] / seconds
                row["efficiency"] = row["speedup_vs_1"] / s
            rows.append(row)
            log(f"shards={s} mode={used}: {seconds * 1e3:.3f} ms "
                f"iters={int(res.iterations)} comm/iter={comm} B")
    return rows


def write_csv(path: Path, rows) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w") as fio:
        writer = csv.DictWriter(fio, fieldnames=list(rows[-1]), restval="")
        writer.writeheader()
        writer.writerows(rows)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog="python -m deeppreconditioning_tpu_torch.scaling_bench")
    parser.add_argument("--grid", type=int, default=64)
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--precond", default="none", choices=PRECONDS)
    parser.add_argument("--mode", default="auto",
                        choices=["auto", "halo", "allgather"])
    parser.add_argument("--sweeps", type=int, default=8,
                        help="block_jacobi_ic's Neumann sweeps")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args(argv)
    if args.device == "cuda":
        _backend.device()  # the card, or raise
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    else:
        device = torch.device("cpu")
    if not multihost.initialize_if_needed(device):
        multihost.initialize_single(device)
    try:
        rows = run_bench(device, args.grid, args.precond, args.mode,
                         args.reps, args.sweeps)
        if rows:
            suffix = "" if args.precond == "none" else f"_{args.precond}"
            out = args.out or RESULTS / f"scaling{suffix}.csv"
            write_csv(out, rows)
            print(f"wrote {out}")
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    main()
