#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure):
  1. device: a CUDA device is required; print the card's name and power
     limit as nvidia-smi reports them;
  2. build: compile and load the CUDA kernels from ``csrc/`` (nvcc, one
     process per source, in parallel); print each source's nvcc time and
     ptxas's registers, stack and spills per kernel instance, and fail on
     any spill in B1's or B3's instances;
  3. kernel B1 (batched Gauss–Jordan) against its plain PyTorch version
     at w in {4, 8, 13, 24, 31, 32, 41, 63} and N in {1024, 131072} and at
     the scaling path's launches (w 13 and 4, N = 262144), float32, within
     rtol 1e-4 / atol 1e-6; after phase 4c also on the real w-41 local
     systems of a frames case's range plan;
  3b. kernel B2 (DIA SpMV) against its plain PyTorch version on
     ``poisson_dia`` at 512^2, 128^3 and 256^3, on the 13-band halves
     (c_up, c_low) of a 128^3 structured FSAI factor and on the Galerkin
     coarse operators of the 128^3 scaling operator, float32, within
     |kernel - plain| <= 1e-6 + 1e-5 |plain|; the SpMV section's cold and
     resident GB/s and HBM share;
  3c. kernel B3 (BSR SpMV / SpMM) against its plain PyTorch version on the
     four BSR operators of the SpMV roofline at block size 128 (m = 1)
     and on the frame operator at m in {8, 128}, float32, within
     |kernel - plain| <= 1e-5 max|plain| + 1e-6; then the roofline path
     through its entry point's sections (``python -m
     deeppreconditioning_tpu_torch.bench.roofline``: the B2 sweep at 64^3
     .. 256^3 beside the stencil, the B3 rows), cold and resident, with
     B2 and B3 launched and no plain version run on the card.
     In phases 3, 3b and 3c every (kernel, shape) is timed three ways in
     turns (``measure``): per call (CUDA events around one call, median of
     20), kernel only (``utils.profiling.time_graph``: 20 launches back to
     back in a CUDA graph) and the one PyTorch library call for the same
     function, timed here only (B1 ``torch.linalg.solve_ex``, B2 a
     ``torch.sparse_csr_tensor`` of the operator, B3 a
     ``torch.sparse_bsr_tensor`` of the non-sentinel blocks), beside the
     plain version and the bound from ``utils.profiling`` (bytes or
     operations; B3 on its non-sentinel blocks, at m > 1 against the
     3xTF32 roof with the float32 roof beside it); a kernel-only time above
     its per-call time (by more than 5%) fails;
  4. the per-case main path through the entry point
     (``python -m deeppreconditioning_tpu_torch.bench``'s ``run``): 500
     sludge-pattern cases from seed 69420, the 100-case test split, the
     flagship NeuralFSAI checkpoint, bench.py's seven techniques (vanilla
     / jacobi / incomplete_cholesky / incomplete_cholesky_neumann /
     algebraic_multigrid / fsai / learned).  Requires B1 launched once per
     fsai/learned setup, no plain version run on the card; vanilla /
     jacobi / fsai / learned: 100% success, mean iterations within 1% of
     the JAX reference (``tests/fixtures/torch_port/
     percase_iterations.json``) and per-case |delta| <= 2; the IC and AMG
     techniques: success and per-case |delta| <= 2 against
     ``tests/fixtures/torch_port/batched_iterations.json``; the first
     case's fsai and learned M on the card agree with the port's CPU
     float64 path to 1e-4 (relative to max |M|);
  4d. the batched protocol on the same split through the entry point's
     ``run_batched`` (vanilla, jacobi, incomplete_cholesky_neumann,
     algebraic_multigrid, fsai, learned; bf16 first): per-case iterations
     of the fixed-trip run within 2 of the JAX reference's ``run_batched``
     (vanilla max(2, 5%)), means within 1% (vanilla 5%), success equal,
     B1 launched once per plan group and fsai/learned build, no plain
     version on the card, the reference's ``batched.csv`` header; a
     technique that settles on another M dtype than the reference is
     printed.  Then B1 against its plain version on the real local
     systems of one batched learned build (w 24, N 102 400), timed as in
     phase 3;
  4e. bench.py's irregular split through its entry point (``python -m
     deeppreconditioning_tpu_torch.bench.irregular``'s ``run``): 100 3-D
     castellated cases from seed 69421 (odd ones permuted), the 20-case
     test split, vanilla / jacobi / fsai / learned at pattern power 2.
     Held as the frames path, against the fixture's ``irregular`` part,
     with the learned mean within 2% (its float32 drift, ROADMAP C); the
     generic plan on exactly the fixture's cases;
  4b. the structured-grid scaling path through its entry point
     (``python -m deeppreconditioning_tpu_torch.bench.scaling``'s
     ``run_scaling``) at 64^3 and 128^3: vanilla, jacobi, fsai, learned,
     gmg_jacobi, gmg_learned.  Requires every technique converged,
     iterations against the JAX reference
     (``tests/fixtures/torch_port/scaling_iterations.json``: vanilla
     within 5%, the others within max(2, 2%)), no safeguard fallback for
     learned, B2 launched by every technique, B1 launched n_pad / 2^18
     times per structured setup (fsai, learned, gmg_learned), no plain
     version run on the card, and the reference's CSV header; the 64^3
     learned factor and q on the card agree with the port's CPU float64
     path to 1e-4 (relative to max |bands|);
  4c. the frame-structure family through its entry point
     (``python -m deeppreconditioning_tpu_torch.bench.frames``'s ``run``):
     200 frame cases from seed 69422, the 40-case test split, the frames
     NeuralFSAI checkpoint (w 41), vanilla / jacobi / fsai / learned.
     Requires per-case success equal to the JAX reference's
     (``tests/fixtures/torch_port/frames_iterations.json``), mean
     iterations within 1% (vanilla 5%), per-case |delta| <= 2 (vanilla
     and jacobi max(2, 5%): their float32 CG drifts between platforms on
     these stiff systems), the generic plan on exactly the fixture's
     cases, B1 launched once per fsai/learned setup, no plain version run
     on the card, the reference's table header; fsai and learned M of a range
     case and a generic case on the card agree with the port's CPU
     float64 path to 1e-4 (relative to max |M|);
  5. the launches per path, the card line, one JSON line of kernel records
     (per kernel at its main shape: per-call ``ms``, ``kernel_only_ms``,
     ``bound_ms``, ``bound_by``, ``library_ms``, ``plain_ms``), and the
     last line ``{"ok": true, "device": {...}}``.

Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

from deeppreconditioning_tpu_torch import _backend  # noqa: E402
from deeppreconditioning_tpu_torch.bench.__main__ import (  # noqa: E402
    SEED,
    SETUP_REPS,
    SOLVE_REPS,
    batched_ratios,
    run as run_main_path,
    run_batched,
)
from deeppreconditioning_tpu_torch.bench.suite import (  # noqa: E402
    BATCHED_KEYS,
    TABLE_PARAMETERS,
    BenchmarkSuite,
)
from deeppreconditioning_tpu_torch.bench import frames  # noqa: E402
from deeppreconditioning_tpu_torch.bench import irregular  # noqa: E402
from deeppreconditioning_tpu_torch.bench import roofline  # noqa: E402
from deeppreconditioning_tpu_torch.bench import scaling  # noqa: E402
from deeppreconditioning_tpu_torch.bench.spmv import (  # noqa: E402
    spmv_operators,
    spmv_section,
)
from deeppreconditioning_tpu_torch.models.neural_fsai import (  # noqa: E402
    neural_fsai_from_checkpoint,
)
from deeppreconditioning_tpu_torch.ops.bsr_spmm import (  # noqa: E402
    bsr_matmat,
    bsr_matvec,
)
from deeppreconditioning_tpu_torch.ops.dia_spmv import (  # noqa: E402
    dia_matvec,
)
from deeppreconditioning_tpu_torch.ops.fsai import (  # noqa: E402
    RangeFSAIPlan,
    local_systems,
    range_local_blocks,
)
from deeppreconditioning_tpu_torch.ops.gauss_jordan import (  # noqa: E402
    masked_gauss_jordan,
    masked_gauss_jordan_torch,
)
from deeppreconditioning_tpu_torch.ops.gmg import (  # noqa: E402
    galerkin_coarse_dia,
)
from deeppreconditioning_tpu_torch.ops.structured_fsai import (  # noqa: E402
    CHUNK,
    build_structured_plan,
    structured_setup,
)
from deeppreconditioning_tpu_torch.sparse.dia import pad_rows  # noqa: E402
from deeppreconditioning_tpu_torch.train.checkpoint import (  # noqa: E402
    load_checkpoint,
)
from deeppreconditioning_tpu_torch.utils.profiling import (  # noqa: E402
    bsr_work,
    card_peaks,
    dia_work,
    gauss_jordan_work,
    time_call,
    time_graph,
)

FIXTURE = REPO / "tests" / "fixtures" / "torch_port" / "percase_iterations.json"
RESULTS = REPO / "build" / "chip_smoke_results"
GJ_WIDTHS = (4, 8, 13, 24, 31, 32, 41, 63)
GJ_SIZES = (1024, 131072)
GJ_MAIN_SHAPE = (1024, 24)  # (N, w) of one main-path setup
GJ_PATH = ((13, 262144), (4, 262144))  # (w, N) of a scaling-path launch
# Kernel-only may exceed per call by timer noise on kernels that take
# longer than their launch; more means the two spans measured different work.
KERNEL_ONLY_SLACK = 1.05
PTXAS_FUNCTION = re.compile(
    r"Function properties for (\S+)\n\s*(\d+) bytes stack frame, (\d+) "
    r"bytes spill stores, (\d+) bytes spill loads\n[^\n]*?Used (\d+) "
    r"registers")
NO_SPILL_SOURCES = ("gauss_jordan.cu", "bsr_spmm.cu")
GJ_RTOL, GJ_ATOL = 1e-4, 1e-6
M_RTOL = 1e-4  # card float32 setup vs CPU float64 setup, relative to max|M|
# BENCH_r05 per-case mean iterations, measured on a TPU v5e: context only
TPU_RECORD = {"jacobi": 99.19, "fsai": 23.15, "learned": 7.56}
BATCHED_FIXTURE = (REPO / "tests" / "fixtures" / "torch_port"
                   / "batched_iterations.json")
GJ_BATCHED_W = 24  # B1 at the batched learned build: w 24, N 100 x 1024
# BENCH_r05 batched and irregular mean iterations (TPU v5e): context only
TPU_BATCHED_RECORD = {"jacobi": 99.19, "fsai": 23.15, "learned": 7.58}
TPU_IRREGULAR_RECORD = {"jacobi": 52.2, "learned": 13.85}
# Irregular means: learned counts (10-17 iterations) move by 1 on a few
# cases with float32 rounding (JAX CPU float32 13.95, float64 13.25, the
# port 13.75; ROADMAP C), so its mean is held to 2%; vanilla drifts as on
# the frames path.
IRREGULAR_MEAN_TOL = {"vanilla": 0.05, "learned": 0.02}
SCALING_FIXTURE = (REPO / "tests" / "fixtures" / "torch_port"
                   / "scaling_iterations.json")
B2_RTOL, B2_ATOL = 1e-5, 1e-6
B2_MAIN = "poisson_3d_128"  # the scaling path's 128^3 7-band shape
BANDS_RTOL = 1e-4  # card float32 factor vs CPU float64, relative to max|bands|
SCALING_HEADER = ("shape,technique,n,sigma,iterations,setup_s,solve_s,"
                  "total_s,converged,x_rel_err,safeguard_fallback")
B3_RTOL, B3_ATOL = 1e-5, 1e-6  # relative to max|plain|, absolute
B3_MAIN = "frame_structure"  # the roofline's frame operator at m = 1
B3_WIDE = (8, 128)  # SpMM widths checked on the frame operator
FRAMES_FIXTURE = (REPO / "tests" / "fixtures" / "torch_port"
                  / "frames_iterations.json")
# Unpreconditioned and Jacobi float32 CG on the frame systems (kappa
# ~3.5e3 and ~1.2e3) drift per case between platforms (ROADMAP C).
FRAMES_DRIFT = ("vanilla", "jacobi")
# BENCH_r05 scaling iterations, measured on a TPU v5e: context only
TPU_SCALING_RECORD = {
    64: {"vanilla": 348, "jacobi": 136, "fsai": 53, "learned": 23,
         "gmg_jacobi": 14, "gmg_learned": 12},
    128: {"vanilla": 651, "jacobi": 248, "fsai": 97, "learned": 43,
          "gmg_jacobi": 18, "gmg_learned": 17},
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def spd_systems(rng, n, w):
    """Well-conditioned SPD blocks with a unit diagonal (like Jacobi-scaled
    FSAI local blocks) and one-hot right-hand sides, float32."""
    g = rng.standard_normal((n, w, w), dtype=np.float32)
    a = g @ g.transpose(0, 2, 1) / w + np.eye(w, dtype=np.float32)
    d = 1.0 / np.sqrt(np.einsum("nii->ni", a))
    a = a * d[:, :, None] * d[:, None, :]
    e = np.zeros((n, w), np.float32)
    e[np.arange(n), rng.integers(0, w, n)] = 1.0
    return a, e


def measure(label, kernel, plain, library, work, dev, card, *,
            tensor_cores=False):
    """Time one (kernel, shape) three ways in turns, inside this call:
    per call (CUDA events around one call, median of 20: what a path
    pays), kernel only (``time_graph``: launches back to back in a CUDA
    graph), the one PyTorch library call for the same function (per call)
    and the plain version (per call); print
    them beside the bound of ``work``.  Fails if the kernel-only time
    exceeds the per-call time by more than KERNEL_ONLY_SLACK (the span
    would have measured something else).  Returns the record, in ms."""
    peaks = card_peaks(torch.cuda.get_device_name(dev))
    per_call = time_call(kernel, dev, reps=20)
    only = time_graph(kernel, dev)
    lib = time_call(library, dev, reps=20)
    plain_s = time_call(plain, dev, reps=20)
    # A tensor-core kernel is held to the 3xTF32 roof, the float32 roof
    # beside it.
    bound, roof = work.bound(peaks.hbm_gb_s, peaks.tf32x3_tflop_s
                             if tensor_cores else peaks.fp32_tflop_s)
    rec = {"ms": per_call * 1e3, "kernel_only_ms": only * 1e3,
           "bound_ms": bound * 1e3, "bound_by": roof,
           "library_ms": lib * 1e3,
           "plain_ms": plain_s * 1e3}
    extra = ""
    if tensor_cores:
        fp32_bound, fp32_roof = work.bound(peaks.hbm_gb_s, peaks.fp32_tflop_s)
        extra = (f" at the 3xTF32 roof; float32 roof {fp32_bound * 1e3:.4f}"
                 f" ms ({fp32_roof})"
                 + (", beaten" if only < fp32_bound else ""))
    print(f"{label}: per call {per_call * 1e3:.4f} ms, kernel only "
          f"{only * 1e3:.4f} ms, bound {bound * 1e3:.4f} ms ({roof}; "
          f"{work.bytes} B, {work.flops} flop{extra}), share of bound "
          f"{bound / only:.3f}; library {lib * 1e3:.4f} ms, plain "
          f"{plain_s * 1e3:.4f} ms [{card}]")
    if only > per_call * KERNEL_ONLY_SLACK:
        raise AssertionError(f"{label}: kernel-only {only * 1e3:.4f} ms "
                             f"exceeds per call {per_call * 1e3:.4f} ms")
    return rec


def check_gauss_jordan(dev, card):
    """Phase 3: B1 against its plain version at every checked (w, N), and
    its times beside the bound and ``torch.linalg.solve_ex``."""
    rng = np.random.default_rng(0)
    max_err, records = 0.0, {}
    shapes = [(w, n) for w in GJ_WIDTHS for n in GJ_SIZES] + list(GJ_PATH)
    for w, n in shapes:
        a, e = spd_systems(rng, n, w)
        sub = torch.tensor(a, device=dev)
        rhs = torch.tensor(e, device=dev)
        del a, e
        err = check_gauss_jordan_on(sub, rhs, f"w={w} N={n}")
        max_err = max(max_err, err)
        records[(n, w)] = measure(
            f"B1 w={w:2d} N={n:6d} (max abs err {err:.3e}, rtol {GJ_RTOL},"
            f" atol {GJ_ATOL})",
            lambda: masked_gauss_jordan(sub, rhs),
            lambda: masked_gauss_jordan_torch(sub, rhs),
            lambda: torch.linalg.solve_ex(sub, rhs[..., None]),
            gauss_jordan_work(n, w), dev, card)
        del sub, rhs
    return max_err, records


def check_gauss_jordan_on(sub, rhs, label):
    """B1 against its plain version on (sub, rhs); returns the max abs
    error, raises beyond rtol GJ_RTOL / atol GJ_ATOL."""
    got = masked_gauss_jordan(sub, rhs)
    torch.cuda.synchronize()
    ref = masked_gauss_jordan_torch(sub, rhs)
    diff = (got - ref).abs()
    err = float(diff.max())
    if not bool(torch.isfinite(got).all()) or bool(
            (diff > GJ_ATOL + GJ_RTOL * ref.abs()).any()):
        raise AssertionError(
            f"B1 disagrees with its plain version at {label}: max abs err "
            f"{err}")
    return err


def check_dia_spmv(dev, card):
    """Phase 3b: B2 against its plain version on the SpMV section's
    operators and on the multigrid coarse levels of the 128^3 scaling
    operator; then the section's cold / resident roofline rows."""
    rng = np.random.default_rng(1)
    operators = spmv_operators(dev)
    a, _ = scaling.scaling_operator(128, device=dev)
    shape = (128, 128, 128)
    coarse = []
    while min(shape) >= 32:  # the levels GMG smooths below 128^3
        a = galerkin_coarse_dia(a, shape)
        shape = tuple(s // 2 for s in shape)
        coarse.append((f"gmg_coarse_{shape[0]}^3", a))
    max_err, times = 0.0, {}
    with torch.no_grad():
        for name, a in operators + coarse:
            x = torch.tensor(rng.standard_normal(a.n_pad, dtype=np.float32),
                             device=dev)
            got = dia_matvec(a, x)
            torch.cuda.synchronize()
            ref = a.matvec(x)
            diff = (got - ref).abs()
            err = float(diff.max())
            if not bool(torch.isfinite(got).all()) or bool(
                    (diff > B2_ATOL + B2_RTOL * ref.abs()).any()):
                raise AssertionError(
                    f"B2 disagrees with its plain version on {name}: max "
                    f"abs err {err}")
            max_err = max(max_err, err)
            csr = dia_csr(a)
            times[name] = measure(
                f"B2 {name:<20} n_pad {a.n_pad:>8d} bands "
                f"{len(a.offsets):2d} (max abs err {err:.3e}, rtol {B2_RTOL},"
                f" atol {B2_ATOL}; library CSR nnz {csr.values().numel()})",
                lambda: dia_matvec(a, x), lambda: a.matvec(x),
                lambda: csr @ x, dia_work(len(a.offsets), a.n_pad), dev,
                card)
            del x, got, ref, diff, csr
        for row in spmv_section(dev, operators):
            print(f"SpMV {row['name']:<20} " + "; ".join(
                f"{p} {row[p]['time_us']:.2f} us {row[p]['gnnz_per_s']:.2f}"
                f" Gnnz/s {row[p]['achieved_gb_s']:.1f} GB/s HBM share "
                f"{row[p]['bandwidth_fraction']:.3f}"
                for p in ("cold", "resident")) + f" [{card}]")
    return max_err, times


def dia_csr(a):
    """The DIA operator as one ``torch.sparse_csr_tensor`` (its nonzeros,
    int32 indices, columns sorted in each row): the library yardstick of
    B2, never called by the port."""
    order = sorted(range(len(a.offsets)), key=lambda d: a.offsets[d])
    n = a.n_pad
    rows = torch.arange(n, device=a.vals.device)
    cols = torch.stack([rows + a.offsets[d] for d in order], dim=1)
    vals = a.vals[order].T
    keep = (cols >= 0) & (cols < n) & (vals != 0)
    crow = torch.zeros(n + 1, dtype=torch.int32, device=a.vals.device)
    crow[1:] = torch.cumsum(keep.sum(1), 0)
    return torch.sparse_csr_tensor(crow, cols[keep].int(), vals[keep],
                                   (n, n))


def bsr_library(a):
    """The stored non-sentinel blocks of a ``BSRMatrix`` as one
    ``torch.sparse_bsr_tensor`` (block columns sorted in each row): the
    library yardstick of B3, never called by the port."""
    r, s = a.n_block_rows, a.slots
    cols = a.block_cols.long()
    live = (cols >= 0) & (cols < r)
    rows = torch.arange(r, device=cols.device)[:, None].expand(r, s)
    key = torch.where(live, rows * (r + 1) + cols, (r + 1) * (r + 1))
    take = torch.argsort(key.reshape(-1))[:int(live.sum())]
    crow = torch.zeros(r + 1, dtype=torch.int32, device=cols.device)
    crow[1:] = torch.cumsum(live.sum(1), 0)
    bs = a.block_size
    return torch.sparse_bsr_tensor(
        crow, cols.reshape(-1)[take].int(),
        a.blocks.reshape(r * s, bs, bs)[take], (a.n_pad, a.n_pad))


def check_scaling_path(dev, card):
    """Phase 4b: the scaling path at 64^3 and 128^3 against the JAX
    reference counts; returns the kernel launches over the path."""
    fixture = json.loads(SCALING_FIXTURE.read_text())
    meta = (tuple(fixture["shapes"]), fixture["sigma"],
            fixture["coeff_seed"], fixture["rhs_seed"], fixture["rtol"],
            fixture["checkpoint"], fixture["smoother_checkpoint"])
    if meta != (scaling.SHAPES, scaling.SIGMA, scaling.COEFF_SEED,
                scaling.RHS_SEED, scaling.RTOL, scaling.CHECKPOINT,
                scaling.SMOOTHER_CHECKPOINT):
        raise AssertionError("the scaling fixture describes another run")
    csv_path = RESULTS / "scaling_learned.csv"
    t0 = time.perf_counter()
    run = scaling.run_scaling(dev, out=csv_path)
    wall_s = time.perf_counter() - t0
    header = csv_path.read_text().splitlines()[0]
    if header != SCALING_HEADER:
        raise AssertionError(f"scaling CSV schema changed: {header}")
    print(f"scaling path: shapes {scaling.SHAPES}, {wall_s:.1f} s wall "
          f"(operators, setups, solves, timing reps)")
    failures = []
    totals = dict.fromkeys(_backend.KERNELS, 0)
    print(f"per shape and technique on {card} (ms: setup median of "
          f"{scaling.TIMING_REPS}, solve median of {scaling.TIMING_REPS} "
          f"fixed-trip solves):")
    for row in run.rows:
        side = int(row["shape"].split("^")[0])
        name = row["technique"]
        key = (side, name)
        ref = fixture["results"][str(side)]["iterations"][name]
        iters = row["iterations"]
        launches = run.launches[key]
        plain = run.plain_on_cuda[key]
        for kernel, count in launches.items():
            totals[kernel] += count
        print(f"  {row['shape']:<6} {name:<12} iters {iters:4d} (JAX CPU "
              f"f32 {ref:4d}) setup {row['setup_s'] * 1e3:.3f} solve "
              f"{row['solve_s'] * 1e3:.3f} total {row['total_s'] * 1e3:.3f}"
              f" converged {row['converged']} launches {launches} plain on "
              f"card {plain}")
        allowed = 0.05 * ref if name == "vanilla" else max(2, 0.02 * ref)
        if abs(iters - ref) > allowed:
            failures.append(f"{key}: {iters} iterations vs {ref}")
        if not row["converged"]:
            failures.append(f"{key}: not converged")
        if launches["dia_spmv"] == 0:
            failures.append(f"{key}: B2 never launched")
        n_pad = pad_rows(row["n"])  # one B1 launch per chunk of columns
        per_setup = n_pad // CHUNK if n_pad % CHUNK == 0 else 1
        want_gj = (per_setup * run.setup_calls[key]
                   if name in scaling.STRUCTURED_TECHNIQUES else 0)
        if launches["gauss_jordan"] != want_gj or (
                name in scaling.STRUCTURED_TECHNIQUES and want_gj == 0):
            failures.append(f"{key}: B1 launched {launches['gauss_jordan']}"
                            f" times, expected {want_gj}")
        if any(plain.values()):
            failures.append(f"{key}: plain version ran on the card {plain}")
        if name == "learned" and row["safeguard_fallback"]:
            failures.append(f"{key}: the safeguard fell back to q = I")
    print("TPU record for context only (BENCH_r05, TPU v5e, iterations): "
          + "; ".join(f"{s}^3 {v}" for s, v in TPU_SCALING_RECORD.items()))
    if failures:
        raise AssertionError("; ".join(failures))
    return totals


def check_bands_against_cpu(dev):
    """The 64^3 learned factor and q: the card (float32, kernels) against
    the port's CPU float64 path."""
    out = {}
    for device, dtype in ((dev, torch.float32), ("cpu", torch.float64)):
        a, _ = scaling.scaling_operator(64, dtype, device)
        learned, power, _, _ = scaling.load_models(dtype, device)
        plan = build_structured_plan((64, 64, 64), power=power)
        with torch.no_grad():
            bands, q = structured_setup(a, plan, learned)
        out[device] = (bands.double().cpu(), q.double().cpu())
    (b_dev, q_dev), (b_cpu, q_cpu) = out[dev], out["cpu"]
    rel = float((b_dev - b_cpu).abs().max() / b_cpu.abs().max())
    rel_q = float((q_dev - q_cpu).abs().max() / q_cpu.abs().max())
    print(f"64^3 learned factor: card f32 vs CPU f64, max abs diff / "
          f"max|bands| = {rel:.3e}, q {rel_q:.3e} (limit {BANDS_RTOL})")
    if not (rel <= BANDS_RTOL and rel_q <= BANDS_RTOL):
        raise AssertionError("the 64^3 learned setup disagrees with the CPU")


def check_setup_against_cpu(suite, checkpoint, cases=(0,)):
    """fsai and learned M of the split's ``cases``: the card (float32,
    kernel B1) against the port's CPU float64 path."""
    cpu = BenchmarkSuite(
        suite.data_set, neural_fsai_from_checkpoint(load_checkpoint(checkpoint)),
        techniques=("fsai", "learned"), device="cpu", dtype=torch.float64,
        fsai_power=suite.fsai_power, learned_power=suite.learned_power,
    )
    worst = 0.0
    n_pad = suite.data_set.dof_pad
    with torch.no_grad():
        for index in cases:
            for name in ("fsai", "learned"):
                m_dev = suite.setup(name, index)[1]
                m_cpu = cpu.setup(name, index)[1]
                if tuple(m_dev.shape) != (n_pad, n_pad) or not bool(
                        torch.isfinite(m_dev).all()):
                    raise AssertionError(f"{name}: bad M on the card")
                rel = float((m_dev.double().cpu() - m_cpu).abs().max()
                            / m_cpu.abs().max())
                kind = ("generic" if index in suite.generic_cases[name]
                        else "range")
                print(f"case {index} ({kind} plan) {name} M: card f32 vs "
                      f"CPU f64, max abs diff / max|M| = {rel:.3e} (limit "
                      f"{M_RTOL})")
                if not rel <= M_RTOL:
                    raise AssertionError(
                        f"case {index} {name} setup disagrees with the CPU")
                worst = max(worst, rel)
    return worst


def check_bsr_spmm(dev, card):
    """Phase 3c, kernel half: B3 against its plain version on the
    roofline's BSR operators at m = 1 and on the frame operator at
    m in B3_WIDE; returns the max error, the times and the operators."""
    rng = np.random.default_rng(3)
    operators = roofline.bsr_operators(dev)
    max_err, times = 0.0, {}
    with torch.no_grad():
        for name, a, nnz in operators:
            widths = (1,) + (B3_WIDE if name == B3_MAIN else ())
            library = bsr_library(a)
            for m in widths:
                shape = (a.n_pad,) if m == 1 else (a.n_pad, m)
                x = torch.tensor(rng.standard_normal(shape, dtype=np.float32),
                                 device=dev)
                if m == 1:
                    def kernel(): return bsr_matvec(a, x)
                    def plain(): return a.matvec(x)
                else:
                    def kernel(): return bsr_matmat(a, x)
                    def plain(): return a.matmat(x)
                got = kernel()
                torch.cuda.synchronize()
                ref = plain()
                err = float((got - ref).abs().max())
                bound = B3_RTOL * float(ref.abs().max()) + B3_ATOL
                if not bool(torch.isfinite(got).all()) or not err <= bound:
                    raise AssertionError(
                        f"B3 disagrees with its plain version on {name} "
                        f"m={m}: max abs err {err} > {bound}")
                max_err = max(max_err, err)
                lib_err = float((library @ x - ref).abs().max())
                times[(name, m)] = measure(
                    f"B3 {name:<18} R {a.n_block_rows:4d} S {a.slots:2d} bs "
                    f"{a.block_size} m {m:3d} (max abs err {err:.3e}, limit "
                    f"{bound:.3e}; library BSR {library.values().shape[0]} "
                    f"blocks, max abs err {lib_err:.3e})",
                    kernel, plain, lambda: library @ x,
                    bsr_work(library.values().shape[0], a.n_pad,
                             a.block_size, m), dev,
                    card, tensor_cores=m > 1)
                del x, got, ref
            del library
    return max_err, times, operators


def run_roofline_path(dev, card, operators):
    """Phase 3c, path half: the roofline entry point's two sections with
    the launch counts zeroed just before and read just after; writes the
    two CSVs next to the other results."""
    _backend.reset_launch_counts()
    dia = roofline.dia_section(dev)
    bsr = roofline.bsr_section(dev, operators)
    launches = _backend.launch_counts()
    plain = _backend.plain_cuda_counts()
    name = torch.cuda.get_device_name(dev)
    roofline.write_csv(dia, RESULTS / "spmv_roofline.csv", name)
    roofline.write_csv(bsr, RESULTS / "spmv_bsr.csv", name)
    for row in dia:
        print(f"roofline {row['grid']:>3}^3 B2: cold {row['dia_us']:.2f} us "
              f"{row['dia_gnnz_s']:.2f} Gnnz/s {row['dia_gb_s']:.1f} GB/s "
              f"HBM share {row['dia_bw_frac']:.3f}; resident "
              f"{row['dia_resident_us']:.2f} us HBM share "
              f"{row['dia_resident_bw_frac']:.3f}; stencil (plain) cold "
              f"{row['stencil_us']:.2f} us share {row['stencil_bw_frac']:.3f}"
              f" [{card}]")
    for row in bsr:
        print(f"roofline {row['operator']:<18} B3 fill "
              f"{row['block_fill']:.4f}: cold {row['bsr_us']:.2f} us "
              f"{row['bsr_gnnz_s']:.2f} Gnnz/s {row['bsr_block_gb_s']:.1f} "
              f"block GB/s HBM share {row['bsr_bw_frac']:.3f}; resident "
              f"{row['bsr_resident_us']:.2f} us HBM share "
              f"{row['bsr_resident_bw_frac']:.3f} [{card}]")
    print(f"roofline path launches {launches}; plain versions on the card "
          f"{plain}")
    if launches["bsr_spmm"] == 0 or launches["dia_spmv"] == 0:
        raise AssertionError("the roofline path did not launch B2 and B3")
    if any(plain.values()):
        raise AssertionError("the roofline path ran a plain version on "
                             "the card")
    return launches


def check_frames_path(dev, card):
    """Phase 4c: the frames family per case against the JAX reference
    counts; returns the suite and its kernel launches."""
    fixture = json.loads(FRAMES_FIXTURE.read_text())
    t0 = time.perf_counter()
    _backend.reset_launch_counts()
    suite = frames.run(dev, results_directory=RESULTS / "frames")
    launches = _backend.launch_counts()
    plain = _backend.plain_cuda_counts()
    wall_s = time.perf_counter() - t0
    if (fixture["seed"], fixture["cases"], fixture["n_pad"]) != (
            frames.SEED, len(suite.data_set), suite.data_set.dof_pad):
        raise AssertionError("the frames fixture describes another split")
    suite.dump_csv()
    header = (RESULTS / "frames" / "table.csv").read_text().splitlines()[0]
    if header != "technique," + ",".join(TABLE_PARAMETERS):
        raise AssertionError(f"frames table schema changed: {header}")
    expected = suite.setup_calls["fsai"] + suite.setup_calls["learned"]
    print(f"frames path: {len(suite.data_set)} cases, n_pad "
          f"{suite.data_set.dof_pad}, {wall_s:.1f} s wall (generation, "
          f"plans, timing reps); B1 launches {launches['gauss_jordan']} "
          f"(fsai + learned setups: {expected}); plain versions on the "
          f"card: {plain}")
    failures = []
    if launches["gauss_jordan"] == 0 or launches["gauss_jordan"] != expected:
        failures.append("B1 not launched once per fsai/learned setup")
    if any(plain.values()):
        failures.append(f"a plain version ran on the card: {plain}")
    for name in ("fsai", "learned"):
        got = sorted(suite.generic_cases[name])
        if got != fixture["generic_cases"][name]:
            failures.append(f"{name}: generic plan on {got}, reference "
                            f"{fixture['generic_cases'][name]}")
    print(f"per technique on {card} (median ms over cases; generic plan on "
          f"cases {sorted(suite.generic_cases['fsai'])}):")
    for name in frames.TECHNIQUES:
        iters = np.asarray(suite.iterations[name])
        ref = np.asarray(fixture["iterations"][name])
        mean, ref_mean = float(iters.mean()), float(ref.mean())
        delta = np.abs(iters - ref)
        success = [s == 100.0 for s in suite.successes[name]]
        print(f"  {name:<8} iters {mean:7.3f} (JAX CPU f32 {ref_mean:7.3f}, "
              f"max |delta| per case {int(delta.max())}) setup "
              f"{np.median(suite.setups[name]) * 1e3:.3f} solve "
              f"{np.median(suite.durations[name]) * 1e3:.3f} total "
              f"{np.median(suite.totals[name]) * 1e3:.3f} success "
              f"{np.mean(success) * 100:.0f}%")
        if success != fixture["success"][name]:
            failures.append(f"{name}: successes differ from the reference")
        mean_tol = 0.05 if name == "vanilla" else 0.01
        if mean_tol is not None and abs(mean - ref_mean) > mean_tol * ref_mean:
            failures.append(f"{name}: mean {mean} vs reference {ref_mean}")
        case_tol = (np.maximum(2, 0.05 * ref) if name in FRAMES_DRIFT
                    else 2)
        if (delta > case_tol).any():
            failures.append(f"{name}: a case is {int(delta.max())} "
                            "iterations off")
    if failures:
        raise AssertionError("; ".join(failures))
    return suite, launches


def check_gauss_jordan_frames(suite, card, index):
    """B1 against its plain version on the real local systems of frames
    case ``index``'s learned range plan (w 41)."""
    _, ell, _ = suite._system(index)
    kind, plan, a_dense, _ = suite._fsai_plan(
        index, ell, width=suite.model.width, power=suite.learned_power)
    if kind != "range":
        raise AssertionError(f"frames case {index} is not a range case")
    with torch.no_grad():
        sub, e = local_systems(plan, range_local_blocks(plan, a_dense))
        n, w = sub.shape[:2]
        if w != 41:
            raise AssertionError(f"frames systems of width {w}, not 41")
        err = check_gauss_jordan_on(sub, e, f"frames case {index}")
        measure(f"B1 on frames case {index}'s local systems (N {n}, w {w}; "
                f"max abs err {err:.3e}, rtol {GJ_RTOL}, atol {GJ_ATOL})",
                lambda: masked_gauss_jordan(sub, e),
                lambda: masked_gauss_jordan_torch(sub, e),
                lambda: torch.linalg.solve_ex(sub, e[..., None]),
                gauss_jordan_work(n, w), sub.device, card)
    return err


def hold_counts(label, iters, ref, success, ref_success, case_tol,
                mean_tol, failures):
    """Per-case iterations against a reference: success equal, the mean
    within ``mean_tol`` (relative; None: not held), every case within
    ``case_tol``
    (a number or an array); appends to ``failures``, returns (mean,
    reference mean, max |delta|)."""
    iters, ref = np.asarray(iters), np.asarray(ref)
    mean, ref_mean = float(iters.mean()), float(ref.mean())
    delta = np.abs(iters - ref)
    if success != ref_success:
        failures.append(f"{label}: successes differ from the reference")
    if mean_tol is not None and abs(mean - ref_mean) > mean_tol * ref_mean:
        failures.append(f"{label}: mean {mean} vs reference {ref_mean}")
    if (delta > case_tol).any():
        failures.append(f"{label}: a case is {int(delta.max())} iterations "
                        "off")
    return mean, ref_mean, int(delta.max())


def check_batched_path(suite, fixture, card):
    """Phase 4d: the batched protocol on the main path's split through
    the entry point's ``run_batched``, against the JAX reference's
    ``run_batched`` counts; returns the records and the launches."""
    ref = fixture["batched"]
    t0 = time.perf_counter()
    _backend.reset_launch_counts()
    batched = run_batched(suite)
    launches = _backend.launch_counts()
    plain = _backend.plain_cuda_counts()
    wall_s = time.perf_counter() - t0
    suite.dump_csv_batched()
    header = (RESULTS / "batched.csv").read_text().splitlines()[0]
    failures = []
    if header != "technique," + ",".join(BATCHED_KEYS):
        failures.append(f"batched.csv schema changed: {header}")
    expected = sum(suite.batched_launch_groups.get(t, 0)
                   for t in ("fsai", "learned"))
    print(f"batched path: {len(suite.data_set)} cases, {wall_s:.1f} s wall "
          f"(setups, warm-up solves, timing reps); B1 launches "
          f"{launches['gauss_jordan']} (fsai + learned builds x plan "
          f"groups: {expected}; builds {suite.batched_builds}); plain "
          f"versions on the card: {plain}")
    if launches["gauss_jordan"] == 0 or launches["gauss_jordan"] != expected:
        failures.append("B1 not launched once per plan group and build")
    if any(plain.values()):
        failures.append(f"a plain version ran on the card: {plain}")
    if list(batched) != ref["techniques"]:
        failures.append(f"batched techniques {list(batched)}, reference "
                        f"{ref['techniques']}")
    print(f"batched per technique on {card} (ms: setup median of "
          f"{SETUP_REPS} builds, one for the host-bound setups; solve "
          f"median of {SOLVE_REPS} fixed-trip runs):")
    for name, s in batched.items():
        r = np.asarray(ref["iterations"][name])
        drift = name == "vanilla"
        mean, ref_mean, worst = hold_counts(
            f"batched {name}", s["iterations_per_case"], r, s["success"],
            ref["success"][name], np.maximum(2, 0.05 * r) if drift else 2,
            0.05 if drift else 0.01, failures)
        print(f"  {name:<28} iters {mean:7.2f} (JAX CPU f32 {ref_mean:7.2f},"
              f" max |delta| per case {worst}) trips {s['trips']} (JAX "
              f"{ref['trips'][name]}) M {s['m_dtype']} (JAX "
              f"{ref['m_dtype'][name]}) setup {s['setup_batch'] * 1e3:.3f} "
              f"solve {s['solve_batch'] * 1e3:.3f} total "
              f"{s['total_batch'] * 1e3:.3f} success {s['success']:.0f}%")
        if s["m_dtype"] != ref["m_dtype"][name]:
            print(f"  {name}: settled on {s['m_dtype']} M where the JAX "
                  f"reference settled on {ref['m_dtype'][name]}")
    print(f"batched ratios on {card}: {batched_ratios(batched)}")
    print("TPU record for context only (BENCH_r05, TPU v5e, batched mean "
          "iters): " + ", ".join(f"{k} {v}"
                                 for k, v in TPU_BATCHED_RECORD.items()))
    if failures:
        raise AssertionError("; ".join(failures))
    return batched, launches


def check_gauss_jordan_batched(suite, card):
    """B1 against its plain version on the real local systems of one
    batched learned build: the largest range group, every case's columns
    in one launch (w 24, N = cases x n_pad)."""
    groups = suite._batched_fsai_inputs(
        suite.learned_power or suite.fsai_power, suite.model.width)
    idx, plans, _, _ = max((g for g in groups if g[3] == "range"),
                           key=lambda g: g[0].shape[0])
    a_tilde = suite._batched_common()["a_tilde"]
    with torch.no_grad():
        sub, e = local_systems(plans, range_local_blocks(plans, a_tilde[idx]))
        w = sub.shape[-1]
        sub, e = sub.reshape(-1, w, w), e.reshape(-1, w)
        n = sub.shape[0]
        if w != GJ_BATCHED_W:
            raise AssertionError(f"batched learned systems of width {w}")
        err = check_gauss_jordan_on(sub, e, f"the batched build (N {n})")
        rec = measure(
            f"B1 on the batched learned build's local systems ({idx.shape[0]}"
            f" cases, N {n}, w {w}; max abs err {err:.3e}, rtol {GJ_RTOL}, "
            f"atol {GJ_ATOL})",
            lambda: masked_gauss_jordan(sub, e),
            lambda: masked_gauss_jordan_torch(sub, e),
            lambda: torch.linalg.solve_ex(sub, e[..., None]),
            gauss_jordan_work(n, w), sub.device, card)
    return err, rec


def check_irregular_path(dev, fixture, card):
    """Phase 4e: bench.py's irregular split per case through its entry
    point, against the JAX reference counts; returns the suite and its
    launches."""
    ref = fixture["irregular"]
    t0 = time.perf_counter()
    _backend.reset_launch_counts()
    suite = irregular.run(dev, results_directory=RESULTS / "irregular")
    launches = _backend.launch_counts()
    plain = _backend.plain_cuda_counts()
    wall_s = time.perf_counter() - t0
    if (ref["seed"], ref["cases"], ref["n_pad"]) != (
            irregular.SEED, len(suite.data_set), suite.data_set.dof_pad):
        raise AssertionError("the irregular fixture describes another split")
    suite.dump_csv()
    header = (RESULTS / "irregular" / "table.csv").read_text().splitlines()[0]
    failures = []
    if header != "technique," + ",".join(TABLE_PARAMETERS):
        failures.append(f"irregular table schema changed: {header}")
    expected = suite.setup_calls["fsai"] + suite.setup_calls["learned"]
    print(f"irregular path: {len(suite.data_set)} cases, n_pad "
          f"{suite.data_set.dof_pad}, {wall_s:.1f} s wall (generation, "
          f"plans, timing reps); B1 launches {launches['gauss_jordan']} "
          f"(fsai + learned setups: {expected}); plain versions on the "
          f"card: {plain}")
    if launches["gauss_jordan"] == 0 or launches["gauss_jordan"] != expected:
        failures.append("B1 not launched once per fsai/learned setup")
    if any(plain.values()):
        failures.append(f"a plain version ran on the card: {plain}")
    for name in ("fsai", "learned"):
        got = sorted(suite.generic_cases[name])
        if got != ref["generic_cases"][name] or not got:
            failures.append(f"{name}: generic plan on {got}, reference "
                            f"{ref['generic_cases'][name]}")
    print(f"irregular per technique on {card} (median ms over cases; "
          f"generic plan on cases {sorted(suite.generic_cases['fsai'])}):")
    for name in irregular.TECHNIQUES:
        r = np.asarray(ref["iterations"][name])
        success = [s == 100.0 for s in suite.successes[name]]
        mean, ref_mean, worst = hold_counts(
            f"irregular {name}", suite.iterations[name], r, success,
            ref["success"][name],
            np.maximum(2, 0.05 * r) if name in FRAMES_DRIFT else 2,
            IRREGULAR_MEAN_TOL.get(name, 0.01), failures)
        print(f"  {name:<8} iters {mean:7.3f} (JAX CPU f32 {ref_mean:7.3f}, "
              f"max |delta| per case {worst}) setup "
              f"{np.median(suite.setups[name]) * 1e3:.3f} solve "
              f"{np.median(suite.durations[name]) * 1e3:.3f} total "
              f"{np.median(suite.totals[name]) * 1e3:.3f} success "
              f"{np.mean(success) * 100:.0f}%")
    print("TPU record for context only (BENCH_r05, TPU v5e, irregular mean "
          "iters): " + ", ".join(f"{k} {v}"
                                 for k, v in TPU_IRREGULAR_RECORD.items()))
    if failures:
        raise AssertionError("; ".join(failures))
    return suite, launches


def build_report(build_s):
    """Phase 2's record: the build's wall time, each source's nvcc time,
    and ptxas's registers and spills per kernel instance; fails on any
    spill in B1's or B3's instances."""
    print(f"build: {build_s:.1f} s (0 if cached); nvcc per source "
          + ", ".join(f"{src} {s:.1f} s"
                      for src, s in sorted(_backend.build_seconds.items())))
    spills = []
    for section in _backend.build_log.split("--- ")[1:]:
        source, text = section.split("\n", 1)
        for fn, stack, stores, loads, regs in PTXAS_FUNCTION.findall(text):
            print(f"ptxas {source} {fn}: {regs} registers, {stack} bytes "
                  f"stack, {stores} bytes spill stores, {loads} bytes spill "
                  f"loads")
            if source in NO_SPILL_SOURCES and int(stores) + int(loads):
                spills.append(fn)
    if spills:
        raise AssertionError(f"ptxas spilled registers in {spills}")


def main() -> None:
    # 1. device
    dev = _backend.device()
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(dev)}")

    # 2. build
    t0 = time.perf_counter()
    _backend.kernel_library()
    build_report(time.perf_counter() - t0)

    # 3. kernels against their plain versions
    gj_err, gj_times = check_gauss_jordan(dev, card)
    dia_err, dia_times = check_dia_spmv(dev, card)
    bsr_err, bsr_times, bsr_ops = check_bsr_spmm(dev, card)

    # 3c. the roofline path
    roofline_launches = run_roofline_path(dev, card, bsr_ops)
    del bsr_ops

    # 4. the per-case main path
    fixture = json.loads(FIXTURE.read_text())
    t0 = time.perf_counter()
    _backend.reset_launch_counts()
    suite = run_main_path(dev, results_directory=RESULTS)
    launches = _backend.launch_counts()["gauss_jordan"]
    plain = _backend.plain_cuda_counts()
    wall_s = time.perf_counter() - t0
    if (fixture["seed"], fixture["cases"], fixture["n_pad"]) != (
            SEED, len(suite.data_set), suite.data_set.dof_pad):
        raise AssertionError("the reference fixture describes another split")
    suite.dump_csv()
    header = (RESULTS / "table.csv").read_text().splitlines()[0]
    if header != "technique," + ",".join(TABLE_PARAMETERS):
        raise AssertionError(f"table schema changed: {header}")
    n_cases = len(suite.data_set)
    print(f"main path: {n_cases} cases, n_pad {suite.data_set.dof_pad}, "
          f"{wall_s:.1f} s wall (generation, plans, timing reps)")
    expected = suite.setup_calls["fsai"] + suite.setup_calls["learned"]
    print(f"B1 launches on the main path: {launches} "
          f"(fsai + learned setups: {expected}); plain versions on the "
          f"card: {plain}")
    if launches == 0 or launches != expected:
        raise AssertionError("main path did not run B1 once per setup")
    if any(plain.values()):
        raise AssertionError("the main path ran a plain version on the card")

    batched_fixture = json.loads(BATCHED_FIXTURE.read_text())
    if (batched_fixture["seed"], batched_fixture["cases"],
            batched_fixture["n_pad"]) != (SEED, n_cases,
                                          suite.data_set.dof_pad):
        raise AssertionError("the batched fixture describes another split")
    failures = []
    print(f"per technique on {card} (median ms over cases):")
    for name in suite.techniques:
        # vanilla / jacobi / fsai / learned: the per-case fixture, mean
        # within 1%; the IC and AMG techniques: the batched fixture's
        # per-case counts
        ref = (fixture if name in fixture["iterations"]
               else batched_fixture["percase"])
        success = [s == 100.0 for s in suite.successes[name]]
        mean, ref_mean, worst = hold_counts(
            name, suite.iterations[name], ref["iterations"][name], success,
            ref["success"][name], 2,
            0.01 if ref is fixture else None, failures)
        print(f"  {name:<28} iters {mean:7.2f} (JAX CPU f32 {ref_mean:7.2f},"
              f" max |delta| per case {worst}) setup "
              f"{np.median(suite.setups[name]) * 1e3:.3f} solve "
              f"{np.median(suite.durations[name]) * 1e3:.3f} total "
              f"{np.median(suite.totals[name]) * 1e3:.3f} success "
              f"{np.mean(success) * 100:.0f}%")
    print(f"input_prep_s: {suite.prep_seconds}")
    print("TPU record for context only (BENCH_r05, TPU v5e, mean iters): "
          + ", ".join(f"{k} {v}" for k, v in TPU_RECORD.items()))
    if failures:
        raise AssertionError("; ".join(failures))
    check_setup_against_cpu(
        suite, REPO / "assets" / "checkpoints_fsai" / "best.msgpack")

    # 4d. the batched protocol on the same split; B1 at its shape
    _, batched_launches = check_batched_path(suite, batched_fixture, card)
    gj_batched_err, _ = check_gauss_jordan_batched(suite, card)
    gj_err = max(gj_err, gj_batched_err)
    del suite

    # 4e. the irregular split
    _, irregular_launches = check_irregular_path(dev, batched_fixture, card)

    # 4b. the structured-grid scaling path
    scaling_launches = check_scaling_path(dev, card)
    check_bands_against_cpu(dev)

    # 4c. the frame-structure family
    frames_suite, frames_launches = check_frames_path(dev, card)
    generic = sorted(frames_suite.generic_cases["learned"])
    range_case = min(set(range(len(frames_suite.data_set))) - set(generic))
    gj_err = max(gj_err, check_gauss_jordan_frames(frames_suite, card,
                                                   range_case))
    check_setup_against_cpu(frames_suite, frames.CHECKPOINT,
                            cases=(range_case, generic[0]))

    # 5. records
    paths = {"per-case": {"gauss_jordan": launches},
             "batched": batched_launches, "irregular": irregular_launches,
             "scaling": scaling_launches, "roofline": roofline_launches,
             "frames": frames_launches}
    print("launches per path: " + "; ".join(
        f"{path} {counts}" for path, counts in paths.items()))
    print(card_line())
    print(json.dumps({"kernels": [{
        "name": "gauss_jordan",
        "route": "cuda",
        "source": "deeppreconditioning_tpu_torch/csrc/gauss_jordan.cu",
        "replaces": "deeppreconditioning_tpu/ops/fsai.py:614",
        "launches": sum(c.get("gauss_jordan", 0) for c in paths.values()),
        "max_abs_err": gj_err,
        **gj_times[GJ_MAIN_SHAPE],
    }, {
        "name": "dia_spmv",
        "route": "cuda",
        "source": "deeppreconditioning_tpu_torch/csrc/dia_spmv.cu",
        "replaces": "deeppreconditioning_tpu/ops/pallas_spmv.py:32",
        "launches": (scaling_launches["dia_spmv"]
                     + roofline_launches["dia_spmv"]),
        "max_abs_err": dia_err,
        **dia_times[B2_MAIN],
    }, {
        "name": "bsr_spmm",
        "route": "cuda",
        "source": "deeppreconditioning_tpu_torch/csrc/bsr_spmm.cu",
        "replaces": "deeppreconditioning_tpu/ops/pallas_bsr.py:69",
        "launches": roofline_launches["bsr_spmm"],
        "max_abs_err": bsr_err,
        **bsr_times[(B3_MAIN, 1)],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
