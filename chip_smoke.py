#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure):
  1. device: a CUDA device is required; print the card's name and power
     limit as nvidia-smi reports them;
  2. build: compile and load the CUDA kernels from ``csrc/`` (nvcc, one
     process per source, in parallel); print each source's nvcc time and
     ptxas's registers, stack and spills per kernel instance, and fail on
     any spill in B1's, B2's or B3's instances but B1's float64 ones,
     whose spills are printed and not refused (SPILL_RECORDED);
  2b. the host runtime (``csrc/host_runtime.cpp``, g++ into
     ``build/torch_host/``): it must build and load (there is no numpy
     run in its place); print its build seconds; on the first flagship
     case each entry point against the port's numpy version: ic0 within
     HOST_IC0_RTOL, levels and conv_plan (PreconditionerNet's stride-1
     layers) equal, ict(1, 0.1) a valid factor (lower triangular, finite,
     positive diagonal), fvm_assemble on a 24 x 32 grid within
     HOST_FVM_RTOL; ic0, levels and conv_plan timed natively and in numpy
     on the host clock (phase 4c holds ic0 against numpy on a frames case
     too);
  3. kernel B1 (batched Gauss–Jordan) against its plain PyTorch version
     at w in {4, 8, 13, 24, 31, 32, 41, 63} and N in {1024, 131072} and at
     the scaling path's launches (w 13 and 4, N = 262144), float32, within
     rtol 1e-4 / atol 1e-6; after phase 4c also on the real w-41 local
     systems of a frames case's range plan and of the frames batched
     learned build's range and generic groups, after phase 4l on the mesh
     study's largest case (each timed as here);
  3b. kernel B2 (DIA SpMV) against its plain PyTorch version on
     ``poisson_dia`` at 512^2, 128^3 and 256^3, on the 13-band halves
     (c_up, c_low) of a 128^3 structured FSAI factor and on the Galerkin
     coarse operators of the 128^3 scaling operator, float32, within
     |kernel - plain| <= 1e-6 + 1e-5 |plain|, with a report of whether
     each result is equal bit for bit (the design promises it) and of
     each per-call time against the library call's, as a ratio; the SpMV
     section's cold and resident GB/s and HBM share;
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
  3d. B1's float64 instance against its float64 plain version at w 24, N
     1024 and 131 072, and w 41, N 131 072, within rtol 1e-10 / atol
     1e-12, timed as phase 3 with ``torch.linalg.solve_ex`` in float64 and
     the bound of its float64 bytes (3350 GB/s) or flops (the card's FP64
     rate outside the tensor cores, ``utils.profiling.fp64_tflop_s``);
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
  4k. incomplete_lu (ICT(1, 0.1) in the host runtime, two level-scheduled
     solves) per case on the same split through the test-stage entry
     point (``python -m deeppreconditioning_tpu_torch.test --techniques
     incomplete_lu``'s ``run``, 5 kappa cases), against the JAX CPU f32
     fixture (``ilu_iterations.json``, the reference's native ICT):
     success as the fixture, per-case |delta| <= 2, the mean within 1%,
     densities and kappas as the fixture's (float64 host work; kappa
     within ILU_KAPPA_RTOL); the mean and kappa printed beside the TPU
     table's 30.9 and 185.37 (``assets/results/table.csv``);
  4f. training, after the per-case path and on its generated cases,
     through the train entry point (``python -m
     deeppreconditioning_tpu_torch.train``'s ``run``): one flagship epoch
     (the 400-case train split shuffled with seed 69, batches of 4: 95
     Adam steps of ``pcg_loss`` over 16 PCG steps at lr 1e-4, width 24,
     hidden 64, degree 2, power 4, range plans at H 256) from the JAX init
     parameters (``tests/fixtures/torch_port/train_init.msgpack``), the 5
     held-out batches validated before and after.  Held against the JAX
     CPU float32 run (``train_epoch.json``): step 0's loss within
     TRAIN_STEP0_RTOL, every step within TRAIN_STEP_RTOL, the epoch mean
     equal to the ``train/loss/inverse`` record of ``metrics.jsonl``; per
     case validation iterations within 1, their mean within 1%, the
     validation loss within TRAIN_VAL_RTOL; B1 launched once per step and
     per validation batch, no plain version on the card; ``best.msgpack``
     read back equal to the model.  Then B1 against its plain version on
     one training batch's local systems (w 24, N 4 x 1024), timed as in
     phase 3;
  4h. the conv families' training, after phase 4f and on its generated
     cases, through the train entry point (``python -m
     deeppreconditioning_tpu_torch.train --model PreconditionerNet`` and
     ``--model PreconditionerSparseUNet``'s ``run``): one epoch each at
     params.yaml's channels (1, 16, 32, 64, 32, 16, 1) on the 400-case
     train split shuffled with seed 69, batches of 4 with their conv plans
     (95 Adam steps of ``inverse_loss`` at lr 1e-3, 5 batches validated),
     from the JAX init parameters
     (``tests/fixtures/torch_port/conv_train_init_*.msgpack``).  Held
     against the JAX CPU float32 epoch (``conv_train_epoch.json``): the
     same case order, n_pad, nnz0_pad and level buckets; step 0's loss
     within CONV_STEP0_RTOL, every step within CONV_STEP_RTOL; per case
     validation iterations within CONV_ITERS_CASE, their mean within
     CONV_ITERS_MEAN, the validation loss within CONV_VAL_RTOL;
     ``metrics.jsonl`` equal to the epoch's record; ``best.msgpack``
     read back equal to the model; no kernel launched and no plain
     version run on the card (the path has no hand-written kernel: its
     gather-GEMM and its backward, the dense products and the PCG are
     PyTorch's, as they are XLA's in the reference).  Prints the plan
     build seconds (untimed prep), the epoch seconds, the step median /
     min / max, the validation seconds per batch, the plans' bytes on the
     card and the peak memory of the run;
  4g. the conv path, on the per-case path's split, through the test-stage
     entry point (``python -m deeppreconditioning_tpu_torch.test``'s
     ``run``, technique learned, median of 3 timed runs per case): the
     dense apply for the three conv checkpoints
     (``assets/checkpoints/best.msgpack`` and ``checkpoints_v2``,
     PreconditionerNet; ``checkpoints_unet``, PreconditionerSparseUNet)
     and the factor apply for the first.  Per run: the level buckets as
     the JAX reference's, per-case iterations within 2 of the JAX CPU
     float32 counts (``tests/fixtures/torch_port/conv_iterations.json``),
     the mean within 1%, success equal; no kernel launched and no plain
     version run on the card (the path has no hand-written kernel: its
     gather-GEMM, dense products and PCG are PyTorch's, as they are XLA's
     in the reference); case 0's M (dense) or L values (factor) on the
     card within M_RTOL of the port's CPU float64 setup.  Prints each
     run's setup (forward and M), solve and total medians and the untimed
     plan preparation.  Then, on the factor run's case 0, the two applies
     alone: z = M r (dense) and z = L (L^T r) (factor) agree within
     M_RTOL, and each is timed as PCG issues it (a loop of
     CONV_APPLY_CALLS calls between two events, median of
     CONV_APPLY_ROUNDS rounds taken in turn) and replayed from a CUDA
     graph (device time only);
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
     Timed as the per-case path (median of SHALLOW_TIMING_REPS runs).
     Held as the frames path, against the fixture's ``irregular`` part,
     with the learned mean within 2% (its float32 drift, ROADMAP C); the
     generic plan on exactly the fixture's cases.  Then on the same cases
     the batched protocol through ``python -m deeppreconditioning_tpu_torch.
     bench.batched_probe --irregular``'s ``run`` (vanilla, jacobi,
     incomplete_cholesky_neumann, fsai, learned at power 2, chunk 20,
     SHALLOW_BATCHED_REPS builds and solves; the band spread is past the
     cap, so the learned M is built dense, bf16 first) against the JAX CPU
     f32 ``run_batched`` (``irregular_batched_iterations.json``): the
     learned route and spread as the fixture's, per-case |delta| <= 2
     (vanilla and jacobi max(2, 5%)), means within 1% (vanilla 5%, learned
     2%), success equal, the settled M dtype printed beside the fixture's;
     B1 launched once per plan-group chunk and build, no plain version and
     no host fallback on the card; the peak memory printed.  Then B1
     against its plain version on the dense build's generic group (w 24,
     N 10 x 1408), timed as in phase 3;
  4b. the structured-grid scaling path through its entry point
     (``python -m deeppreconditioning_tpu_torch.bench.scaling``'s
     ``run_scaling``) at 64^3 and 128^3: vanilla, jacobi, fsai, learned,
     gmg_jacobi, gmg_learned, and amg (``--with-amg``: aggregation AMG
     built once on the host from the jittered operator, a V-cycle on the
     card, out of the sequences).  Requires every technique converged,
     iterations against the JAX reference
     (``tests/fixtures/torch_port/scaling_iterations.json``, amg
     ``scaling_amg_iterations.json`` with its hierarchy's level sizes:
     vanilla within 5%, the others within max(2, 2%)), no safeguard
     fallback for
     learned, B2 launched by every technique, B1 launched n_pad / 2^18
     times per structured setup (fsai, learned, gmg_learned), no plain
     version run on the card, and the reference's CSV header; the 64^3
     learned factor and q on the card agree with the port's CPU float64
     path to 1e-4 (relative to max |bands|).  The same run solves the
     multi-RHS sequences (k 2, 4, 8 per technique, ``multi_rhs.csv``'s
     header): every sequence converged, each mean within max(1
     iteration, 1%) at 64^3 and max(1, 2%) at 128^3 (vanilla 5% at both)
     of the span between the JAX CPU f32 fixture and the committed TPU
     ``assets/results/multi_rhs.csv``; the crossover k is printed.  Then at 64^3 the known-solution rows (``rhs ax``) and the
     constant-coefficient rows (``sigma 0``) against the fixture:
     iterations within max(2, 2%) (vanilla within 5% of the span between
     the fixture's float32 and float64 counts), converged, ``x_rel_err``
     below 1e-2 and within a factor 4 of the fixture's where the counts
     agree;
  4i. the structured family's training through its entry point
     (``python -m deeppreconditioning_tpu_torch.train.structured``'s
     ``run``) from the JAX init (``structured_train_init_*.msgpack``): w
     13 at the script's defaults (12^3, 32 samples, 400 steps) and w 4
     (power 1, degree 0, 25 steps), against the JAX CPU f32 run
     (``structured_train.json``): step 0 within STRUCT_STEP0_ABS of the
     log, the steps whose reference loss is above STRUCT_TIGHT_ABOVE
     within STRUCT_STEP_ABS and the window's best within
     STRUCT_FINAL_ABS; every loss finite; B1
     launched once per step, B2 once per operator product forward and
     once backward, no plain version on the card; the payload read back
     equal to the best parameters.  The w-13 checkpoint then deploys
     through ``run_scaling`` at 64^3: learned converged in fewer
     iterations than fsai.  Then B1 on the trainer's local systems (w 13
     and w 4, N 65 536) and batched B2 (32 x 7 x 2048) forward and
     backward (on A^T) against their plain versions, timed as in phase 3,
     and the autograd function's gradient against the plain product's;
  4j. the matrix-free 256^3 CG (``python -m
     deeppreconditioning_tpu_torch.bench.large_solve``): the reference's
     line, a finite solution, converged unless it ran 1024 iterations;
  4c. the frame-structure family through its entry point
     (``python -m deeppreconditioning_tpu_torch.bench.frames``'s ``run``):
     200 frame cases from seed 69422, the 40-case test split, the frames
     NeuralFSAI checkpoint (w 41), per case vanilla / jacobi /
     incomplete_cholesky / fsai / learned (median of SHALLOW_TIMING_REPS
     timed runs, one for IC), then ``run_batched`` (vanilla, jacobi, fsai,
     learned in band form; SHALLOW_BATCHED_REPS builds and solves).
     Requires per-case success equal to the JAX reference's
     (``tests/fixtures/torch_port/frames_iterations.json``; IC
     ``frames_ic_iterations.json``), mean iterations within 1% (vanilla
     5%), per-case |delta| <= 2 (vanilla and jacobi max(2, 5%): their
     float32 CG drifts between platforms on these stiff systems; IC within
     2 of the span of the fixture's float32 and float64 counts), IC's
     kappa of case 0 within KAPPA_PRE_RTOL, the generic plan on exactly
     the fixture's cases; the batched run held as phase 4e's against
     ``frames_batched_iterations.json`` (means within 1%, vanilla 5%;
     vanilla per case within max(2, FRAMES_BATCHED_VANILLA_CASE), the
     same row rerun in float64 on the card and printed beside it; the
     learned route band form at the fixture's spread, its generic group's
     bands from ``extract_bands``); B1 launched once per fsai/learned
     setup and once per plan group and batched build, no plain version
     run on the card, the host runtime's ic0 and levels called and equal
     to numpy's on case 0; the reference's table and batched headers; the
     script's JSON line printed; fsai and learned M of a range case and a
     generic case on the card agree with the port's CPU float64 path to
     1e-4 (relative to max |M|).  Then B1 against its plain version on
     the real local systems of a range case (w 41, N 768) and of the
     batched learned build's range group (31 cases, N 23 808) and generic
     group (9 cases, N 6 912), timed as in phase 3;
  4l. the mesh-generalization study through its entry point (``python -m
     deeppreconditioning_tpu_torch.compare_meshes --cases-per-resolution
     1``'s ``run``): one sludge case at each of mesh_cells 2..6 from seed
     69, the flagship checkpoint through the one-off deployed setup,
     kappa(A) and kappa(M A) in float64 on the host, against the JAX CPU
     f32 fixture (``compare_meshes.json``): dof equal, kappa(A) within
     KAPPA_PRE_RTOL, kappa(M A) within KAPPA_POST_RTOL; B1 launched once
     per setup (the timed ones included), no plain version on the card;
     the csv header; each case's setup time and the peak memory printed.
     Then B1 against its plain version on the largest case's local
     systems (w 24, N 2048), timed as in phase 3;
  4m. the residual-parity report through its entry point (``python -m
     deeppreconditioning_tpu_torch.residual_parity``'s ``run``): the
     first 5 sludge cases, five techniques in float64 and float32 (the
     learned row through B1's float64 instance, w 24), against the JAX
     CPU fixture (``residual_parity.json``): float64 iterations within 1
     and each float64 residual curve within rtol 1e-6 over the common
     prefix, float32 within 2 (vanilla and jacobi max(2, 5%)); B1
     launched once per learned setup in each dtype, no plain version;
  4n. the distributed solver on the card in an NCCL group of world size 1
     (``parallel/``, through ``python -m deeppreconditioning_tpu_torch.
     scaling_bench``'s setup) at 64^3: the fsai factor's build (B1 once,
     w 4, N 262 144), then none / jacobi / block_jacobi_ic / fsai in
     allgather and halo modes, each with the iterations of
     ``preconditioned_conjugate_gradient`` on one device with the same
     apply and within the scaling path's bars of the JAX CPU f32 count at
     one shard (``parallel_iterations.json``); the solve timed (median of
     3, CUDA events) beside the byte model; no kernel in the solves, no
     plain version; then B1 on the build's real local systems, timed as
     in phase 3;
  4o. the generate stage through its entry point (``python -m
     deeppreconditioning_tpu_torch.generate_data``'s ``run``), the first
     50 cases on each assembly route: on numpy every file equal to the
     JAX package's (``residual_parity.json``'s sha256 digests: the text
     files, the archive's members); on native (the default) one
     ``fvm_assemble`` call per case and A within rtol 1e-13 of numpy's;
     phases 3d, 4m, 4n and 4o print their seconds;
  Every path before phase 4o runs on the numpy FVM assembly
  (``data.fvm.numpy_assembly``), the route its JAX fixture was made on;
  (d) on every path, the host runtime's counters read right after it ran:
     no numpy fallback anywhere (``_backend.host_fallback_counts``), and
     native calls on every path that factors, levelizes or plans (per case
     ic0 and levels, incomplete_lu ict and levels, batched and irregular
     batched ic0, frames ic0 and levels, PreconditionerNet's conv and
     conv-train runs conv_plan; the irregular per-case, training, scaling
     and mesh paths run none of these host steps, and the U-Net's layers
     are submanifold or strided, numpy by design);
  5. the launches per path, the host runtime's calls per path, the card
     line, one JSON line of kernel records
     (per kernel at its main shape, B1's float64 instance as
     ``gauss_jordan_f64``: per-call ``ms``, ``kernel_only_ms``,
     ``bound_ms``, ``bound_by``, ``library_ms``, ``plain_ms``), and the
     last line ``{"ok": true, "device": {...}}``.

Without a CUDA device, without a C++ compiler for the host runtime, or
outside a checkout of the repository, it exits non-zero and prints no
result.
"""

import contextlib
import gc
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg  # noqa: F401  (sp.linalg)
import torch

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

from deeppreconditioning_tpu_torch import _backend, native  # noqa: E402
from deeppreconditioning_tpu_torch.data.fvm import (  # noqa: E402
    DT,
    assemble_pressure_poisson,
    case_digests,
    generate_sludge_case,
    numpy_assembly,
)
from deeppreconditioning_tpu_torch import generate_data  # noqa: E402
from deeppreconditioning_tpu_torch import residual_parity  # noqa: E402
from deeppreconditioning_tpu_torch import scaling_bench  # noqa: E402
from deeppreconditioning_tpu_torch.parallel import multihost  # noqa: E402
from deeppreconditioning_tpu_torch.solvers.cg import (  # noqa: E402
    ell_matvec,
    preconditioned_conjugate_gradient,
)
from deeppreconditioning_tpu_torch.sparse.ell import ELLMatrix  # noqa: E402
from deeppreconditioning_tpu_torch.ops.ic0 import (  # noqa: E402
    _ic0_inplace,
    ic0_factor,
)
from deeppreconditioning_tpu_torch.ops.sparse_conv import (  # noqa: E402
    ConvSpec,
    build_conv_maps,
)
from deeppreconditioning_tpu_torch.ops.trisolve import (  # noqa: E402
    compute_levels,
)
from deeppreconditioning_tpu_torch.bench.__main__ import (  # noqa: E402
    SEED,
    SETUP_REPS,
    SOLVE_REPS,
    batched_ratios,
    flagship_cases,
    run as run_main_path,
    run_batched,
)
from deeppreconditioning_tpu_torch.bench.suite import (  # noqa: E402
    BATCHED_KEYS,
    TABLE_PARAMETERS,
    BenchmarkSuite,
    _learned_setup_device,
)
from deeppreconditioning_tpu_torch.bench import frames  # noqa: E402
from deeppreconditioning_tpu_torch.bench import batched_probe  # noqa: E402
from deeppreconditioning_tpu_torch import compare_meshes  # noqa: E402
from deeppreconditioning_tpu_torch.bench import irregular  # noqa: E402
from deeppreconditioning_tpu_torch.bench import roofline  # noqa: E402
from deeppreconditioning_tpu_torch.bench import scaling  # noqa: E402
from deeppreconditioning_tpu_torch.bench.spmv import (  # noqa: E402
    spmv_operators,
    spmv_section,
)
from deeppreconditioning_tpu_torch.config import params_show  # noqa: E402
from deeppreconditioning_tpu_torch.models.neural_fsai import (  # noqa: E402
    neural_fsai_case_plan,
    neural_fsai_from_checkpoint,
    scaled_tril,
)
from deeppreconditioning_tpu_torch.ops.bsr_spmm import (  # noqa: E402
    bsr_matmat,
    bsr_matvec,
)
from deeppreconditioning_tpu_torch.ops.dia_spmv import (  # noqa: E402
    dia_matvec,
)
from deeppreconditioning_tpu_torch.ops.fsai import (  # noqa: E402
    local_systems,
    lookup_local_blocks,
    pattern_col_width,
    range_local_blocks,
    tril_power_pattern,
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
    _band_reads,
    _local_systems,
    build_structured_plan,
    jacobi_scale_dia,
    slot_valid,
    structured_setup,
)
from deeppreconditioning_tpu_torch.train import (  # noqa: E402
    structured as structured_train,
)
from deeppreconditioning_tpu_torch.bench.large_solve import (  # noqa: E402
    large_solve,
)
from deeppreconditioning_tpu_torch.sparse.dia import pad_rows  # noqa: E402
from deeppreconditioning_tpu_torch.metrics import (  # noqa: E402
    symmetrize_tril,
)
from deeppreconditioning_tpu_torch.models.neural_fsai import (  # noqa: E402
    params_to_jax,
)
from deeppreconditioning_tpu_torch.train import (  # noqa: E402
    __main__ as train_entry,
)
from deeppreconditioning_tpu_torch import test as test_entry  # noqa: E402
from deeppreconditioning_tpu_torch.models import (  # noqa: E402
    conv_model_from_checkpoint,
    conv_params_to_jax,
)
from deeppreconditioning_tpu_torch.train.checkpoint import (  # noqa: E402
    load_checkpoint,
)
from deeppreconditioning_tpu_torch.utils.profiling import (  # noqa: E402
    bsr_work,
    card_peaks,
    dia_work,
    fp64_tflop_s,
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
NO_SPILL_SOURCES = ("gauss_jordan.cu", "dia_spmv.cu", "bsr_spmm.cu")
# B1's float64 instances (``gauss_jordan_kernel<double, W, T>``): their
# spills are printed and counted, not refused (its W 64 holds 130 doubles
# a thread).
SPILL_RECORDED = re.compile(r"gauss_jordan_kernelId")
GJ_RTOL, GJ_ATOL = 1e-4, 1e-6
M_RTOL = 1e-4  # card float32 setup vs CPU float64 setup, relative to max|M|
# BENCH_r05 per-case mean iterations, measured on a TPU v5e: context only
TPU_RECORD = {"jacobi": 99.19, "fsai": 23.15, "learned": 7.56}
BATCHED_FIXTURE = (REPO / "tests" / "fixtures" / "torch_port"
                   / "batched_iterations.json")
GJ_BATCHED_W = 24  # B1 at the batched learned build: w 24, N 100 x 1024
GJ_FRAMES_W = 41  # the frames checkpoint's width
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
TPU_AMG_RECORD = 12  # assets/results/scaling_learned.csv, 64^3 amg
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


TRAIN_FIXTURE = (REPO / "tests" / "fixtures" / "torch_port"
                 / "train_epoch.json")
TRAIN_INIT = REPO / "tests" / "fixtures" / "torch_port" / "train_init.msgpack"
# Training against the JAX CPU float32 epoch: step 0 sees the same params
# (float32 rounding of the forward only); later steps also carry the
# rounding of earlier updates.
TRAIN_STEP0_RTOL, TRAIN_STEP_RTOL, TRAIN_VAL_RTOL = 1e-5, 1e-3, 1e-3
TRAIN_ITERS_CASE, TRAIN_ITERS_MEAN = 1, 0.01
CONV_FIXTURE = (REPO / "tests" / "fixtures" / "torch_port"
                / "conv_iterations.json")
CONV_TRAIN_FIXTURE = (REPO / "tests" / "fixtures" / "torch_port"
                      / "conv_train_epoch.json")
CONV_TRAIN_INIT = {
    model: REPO / "tests" / "fixtures" / "torch_port" / f"conv_train_init_{tag}"
    ".msgpack" for model, tag in (("PreconditionerNet", "precond_net"),
                                  ("PreconditionerSparseUNet", "unet"))}
# Conv training against the JAX CPU float32 epoch: step 0 sees the same
# params (float32 rounding of the forward only); later steps also carry
# the rounding of earlier updates and of the backward's scatter-add, whose
# atomics on the card sum in no fixed order.  The CPU float32 rehearsal
# of the port drifted to 7.4e-6 (PreconditionerNet) and 3.3e-4 (U-Net).
CONV_STEP0_RTOL, CONV_STEP_RTOL, CONV_VAL_RTOL = 1e-5, 1e-3, 1e-3
CONV_ITERS_CASE, CONV_ITERS_MEAN = 2, 0.01
CONV_TIMING_REPS = 3
CONV_APPLY_CALLS, CONV_APPLY_ROUNDS = 100, 11  # the dense vs factor apply


# The irregular and frames paths time 3 runs per case and technique, not
# their entry points' 10 (bench.py's), to leave the structured training
# room in the time limit on a slow host.
SHALLOW_TIMING_REPS = 3
STRUCT_FIXTURE = (REPO / "tests" / "fixtures" / "torch_port"
                  / "structured_train.json")
STRUCT_INIT = {tag: REPO / "tests" / "fixtures" / "torch_port"
               / f"structured_train_init_{tag}.msgpack" for tag in ("w13", "w4")}
STRUCT_ARGS = {"w13": [], "w4": ["--power", "1", "--degree", "0", "--steps",
                                 "25"]}
# Structured training against the JAX CPU float32 run: step 0 within
# STRUCT_STEP0_ABS of the log; every step whose reference loss is above
# STRUCT_TIGHT_ABOVE within STRUCT_STEP_ABS; below it f32 rounding in 12
# unrolled steps sets the value, so those steps are held by the window's
# best, within STRUCT_FINAL_ABS.  The loss is invariant to the scale of
# q, so at the init (q = e0) q_0's gradient is zero but for rounding, and
# Adam's first step moves q_0 by lr times that rounding's sign: a CPU
# float32 rehearsal with the sign flipped drifts 2e-4 a step, up to 0.098
# above -25 (the first card run's 0.098), and its window best lies within
# 0.24 of the reference's.
STRUCT_STEP0_ABS, STRUCT_STEP_ABS, STRUCT_TIGHT_ABOVE = 1e-3, 0.2, -25.0
STRUCT_FINAL_ABS = 1.0
STRUCT_DEPLOY_SIDE = 64
MULTI_RHS_TPU = REPO / "assets" / "results" / "multi_rhs.csv"
SEQ_HEADER = ("shape,technique,n,sigma,k_solves,iterations_mean,setup_s,"
              "solves_s,total_s,converged")
K_SOLVES = (2, 4, 8)
LARGE_GRID = 256
HOST_IC0_RTOL = 1e-12  # the host runtime's IC(0) against the numpy one
HOST_FVM_RTOL = 1e-14  # its FVM assembly against the numpy one
# The IC(0) layers of the conv plans: PreconditionerNet's stride-1 ones
HOST_CONV_SPECS = (ConvSpec((1, 1), (0, 0)), ConvSpec((2, 2), (1, 0)),
                   ConvSpec((2, 2), (0, 1)))
ILU_FIXTURE = (REPO / "tests" / "fixtures" / "torch_port"
               / "ilu_iterations.json")
# assets/results/table.csv (the reference's test stage on a TPU):
# incomplete_lu's mean iterations and kappa, context only
TPU_ILU_RECORD = {"iterations": 30.9, "kappa": 185.37}
ILU_KAPPA_RTOL = 1e-6  # kappa comes from the float64 host factor
AMG_FIXTURE = (REPO / "tests" / "fixtures" / "torch_port"
               / "scaling_amg_iterations.json")
FRAMES_IC_FIXTURE = (REPO / "tests" / "fixtures" / "torch_port"
                     / "frames_ic_iterations.json")
FRAMES_BATCHED_FIXTURE = (REPO / "tests" / "fixtures" / "torch_port"
                          / "frames_batched_iterations.json")
IRREGULAR_BATCHED_FIXTURE = (REPO / "tests" / "fixtures" / "torch_port"
                             / "irregular_batched_iterations.json")
MESHES_FIXTURE = (REPO / "tests" / "fixtures" / "torch_port"
                  / "compare_meshes.json")
# The frames and irregular batched runs time 3 builds and 3 fixed-trip
# solves, not their entry points' 20 and 10.
SHALLOW_BATCHED_REPS = 3
# Frames batched vanilla, per case: max(2, 10%) of the JAX CPU f32 count
# (set after the first card run read 13 on one case, 8%).  Unpreconditioned
# float32 CG on these systems takes a count set by rounding: the JAX run's
# own float64 counts lie 11% below its float32 ones on average
# (``vanilla_f64`` in the fixture); the port's own CPU f32 run (the card's
# code, scripts/torch_port_frames_vanilla_spread.py) is up to 9 (5.6%,
# case 11) off JAX's and reads case 29 at 178 against JAX's 172 and the
# card's 185; the two float64 runs differ by 6 on it; and the TPU's batched
# mean reads 269.425 against the CPU's 219.05 (ROADMAP C).  The mean stays
# within 5%.
FRAMES_BATCHED_VANILLA_CASE = 0.10
KAPPA_PRE_RTOL = 1e-6  # kappa(A): float64 on the host on both sides
KAPPA_POST_RTOL = 1e-4  # kappa(M A): M from the card's float32 setup
# assets/results/frames/batched.csv (the reference's frames script on a
# TPU): mean iterations and success, context only (ROADMAP C)
TPU_FRAMES_BATCHED_RECORD = {"iterations": 269.425, "success": 97.5}
# The host runtime's calls per path (phase (d)): each path's counts are
# read right after it ran; a path that factors or levelizes needs its
# entry points called natively, and no path may take a numpy fallback.
HOST_PATHS: dict = {}
# B1 float64 (phase 3d), residual parity (4m), the sharded solver (4n),
# the generate stage (4o).
GJ64_SHAPES = ((1024, 24), (131072, 24), (131072, 41))  # (N, w)
GJ64_MAIN_SHAPE = (1024, 24)  # a per-case float64 setup's
GJ64_RTOL, GJ64_ATOL = 1e-10, 1e-12
RESIDUAL_FIXTURE = (REPO / "tests" / "fixtures" / "torch_port"
                    / "residual_parity.json")
RESIDUAL_CASES = 5
CURVE_RTOL = 1e-6  # float64 residual curves against the JAX CPU float64
RESIDUAL_DRIFT = ("vanilla", "jacobi")  # float32: max(2, 5%)
PARALLEL_FIXTURE = (REPO / "tests" / "fixtures" / "torch_port"
                    / "parallel_iterations.json")
SHARDED_GRID = 64
SHARDED_MODES = ("allgather", "halo")
SHARDED_PRECONDS = ("none", "jacobi", "block_jacobi_ic", "fsai")
SHARDED_REPS = 3
GENERATE_CASES = 50
GENERATE_RTOL = 1e-13  # the native assembly's A against the numpy one


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def hold_host(label, needed=()):
    """Phase (d) on the path just run: the host runtime's entry points in
    ``needed`` called natively at least once, no numpy fallback taken;
    adds the counts to ``HOST_PATHS[label]``."""
    calls = _backend.host_call_counts()
    fallbacks = _backend.host_fallback_counts()
    total = HOST_PATHS.setdefault(label, dict.fromkeys(calls, 0))
    for entry, count in calls.items():
        total[entry] += count
    if any(fallbacks.values()):
        raise AssertionError(f"{label}: numpy fallbacks on the card "
                             f"{fallbacks}")
    missing = [entry for entry in needed if calls[entry] == 0]
    if missing:
        raise AssertionError(f"{label}: the host runtime's {missing} never "
                             f"called ({calls})")


@contextlib.contextmanager
def numpy_host_route():
    """The port's host steps on their numpy versions (the oracle)."""
    saved = native.available
    native.available = lambda: False
    try:
        yield
    finally:
        native.available = saved


def host_seconds(fn, reps=5):
    """Median host seconds of ``fn()`` over ``reps`` calls."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def check_host_runtime(card):
    """Phase 2b: the host runtime builds with g++ and loads; on the first
    flagship case each entry point against the port's numpy version (ic0
    to HOST_IC0_RTOL, levels and conv_plan equal, ict a valid factor), and
    each timed natively and in numpy (host clock, median of 5)."""
    t0 = time.perf_counter()
    lib = native.require()
    print(f"host runtime: {Path(lib._name).name} (g++ "
          f"{' '.join(_backend.HOST_FLAGS)}): build "
          f"{_backend.host_build_seconds:.2f} s (0 if cached), build and "
          f"load {time.perf_counter() - t0:.2f} s")
    a = generate_sludge_case(np.random.default_rng(SEED),
                             mesh_cells=2).matrix.tocsr()
    n = a.shape[0]
    tril = sp.tril(a, format="csr")
    ours = tril.data.astype(np.float64).copy()
    want = ours.copy()
    failures = []
    if native.ic0(tril.indptr, tril.indices, ours) != 0 or not _ic0_inplace(
            n, tril.indptr, tril.indices, want):
        failures.append("ic0: a pivot broke down")
    ic0_rel = float(np.max(np.abs(ours - want) / np.abs(want)))
    lf = ic0_factor(a)
    levels = native.levels(lf.indptr, lf.indices)
    coo = tril.tocoo()  # sorted sites, as the native plan needs
    with numpy_host_route():
        levels_np = compute_levels(lf)
        conv_np = [build_conv_maps(coo.row, coo.col, (n, n), spec)
                   for spec in HOST_CONV_SPECS]
    conv_equal = all(
        all(np.array_equal(x, y) for x, y in zip(
            native.conv_plan(coo.row, coo.col, n, n, *spec.kernel,
                             *spec.padding), ref[:3]))
        for spec, ref in zip(HOST_CONV_SPECS, conv_np))
    full = a.copy()
    full.sort_indices()
    l_ind, l_idx, l_val = native.ict(full.indptr, full.indices, full.data,
                                     1, 0.1)
    l_ict = sp.csr_matrix((l_val, l_idx, l_ind), shape=a.shape)
    ict_valid = (sp.triu(l_ict, 1).nnz == 0 and np.isfinite(l_val).all()
                 and (l_ict.diagonal() > 0).all())
    ict_res = float(sp.linalg.norm(l_ict @ l_ict.T - a) / sp.linalg.norm(a))
    ict_is_ic0 = (np.array_equal(l_ict.indices, lf.indices)
                  and np.array_equal(l_ict.indptr, lf.indptr)
                  and np.allclose(l_ict.data, lf.data, rtol=1e-12, atol=0))
    rho = 1.0 + 999.0 * np.random.default_rng(SEED).random((24, 32))
    rows_f, cols_f, vals_f, _ = native.fvm_assemble(*rho.shape, rho, 1.0, 1.0,
                                                    DT, True)
    fvm = sp.csr_matrix((vals_f, (rows_f, cols_f)), shape=(rho.size,) * 2)
    fvm_np = assemble_pressure_poisson(*rho.shape, rho).tocsr()
    fvm_rel = float(abs(fvm - fvm_np).max() / abs(fvm_np).max())
    print(f"host runtime on case 0 (n {n}): ic0 max rel diff {ic0_rel:.3e} "
          f"(limit {HOST_IC0_RTOL}); levels equal "
          f"{np.array_equal(levels, levels_np)} ({int(levels.max()) + 1} "
          f"levels); conv_plan equal {conv_equal} ({len(HOST_CONV_SPECS)} "
          f"layers); ict(1, 0.1) valid {ict_valid}, ||L L^T - A|| / ||A|| "
          f"{ict_res:.3e}, equal to IC(0)'s factor {ict_is_ic0}; "
          f"fvm_assemble (24 x 32) max diff / max|A| {fvm_rel:.3e} (limit "
          f"{HOST_FVM_RTOL})")
    if ic0_rel > HOST_IC0_RTOL:
        failures.append(f"ic0: {ic0_rel} off the numpy factor")
    if not np.array_equal(levels, levels_np):
        failures.append("levels differ from numpy")
    if not conv_equal:
        failures.append("conv_plan differs from numpy")
    if not ict_valid:
        failures.append("ict is not a valid factor")
    if fvm_rel > HOST_FVM_RTOL:
        failures.append(f"fvm_assemble: {fvm_rel} off the numpy assembly")
    data = tril.data.astype(np.float64)
    rows = {
        "ic0": (lambda: native.ic0(tril.indptr, tril.indices, data.copy()),
                lambda: _ic0_inplace(n, tril.indptr, tril.indices,
                                     data.copy())),
        "levels": (lambda: native.levels(lf.indptr, lf.indices),
                   lambda: compute_levels(lf)),
        "conv_plan": (lambda: native.conv_plan(
            coo.row, coo.col, n, n, 2, 2, 1, 0), lambda: build_conv_maps(
            coo.row, coo.col, (n, n), HOST_CONV_SPECS[1])),
    }
    parts = []
    for entry, (fast, slow) in rows.items():
        t_native = host_seconds(fast)
        with numpy_host_route():
            t_numpy = host_seconds(slow)
        parts.append(f"{entry} {t_native * 1e3:.4f} ms (numpy "
                     f"{t_numpy * 1e3:.4f})")
    print("host runtime per call on case 0, host clock, median of 5: "
          + "; ".join(parts) + f" [{card}]")
    if failures:
        raise AssertionError("; ".join(failures))


def spd_systems(rng, n, w, dtype=np.float32):
    """Well-conditioned SPD blocks with a unit diagonal (like Jacobi-scaled
    FSAI local blocks) and one-hot right-hand sides, float32 (or
    ``dtype``)."""
    g = rng.standard_normal((n, w, w), dtype=dtype)
    a = g @ g.transpose(0, 2, 1) / w + np.eye(w, dtype=dtype)
    d = 1.0 / np.sqrt(np.einsum("nii->ni", a))
    a = a * d[:, :, None] * d[:, None, :]
    e = np.zeros((n, w), dtype)
    e[np.arange(n), rng.integers(0, w, n)] = 1.0
    return a, e


def measure(label, kernel, plain, library, work, dev, card, *,
            tensor_cores=False, fp64=False):
    """Time one (kernel, shape) three ways in turns, inside this call:
    per call (CUDA events around one call, median of 20: what a path
    pays), kernel only (``time_graph``: launches back to back in a CUDA
    graph), the one PyTorch library call for the same function (per call)
    and the plain version (per call); print
    them beside the bound of ``work`` (its flops against the float64
    rate with ``fp64``).  Fails if the kernel-only time
    exceeds the per-call time by more than KERNEL_ONLY_SLACK (the span
    would have measured something else).  Returns the record, in ms."""
    peaks = card_peaks(torch.cuda.get_device_name(dev))
    per_call = time_call(kernel, dev, reps=20)
    only = time_graph(kernel, dev)
    lib = time_call(library, dev, reps=20)
    plain_s = time_call(plain, dev, reps=20)
    # A tensor-core kernel is held to the 3xTF32 roof, the float32 roof
    # beside it.
    if fp64:
        flop_s = fp64_tflop_s(torch.cuda.get_device_name(dev))
    elif tensor_cores:
        flop_s = peaks.tf32x3_tflop_s
    else:
        flop_s = peaks.fp32_tflop_s
    bound, roof = work.bound(peaks.hbm_gb_s, flop_s)
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


def print_against_library(label, rec):
    """One line: the per-call time beside the library call's, and their
    ratio (below 1: the kernel's call is the cheaper)."""
    print(f"{label}: per call {rec['ms']:.4f} ms against the library's "
          f"{rec['library_ms']:.4f} ms, ratio "
          f"{rec['ms'] / rec['library_ms']:.3f}")


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


def check_gauss_jordan_on(sub, rhs, label, rtol=GJ_RTOL, atol=GJ_ATOL):
    """B1 against its plain version on (sub, rhs); returns the max abs
    error, raises beyond ``rtol`` / ``atol`` (float32's GJ_RTOL /
    GJ_ATOL by default)."""
    got = masked_gauss_jordan(sub, rhs)
    torch.cuda.synchronize()
    ref = masked_gauss_jordan_torch(sub, rhs)
    diff = (got - ref).abs()
    err = float(diff.max())
    if not bool(torch.isfinite(got).all()) or bool(
            (diff > atol + rtol * ref.abs()).any()):
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
    max_err, times, equal = 0.0, {}, 0
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
            equal += int(torch.equal(got, ref))
            csr = dia_csr(a)
            times[name] = measure(
                f"B2 {name:<20} n_pad {a.n_pad:>8d} bands "
                f"{len(a.offsets):2d} (max abs err {err:.3e}, rtol {B2_RTOL},"
                f" atol {B2_ATOL}; bit-equal {torch.equal(got, ref)}; "
                f"library CSR nnz {csr.values().numel()})",
                lambda: dia_matvec(a, x), lambda: a.matvec(x),
                lambda: csr @ x, dia_work(len(a.offsets), a.n_pad), dev,
                card)
            print_against_library(f"B2 {name}", times[name])
            del x, got, ref, diff, csr
        print(f"B2 equal bit for bit to its plain version on {equal} of "
              f"{len(operators + coarse)} operators")
        for row in spmv_section(dev, operators):
            print(f"SpMV {row['name']:<20} " + "; ".join(
                f"{p} {row[p]['time_us']:.2f} us {row[p]['gnnz_per_s']:.2f}"
                f" Gnnz/s {row[p]['achieved_gb_s']:.1f} GB/s HBM share "
                f"{row[p]['bandwidth_fraction']:.3f}"
                for p in ("cold", "resident")) + f" [{card}]")
    return max_err, times


def dia_csr(a):
    """The DIA operator as one ``torch.sparse_csr_tensor`` (its nonzeros,
    int32 indices, columns sorted in each row; a batch of S operators as
    one block-diagonal matrix of S * n_pad rows): the library yardstick
    of B2, never called by the port."""
    order = sorted(range(len(a.offsets)), key=lambda d: a.offsets[d])
    vals = a.vals if a.vals.dim() == 3 else a.vals[None]
    batch, n = vals.shape[0], a.n_pad
    dev = a.vals.device
    rows = torch.arange(n, device=dev)
    cols = torch.stack([rows + a.offsets[d] for d in order], dim=1)
    vals = vals[:, order].transpose(1, 2)  # (S, n, bands)
    keep = ((cols >= 0) & (cols < n))[None] & (vals != 0)
    cols = cols[None] + n * torch.arange(batch, device=dev)[:, None, None]
    crow = torch.zeros(batch * n + 1, dtype=torch.int32, device=dev)
    crow[1:] = torch.cumsum(keep.reshape(batch * n, -1).sum(1), 0)
    return torch.sparse_csr_tensor(crow, cols[keep].int(), vals[keep],
                                   (batch * n, batch * n))


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
    amg_fixture = json.loads(AMG_FIXTURE.read_text())
    if (tuple(amg_fixture["shapes"]), amg_fixture["sigma"],
            amg_fixture["coeff_seed"], amg_fixture["rhs_seed"],
            amg_fixture["rtol"]) != meta[:5]:
        raise AssertionError("the amg fixture describes another run")
    csv_path = RESULTS / "scaling_learned.csv"
    seq_path = RESULTS / "multi_rhs.csv"
    t0 = time.perf_counter()
    run = scaling.run_scaling(dev, out=csv_path, k_solves=K_SOLVES,
                              seq_out=seq_path, with_amg=True)
    wall_s = time.perf_counter() - t0
    header = csv_path.read_text().splitlines()[0]
    if header != SCALING_HEADER:
        raise AssertionError(f"scaling CSV schema changed: {header}")
    if seq_path.read_text().splitlines()[0] != SEQ_HEADER:
        raise AssertionError("multi_rhs.csv schema changed")
    print(f"scaling path: shapes {scaling.SHAPES}, k_solves {K_SOLVES}, "
          f"{wall_s:.1f} s wall (operators, setups, solves, sequences, "
          f"timing reps)")
    failures = []
    totals = dict.fromkeys(_backend.KERNELS, 0)
    print(f"per shape and technique on {card} (ms: setup median of "
          f"{scaling.TIMING_REPS}, solve median of {scaling.TIMING_REPS} "
          f"fixed-trip solves):")
    for row in run.rows:
        side = int(row["shape"].split("^")[0])
        name = row["technique"]
        key = (side, name)
        ref = (amg_fixture["results"][str(side)]["iterations"]
               if name == "amg"
               else fixture["results"][str(side)]["iterations"][name])
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
        if any(run.host_fallbacks[key].values()):
            failures.append(f"{key}: numpy fallbacks on the card "
                            f"{run.host_fallbacks[key]}")
        if name == "learned" and row["safeguard_fallback"]:
            failures.append(f"{key}: the safeguard fell back to q = I")
    print("TPU record for context only (BENCH_r05, TPU v5e, iterations): "
          + "; ".join(f"{s}^3 {v}" for s, v in TPU_SCALING_RECORD.items())
          + f"; amg 64^3 {TPU_AMG_RECORD} (the TPU faulted at 128^3)")
    for side, parts in run.amg_builds.items():
        host = {k: round(v * 1e3, 3) for k, v in parts.items()
                if k != "level_rows"}
        row = next(r for r in run.rows
                   if r["technique"] == "amg" and r["shape"] == f"{side}^3")
        tpu = (f"TPU record {TPU_AMG_RECORD}" if side == 64
               else "no TPU record: it faulted there")
        print(f"  {side}^3 amg: {row['iterations']} iterations ({tpu}); "
              f"level rows {parts['level_rows']} (JAX "
              f"{amg_fixture['results'][str(side)]['level_rows']}); host "
              f"setup parts (ms) {host}, aggregation "
              f"{parts['aggregate'] / row['setup_s']:.3f} of the setup "
              f"{row['setup_s'] * 1e3:.3f} ms [{card}]")
        if parts["level_rows"][:-1] != amg_fixture["results"][str(side)][
                "level_rows"]:
            failures.append(f"{side}^3 amg: hierarchy differs from JAX")
    if "amg" in {r["technique"] for r in run.seq_rows}:
        failures.append("amg ran the sequences")
    check_sequences(run, fixture, card, failures)
    if failures:
        raise AssertionError("; ".join(failures))
    return totals


def check_sequences(run, fixture, card, failures):
    """Phase 4b's multi-RHS rows: every sequence converged, each mean
    within max(1 iteration, 1%) at 64^3 and max(1, 2%) at 128^3 (vanilla
    5% at both) of the span between the reference's two float32 runs,
    the JAX CPU fixture and the committed TPU ``multi_rhs.csv``: their
    float32 rounding alone sets them apart (128^3 vanilla k 4: 688.25 on
    the CPU, 649.25 on the TPU; learned 42.25 and 44.0; ROADMAP C)."""
    tpu = {}
    for line in MULTI_RHS_TPU.read_text().splitlines()[1:]:
        shape, name, _, _, k, mean, *_ = line.split(",")
        tpu[(shape, name, int(k))] = float(mean)
    print(f"multi-RHS sequences on {card} (ms; setup once, solves as one "
          f"span, median of {max(scaling.TIMING_REPS // 2, 1)}):")
    for row in run.seq_rows:
        name, k, shape = row["technique"], row["k_solves"], row["shape"]
        side = shape.split("^")[0]
        ref = fixture["sequences"][side][name][str(k)]["iterations_mean"]
        lo, hi = sorted((ref, tpu[(shape, name, k)]))
        rel = 0.01 if side == "64" else 0.02
        if name == "vanilla":
            lo, hi = 0.95 * lo, 1.05 * hi
        else:
            lo, hi = lo - max(1.0, rel * lo), hi + max(1.0, rel * hi)
        mean = row["iterations_mean"]
        print(f"  {shape:<6} {name:<12} k {k} iterations mean {mean:8.3f} "
              f"(JAX CPU f32 {ref:8.3f}, TPU csv {tpu[(shape, name, k)]:8.3f})"
              f" setup {row['setup_s'] * 1e3:.3f} solves "
              f"{row['solves_s'] * 1e3:.3f} total {row['total_s'] * 1e3:.3f}"
              f" converged {row['converged']}")
        if not lo <= mean <= hi:
            failures.append(f"{shape} {name} k {k}: mean {mean} outside "
                            f"[{lo}, {hi}]")
        if not row["converged"]:
            failures.append(f"{shape} {name} k {k}: not converged")
    for side in scaling.SHAPES:
        print(f"  {side}^3 crossover_k (learned's total at most every other "
              f"technique's): {run.details.get(f'{side}_crossover_k')}")


def check_scaling_protocols(dev, card):
    """Phase 4b's known-solution (``rhs ax``) and constant-coefficient
    (``sigma 0``) rows at 64^3 against the JAX CPU f32 fixture: iterations
    as the default rows (others max(2, 2%)), converged, the safeguard as
    the fixture's; under ``ax`` each ``x_rel_err`` below 1e-2 and, where
    the counts are equal, within a factor 4 of the fixture's.  Vanilla's
    float32 count is set by rounding (at ``ax`` the JAX CPU run takes 96,
    its float64 run 87), so it is held within 5% of the span between the
    fixture's float32 and float64 counts.  Returns the launches."""
    fixture = json.loads(SCALING_FIXTURE.read_text())
    side = str(STRUCT_DEPLOY_SIDE)
    launches = dict.fromkeys(_backend.KERNELS, 0)
    failures = []
    for part, kwargs in (("ax", {"rhs": "ax"}), ("sigma0", {"sigma": 0.0})):
        ref = fixture[part][side]
        t0 = time.perf_counter()
        run = scaling.run_scaling(dev, shapes=(STRUCT_DEPLOY_SIDE,),
                                  out=RESULTS / f"scaling_{part}.csv",
                                  **kwargs)
        print(f"scaling {part} at {side}^3: {time.perf_counter() - t0:.1f} s "
              f"wall [{card}]")
        for row in run.rows:
            name = row["technique"]
            key = (STRUCT_DEPLOY_SIDE, name)
            for kernel, count in run.launches[key].items():
                launches[kernel] += count
            want = ref["iterations"][name]
            err, ref_err = row["x_rel_err"], ref.get("x_rel_err", {}).get(name)
            print(f"  {name:<12} iters {row['iterations']:4d} (JAX CPU f32 "
                  f"{want:4d}" + (f", f64 {ref['vanilla_f64']}"
                                  if name == "vanilla" else "")
                  + f") x_rel_err {err} (JAX {ref_err}) total "
                  f"{row['total_s'] * 1e3:.3f} ms converged {row['converged']}"
                  f" launches {run.launches[key]}")
            if name == "vanilla":
                lo, hi = sorted((want, ref["vanilla_f64"]))
                lo, hi = 0.95 * lo, 1.05 * hi
            else:
                slack = max(2, 0.02 * want)
                lo, hi = want - slack, want + slack
            if not lo <= row["iterations"] <= hi or not row["converged"]:
                failures.append(f"{part} {name}: {row['iterations']} outside "
                                f"[{lo}, {hi}]")
            if any(run.plain_on_cuda[key].values()):
                failures.append(f"{part} {name}: a plain version ran")
            if ref_err is not None and not (err < 1e-2 and (
                    row["iterations"] != want or ref_err / 4 <= err
                    <= 4 * ref_err)):
                failures.append(f"{part} {name}: x_rel_err {err} vs {ref_err}")
            if name == "learned" and (row["safeguard_fallback"]
                                      != ref["safeguard_fallback"]):
                failures.append(f"{part}: safeguard {row['safeguard_fallback']}")
    if failures:
        raise AssertionError("; ".join(failures))
    return launches


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


@contextlib.contextmanager
def peak_memory(dev, out):
    """The peak of the card's allocated memory inside the block, in GiB,
    set as ``out["peak_gib"]``: the earlier phases' garbage collected and
    the peak counter reset first."""
    torch.cuda.init()  # the allocator's stats exist once CUDA is set up
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        yield
    finally:
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30


def check_frames_path(dev, card):
    """Phase 4c: the frames family per case (five techniques) and batched
    against the JAX reference counts; returns the suite and its kernel
    launches."""
    fixture = json.loads(FRAMES_FIXTURE.read_text())
    ic_ref = json.loads(FRAMES_IC_FIXTURE.read_text())
    bat_ref = json.loads(FRAMES_BATCHED_FIXTURE.read_text())
    t0 = time.perf_counter()
    _backend.reset_launch_counts()
    mem = {}
    with peak_memory(dev, mem):
        suite = frames.run(dev, results_directory=RESULTS / "frames",
                           timing_reps=SHALLOW_TIMING_REPS,
                           reps=SHALLOW_BATCHED_REPS,
                           setup_reps=SHALLOW_BATCHED_REPS)
    launches = _backend.launch_counts()
    hold_host("frames", ("ic0", "levels"))
    plain = _backend.plain_cuda_counts()
    wall_s = time.perf_counter() - t0
    for ref in (fixture, ic_ref, bat_ref):
        if (ref["seed"], ref["cases"], ref["n_pad"]) != (
                frames.SEED, len(suite.data_set), suite.data_set.dof_pad):
            raise AssertionError("a frames fixture describes another split")
    suite.dump_csv()
    suite.dump_csv_batched()
    failures = []
    header = (RESULTS / "frames" / "table.csv").read_text().splitlines()[0]
    if header != "technique," + ",".join(TABLE_PARAMETERS):
        failures.append(f"frames table schema changed: {header}")
    header = (RESULTS / "frames" / "batched.csv").read_text().splitlines()[0]
    if header != "technique," + ",".join(BATCHED_KEYS):
        failures.append(f"frames batched.csv schema changed: {header}")
    per_case = suite.setup_calls["fsai"] + suite.setup_calls["learned"]
    batched = sum(suite.batched_launch_groups.get(t, 0)
                  for t in ("fsai", "learned"))
    print(f"frames path: {len(suite.data_set)} cases, n_pad "
          f"{suite.data_set.dof_pad}, {wall_s:.1f} s wall (generation, "
          f"plans, per case and batched); B1 launches "
          f"{launches['gauss_jordan']} (fsai + learned setups {per_case}, "
          f"batched builds x plan groups {batched}; builds "
          f"{suite.batched_builds}); plain versions on the card: {plain}; "
          f"peak memory {mem['peak_gib']:.3f} GiB")
    if launches["gauss_jordan"] != per_case + batched or not batched:
        failures.append("B1 not launched once per fsai/learned setup and "
                        "per plan group of each batched build")
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
        success = [s == 100.0 for s in suite.successes[name]]
        if name == "incomplete_cholesky":
            # each case within 2 of the span of the JAX float32 and
            # float64 counts: the float32 run stops one case (19) at
            # 9.997e-9 of the 1e-8 tolerance, three iterations before the
            # float64 one (ROADMAP C)
            ref = np.asarray(ic_ref["iterations"])
            ref64 = np.asarray(ic_ref["iterations_f64"])
            mean, ref_mean, _ = hold_counts(
                f"frames {name}", suite.iterations[name], ref, success,
                ic_ref["success"], np.inf, 0.01, failures)
            iters = np.asarray(suite.iterations[name])
            worst = int(np.maximum(np.minimum(ref, ref64) - iters,
                                   iters - np.maximum(ref, ref64)).max())
            if worst > 2:
                failures.append(f"frames {name}: a case is {worst} "
                                "iterations outside the JAX f32-f64 span")
        else:
            ref = np.asarray(fixture["iterations"][name])
            mean, ref_mean, worst = hold_counts(
                f"frames {name}", suite.iterations[name], ref, success,
                fixture["success"][name],
                np.maximum(2, 0.05 * ref) if name in FRAMES_DRIFT else 2,
                0.05 if name == "vanilla" else 0.01, failures)
        print(f"  {name:<20} iters {mean:7.3f} (JAX CPU f32 {ref_mean:7.3f}, "
              f"max |delta| per case {worst}) setup "
              f"{np.median(suite.setups[name]) * 1e3:.3f} solve "
              f"{np.median(suite.durations[name]) * 1e3:.3f} total "
              f"{np.median(suite.totals[name]) * 1e3:.3f} success "
              f"{np.mean(success) * 100:.0f}%")
    kappa = suite.kappas["incomplete_cholesky"][0]
    print(f"  incomplete_cholesky kappa case 0 {kappa:.6f} (JAX CPU f32, "
          f"numpy IC(0): {ic_ref['kappa_case0']:.6f})")
    if abs(kappa - ic_ref["kappa_case0"]) > KAPPA_PRE_RTOL * abs(
            ic_ref["kappa_case0"]):
        failures.append(f"frames IC kappa {kappa} vs {ic_ref['kappa_case0']}")
    failures += hold_batched(f"frames batched on {card}", suite, bat_ref,
                             {"vanilla": 0.05},
                             {"vanilla": FRAMES_BATCHED_VANILLA_CASE})
    # the same row in float64 on the card: how far the order of the sums
    # alone moves these counts (printed only)
    suite64 = frames.frames_suite(
        dev, dtype=torch.float64, cases=frames.generate_frame_cases(
            solve=False))
    suite64.run_batched(techniques=("vanilla",), reps=1, setup_reps=1)
    vanilla64 = suite64.batched["vanilla"]["iterations_per_case"]
    vanilla = np.asarray(suite.batched["vanilla"]["iterations_per_case"])
    print(f"  frames batched vanilla per case, largest gaps (case: card f32 "
          f"/ card f64 / JAX CPU f32 / f64): " + ", ".join(
              f"{i}: {vanilla[i]} / {vanilla64[i]} / "
              f"{bat_ref['iterations']['vanilla'][i]} / "
              f"{bat_ref['vanilla_f64'][i]}" for i in np.argsort(
                  -np.abs(vanilla - bat_ref["iterations"]["vanilla"]))[:3])
          + f"; card f64 mean {np.mean(vanilla64)} (JAX CPU f64 "
          f"{np.mean(bat_ref['vanilla_f64'])}); per case, card f32 "
          f"{vanilla.tolist()}, card f64 {list(vanilla64)}")
    del suite64
    a0 = suite._reconstruct(0)[0]
    ic0_native = ic0_factor(a0)
    with numpy_host_route():
        ic0_numpy = ic0_factor(a0)
    ic0_rel = float(np.max(np.abs(ic0_native.data - ic0_numpy.data)
                           / np.abs(ic0_numpy.data)))
    print(f"host runtime ic0 on frames case 0 (n {a0.shape[0]}): max rel "
          f"diff to numpy {ic0_rel:.3e} (limit {HOST_IC0_RTOL})")
    if ic0_rel > HOST_IC0_RTOL:
        failures.append(f"frames ic0: {ic0_rel} off the numpy factor")
    print("TPU record for context only (assets/results/frames/batched.csv, "
          f"every technique): {TPU_FRAMES_BATCHED_RECORD}")
    print("frames_bench line: " + json.dumps(frames.summary_line(suite)))
    if failures:
        raise AssertionError("; ".join(failures))
    return suite, launches, mem["peak_gib"]


def hold_batched(label, suite, ref, mean_tol, case_rel=None):
    """A ``run_batched`` against a JAX reference record: the techniques,
    the learned route and band spread, per-case counts within 2 (vanilla
    and jacobi max(2, ``case_rel[name]`` (else 5%) of the count)), each
    mean within ``mean_tol[name]`` (else 1%), success equal; prints each
    technique with its trips and settled M dtype beside the reference's.
    Returns the failures."""
    case_rel = case_rel or {}
    failures = []
    batched = suite.batched
    if list(batched) != ref["techniques"]:
        failures.append(f"{label}: techniques {list(batched)}, reference "
                        f"{ref['techniques']}")
    route, spread = suite.batched_routes.get("learned", (None, None))
    if (route, spread) != (ref["learned_apply"], ref["learned_d_max"]):
        failures.append(f"{label}: learned route {route} at spread "
                        f"{spread}, reference {ref['learned_apply']} at "
                        f"{ref['learned_d_max']}")
    print(f"{label} (ms: setup median of {SHALLOW_BATCHED_REPS} builds, one "
          f"for the host-bound setups; solve median of "
          f"{SHALLOW_BATCHED_REPS} fixed-trip runs; learned {route}, band "
          f"spread {spread}):")
    for name, s in batched.items():
        r = np.asarray(ref["iterations"][name])
        mean, ref_mean, worst = hold_counts(
            f"{label} {name}", s["iterations_per_case"], r, s["success"],
            ref["success"][name],
            np.maximum(2, case_rel.get(name, 0.05) * r)
            if name in FRAMES_DRIFT else 2,
            mean_tol.get(name, 0.01), failures)
        print(f"  {name:<28} iters {mean:7.3f} (JAX CPU f32 {ref_mean:7.3f},"
              f" max |delta| per case {worst}) trips {s['trips']} (JAX "
              f"{ref['trips'][name]}) M {s['m_dtype']} (JAX "
              f"{ref['m_dtype'][name]}) setup {s['setup_batch'] * 1e3:.3f} "
              f"solve {s['solve_batch'] * 1e3:.3f} total "
              f"{s['total_batch'] * 1e3:.3f} success {s['success']:.1f}% "
              f"(JAX {ref['success'][name]:.1f}%)")
        if s["m_dtype"] != ref["m_dtype"][name]:
            print(f"  {name}: settled on {s['m_dtype']} M where the JAX "
                  f"reference settled on {ref['m_dtype'][name]}")
    print(f"{label} ratios: {batched_ratios(batched)}")
    return failures


def check_irregular_batched(dev, card, cases):
    """Phase 4e's batched part: ``batched_probe.run(irregular=True)`` on
    the irregular split (the learned M dense), against the JAX reference's
    ``run_batched``; returns the suite, its launches and peak GiB."""
    ref = json.loads(IRREGULAR_BATCHED_FIXTURE.read_text())
    t0 = time.perf_counter()
    _backend.reset_launch_counts()
    mem = {}
    with peak_memory(dev, mem):
        suite = batched_probe.run(
            dev, irregular=True, reps=SHALLOW_BATCHED_REPS,
            setup_reps=SHALLOW_BATCHED_REPS, cases=cases,
            results_directory=RESULTS / "probe")
    launches = _backend.launch_counts()
    hold_host("irregular-batched", ("ic0",))
    plain = _backend.plain_cuda_counts()
    wall_s = time.perf_counter() - t0
    if (ref["seed"], ref["cases"], ref["n_pad"], ref["chunk"]) != (
            irregular.SEED, len(suite.data_set), suite.data_set.dof_pad,
            batched_probe.CHUNK):
        raise AssertionError("the irregular batched fixture describes "
                             "another split")
    expected = sum(suite.batched_launch_groups.get(t, 0)
                   for t in ("fsai", "learned"))
    print(f"irregular batched path (batched_probe --irregular): "
          f"{len(suite.data_set)} cases, n_pad {suite.data_set.dof_pad}, "
          f"chunk {batched_probe.CHUNK}, {wall_s:.1f} s wall; B1 launches "
          f"{launches['gauss_jordan']} (builds x plan groups {expected}; "
          f"builds {suite.batched_builds}); plain versions on the card: "
          f"{plain}; peak memory {mem['peak_gib']:.3f} GiB")
    failures = hold_batched(f"irregular batched on {card}", suite, ref,
                            IRREGULAR_MEAN_TOL)
    if launches["gauss_jordan"] == 0 or launches["gauss_jordan"] != expected:
        failures.append("B1 not launched once per plan group and build")
    if any(plain.values()):
        failures.append(f"a plain version ran on the card: {plain}")
    if failures:
        raise AssertionError("; ".join(failures))
    return suite, launches, mem["peak_gib"]


def check_gauss_jordan_group(suite, card, kind, label, width):
    """B1 against its plain version on the real local systems of a
    batched learned build: its largest ``kind`` plan group ("range" or
    "generic"), every case's columns in one launch (N = cases x n_pad),
    timed as in phase 3.  Returns the max abs error and the record."""
    groups = suite._batched_fsai_inputs(
        suite.learned_power or suite.fsai_power, suite.model.width)
    idx, plans, operands, _ = max((g for g in groups if g[3] == kind),
                                  key=lambda g: g[0].shape[0])
    with torch.no_grad():
        blocks = (range_local_blocks(
            plans, suite._batched_common()["a_tilde"][idx])
            if kind == "range" else lookup_local_blocks(plans, operands))
        sub, e = local_systems(plans, blocks)
        w = sub.shape[-1]
        sub, e = sub.reshape(-1, w, w), e.reshape(-1, w)
        n = sub.shape[0]
        if w != width:
            raise AssertionError(f"{label}: local systems of width {w}, "
                                 f"not {width}")
        err = check_gauss_jordan_on(sub, e, f"{label}'s {kind} group")
        rec = measure(
            f"B1 on {label}'s {kind} group ({idx.shape[0]} cases, N {n}, w "
            f"{w}; max abs err {err:.3e}, rtol {GJ_RTOL}, atol {GJ_ATOL})",
            lambda: masked_gauss_jordan(sub, e),
            lambda: masked_gauss_jordan_torch(sub, e),
            lambda: torch.linalg.solve_ex(sub, e[..., None]),
            gauss_jordan_work(n, w), sub.device, card)
    return err, rec


def check_gauss_jordan_mesh(dev, card):
    """B1 against its plain version on the real local systems of the mesh
    study's largest case (the one-off setup's generic plan at the model's
    width; the pattern is capped to it only where wider, and its uncapped
    width is printed), timed as in phase 3."""
    params = params_show(REPO / "params.yaml")
    if params.model != "NeuralFSAI":
        raise AssertionError(f"the study runs {params.model}, not the "
                             "NeuralFSAI flagship")
    payload = load_checkpoint(REPO / params.checkpoint_dir / "best.msgpack")
    width = int(payload["width"])
    power = int(payload.get("power", 4)) or 4
    cells, case = max(compare_meshes.study_cases(1),
                      key=lambda c: c[1].matrix.shape[0])
    rows, cols, _, _ = scaled_tril(case.matrix)
    uncapped = pattern_col_width(*tril_power_pattern(
        rows, cols, case.matrix.shape[0], power=power))
    plan = neural_fsai_case_plan(case.matrix, power, width, device=dev)
    with torch.no_grad():
        sub, e = local_systems(plan.plan,
                               lookup_local_blocks(plan.plan, plan.l0_vals))
        n, w = sub.shape[:2]
        label = (f"the mesh study's mesh_cells {cells} case (dof "
                 f"{plan.n}, N {n}, w {w}; pattern width {uncapped}, "
                 f"capped past {width})")
        err = check_gauss_jordan_on(sub, e, label)
        rec = measure(
            f"B1 on {label}; max abs err {err:.3e}, rtol {GJ_RTOL}, atol "
            f"{GJ_ATOL}",
            lambda: masked_gauss_jordan(sub, e),
            lambda: masked_gauss_jordan_torch(sub, e),
            lambda: torch.linalg.solve_ex(sub, e[..., None]),
            gauss_jordan_work(n, w), sub.device, card)
    return err, rec


def check_mesh_study(dev, card):
    """Phase 4l: the mesh-generalization study through its entry point
    (``python -m deeppreconditioning_tpu_torch.compare_meshes
    --cases-per-resolution 1``'s ``run``) against the JAX CPU f32 fixture;
    returns its launches and peak GiB."""
    ref = json.loads(MESHES_FIXTURE.read_text())
    t0 = time.perf_counter()
    _backend.reset_launch_counts()
    mem = {}
    with peak_memory(dev, mem):
        rows = compare_meshes.run(dev, cases_per_resolution=1)
    launches = _backend.launch_counts()
    hold_host("meshes")
    plain = _backend.plain_cuda_counts()
    wall_s = time.perf_counter() - t0
    out = RESULTS / "compare_meshes.csv"
    compare_meshes.write_csv(rows, out)
    failures = []
    header = out.read_text().splitlines()[0]
    if header != ",".join(compare_meshes.FIELDS):
        failures.append(f"compare_meshes.csv schema changed: {header}")
    expected = sum(r["setups"] for r in rows)
    print(f"mesh study: {len(rows)} cases (seed {compare_meshes.SEED}, "
          f"mesh_cells {compare_meshes.MESH_CELLS}), {wall_s:.1f} s wall "
          f"(generation, host kappas, plans, setups); B1 launches "
          f"{launches['gauss_jordan']} (setups {expected}); plain versions "
          f"on the card: {plain}; peak memory {mem['peak_gib']:.3f} GiB")
    if launches["gauss_jordan"] == 0 or launches["gauss_jordan"] != expected:
        failures.append("B1 not launched once per setup")
    if any(plain.values()):
        failures.append(f"a plain version ran on the card: {plain}")
    if (ref["seed"], ref["cases_per_resolution"]) != (compare_meshes.SEED,
                                                      1):
        failures.append("the mesh fixture describes another study")
    print(f"mesh study per case on {card} (setup: forward and M on the "
          f"card, median of {compare_meshes.TIMING_REPS}):")
    for got, want in zip(rows, ref["rows"]):
        pre_rel = abs(got["kappa_pre"] / want["kappa_pre"] - 1)
        post_rel = abs(got["kappa_post"] / want["kappa_post"] - 1)
        print(f"  mesh_cells {got['mesh_cells']} dof {got['dof']} (JAX "
              f"{want['dof']}) kappa {got['kappa_pre']:.6g} -> "
              f"{got['kappa_post']:.6g} (JAX CPU f32 {want['kappa_pre']:.6g}"
              f" -> {want['kappa_post']:.6g}; rel {pre_rel:.2e} / "
              f"{post_rel:.2e}) setup {got['setup_s'] * 1e3:.3f} ms")
        if (got["mesh_cells"], got["dof"]) != (want["mesh_cells"],
                                               want["dof"]):
            failures.append(f"mesh case {got['mesh_cells']}: dof "
                            f"{got['dof']} vs {want['dof']}")
        if pre_rel > KAPPA_PRE_RTOL or post_rel > KAPPA_POST_RTOL:
            failures.append(f"mesh case {got['mesh_cells']}: kappa "
                            f"{got['kappa_pre']} -> {got['kappa_post']} vs "
                            f"{want['kappa_pre']} -> {want['kappa_post']}")
    if len(rows) != len(ref["rows"]):
        failures.append(f"{len(rows)} mesh cases, reference "
                        f"{len(ref['rows'])}")
    if failures:
        raise AssertionError("; ".join(failures))
    return launches, mem["peak_gib"]


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
        if w != GJ_FRAMES_W:
            raise AssertionError(f"frames systems of width {w}, not "
                                 f"{GJ_FRAMES_W}")
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


def check_ilu_path(cases, card):
    """Phase 4k: the technique incomplete_lu per case on the main path's
    split through the test-stage entry point (``python -m
    deeppreconditioning_tpu_torch.test --techniques incomplete_lu``'s
    ``run``), against the JAX CPU float32 fixture (ICT on the reference's
    native route): success as the fixture, per-case |delta| <= 2, the mean
    within 1%; density and kappa of the first cases as the fixture's (the
    factor and kappa are float64 host work); the host runtime's ICT and
    levels called, no numpy fallback, no plain version on the card.
    Prints the mean beside the TPU table's."""
    fixture = json.loads(ILU_FIXTURE.read_text())
    args = test_entry.parse_args([
        "--model", "NeuralFSAI", "--checkpoint",
        str(REPO / "assets" / "checkpoints_fsai" / "best.msgpack"),
        "--techniques", "incomplete_lu",
        "--kappa-cases", str(fixture["kappa_cases"]),
        "--results-dir", str(RESULTS / "ilu")])
    t0 = time.perf_counter()
    _backend.reset_launch_counts()
    suite = test_entry.run(args, cases=cases)
    plain = _backend.plain_cuda_counts()
    hold_host("incomplete_lu", ("ict", "levels"))
    wall_s = time.perf_counter() - t0
    if (fixture["seed"], fixture["cases"], fixture["n_pad"]) != (
            SEED, len(suite.data_set), suite.data_set.dof_pad):
        raise AssertionError("the incomplete_lu fixture describes another "
                             "split")
    name = "incomplete_lu"
    failures = []
    success = [s == 100.0 for s in suite.successes[name]]
    mean, ref_mean, worst = hold_counts(
        name, suite.iterations[name], fixture["iterations"], success,
        fixture["success"], 2, 0.01, failures)
    kappas = suite.kappas[name][:fixture["kappa_cases"]]
    if not np.allclose(kappas, fixture["kappas"], rtol=ILU_KAPPA_RTOL,
                       atol=0):
        failures.append(f"{name}: kappas {kappas} vs {fixture['kappas']}")
    if not np.allclose(suite.densities[name], fixture["densities"],
                       rtol=1e-12, atol=0):
        failures.append(f"{name}: densities differ from the fixture")
    if any(plain.values()):
        failures.append(f"{name}: a plain version ran on the card {plain}")
    header = (RESULTS / "ilu" / "table.csv").read_text().splitlines()[0]
    if header != "technique," + ",".join(TABLE_PARAMETERS):
        failures.append(f"{name}: table schema changed: {header}")
    print(f"incomplete_lu per case on {card}: {len(suite.data_set)} cases, "
          f"{wall_s:.1f} s wall; iters {mean:.2f} (JAX CPU f32 "
          f"{ref_mean:.2f}, max |delta| per case {worst}; TPU table "
          f"{TPU_ILU_RECORD['iterations']}, context only), kappa "
          f"{np.mean(kappas):.4f} (JAX {np.mean(fixture['kappas']):.4f}, TPU "
          f"table {TPU_ILU_RECORD['kappa']}), density "
          f"{np.mean(suite.densities[name]):.6f} %, setup "
          f"{np.median(suite.setups[name]) * 1e3:.3f} solve "
          f"{np.median(suite.durations[name]) * 1e3:.3f} total "
          f"{np.median(suite.totals[name]) * 1e3:.3f} ms (medians), success "
          f"{np.mean(success) * 100:.0f}%; host runtime calls "
          f"{HOST_PATHS['incomplete_lu']}")
    if failures:
        raise AssertionError("; ".join(failures))


def check_conv_path(cases, card):
    """Phase 4g: the conv families' learned technique through the
    test-stage entry point, per fixture run; returns the launches."""
    fixture = json.loads(CONV_FIXTURE.read_text())
    failures = []
    launches = dict.fromkeys(_backend.KERNELS, 0)
    print(f"conv path on {card} (ms, median over cases; setup = forward "
          f"and M or L values):")
    for run, ref in fixture["runs"].items():
        checkpoint = REPO / ref["checkpoint"]
        args = test_entry.parse_args([
            "--model", ref["model"], "--checkpoint", str(checkpoint),
            "--techniques", "learned", "--kappa-cases", "0",
            "--timing-reps", str(CONV_TIMING_REPS),
            "--results-dir", str(RESULTS / "conv" / run)])
        t0 = time.perf_counter()
        _backend.reset_launch_counts()
        suite = test_entry.run(args, cases=cases,
                               learned_apply=ref["learned_apply"])
        run_launches = _backend.launch_counts()
        hold_host("conv", ("conv_plan",) if ref["model"]
                  == "PreconditionerNet" else ())
        plain = _backend.plain_cuda_counts()
        wall_s = time.perf_counter() - t0
        data_set = suite.data_set
        models = fixture["models"][ref["model"]]
        if (fixture["seed"], fixture["cases"], fixture["n_pad"]) != (
                SEED, len(data_set), data_set.dof_pad):
            raise AssertionError("the conv fixture describes another split")
        if data_set.level_buckets != models["level_buckets"]:
            failures.append(f"{run}: level buckets {data_set.level_buckets}"
                            f", reference {models['level_buckets']}")
        if ref["learned_apply"] == "factor" and (
                list(suite._learned_widths()) != models["final_widths"]):
            failures.append(f"{run}: factor widths differ")
        if any(run_launches.values()) or any(plain.values()):
            failures.append(f"{run}: launches {run_launches}, plain "
                            f"versions on the card {plain}")
        for name, count in run_launches.items():
            launches[name] += count
        success = [s == 100.0 for s in suite.successes["learned"]]
        mean, ref_mean, worst = hold_counts(
            f"conv {run}", suite.iterations["learned"], ref["iterations"],
            success, ref["success"], 2, 0.01, failures)
        rel = check_conv_setup_against_cpu(suite, ref, checkpoint)
        prep = {k: round(v, 3) for k, v in suite.prep_seconds.items()}
        print(f"  {run:<20} {ref['model']} {ref['learned_apply']}: iters "
              f"{mean:6.2f} (JAX CPU f32 {ref_mean:6.2f}, max |delta| per "
              f"case {worst}) setup "
              f"{np.median(suite.setups['learned']) * 1e3:.3f} solve "
              f"{np.median(suite.durations['learned']) * 1e3:.3f} total "
              f"{np.median(suite.totals['learned']) * 1e3:.3f} success "
              f"{np.mean(success) * 100:.0f}%; case 0 card f32 vs CPU f64 "
              f"{rel:.3e} (limit {M_RTOL}); plan prep (untimed, s) {prep};"
              f" {wall_s:.1f} s wall")
        if not rel <= M_RTOL:
            failures.append(f"{run}: case 0's setup disagrees with the CPU")
        if ref["learned_apply"] == "factor":
            compare_conv_applies(suite, failures)
    print(card_line())
    if failures:
        raise AssertionError("; ".join(failures))
    return launches


def check_conv_setup_against_cpu(suite, ref, checkpoint):
    """Case 0's M (dense) or L values (factor): the card (float32) against
    the port's CPU float64 setup, max |diff| / max |CPU|."""
    cpu = BenchmarkSuite(
        suite.data_set,
        conv_model_from_checkpoint(ref["model"],
                                   load_checkpoint(checkpoint)),
        techniques=("learned",), device="cpu", dtype=torch.float64,
        learned_apply=ref["learned_apply"],
    )
    with torch.no_grad():
        got = suite.setup("learned", 0)[1]
        want = cpu.setup("learned", 0)[1]
    if ref["learned_apply"] == "factor":
        got, want = got[1], want[1]
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("conv setup: non-finite values on the card")
    return float((got.double().cpu() - want).abs().max() / want.abs().max())


def compare_conv_applies(suite, failures):
    """Case 0's dense apply (M r) against its factor apply (L (L^T r)) on
    one vector: agreement, and ms per apply as PCG issues it and as a
    CUDA graph replays it."""
    dev = suite.device
    a_sp, ell, _ = suite._system(0)
    batch = suite._conv_batch(0)
    with torch.no_grad():
        m = _learned_setup_device(suite.model, batch.features, batch.plans,
                                  batch.scales, a_sp.shape[0])
        apply_f, m_data = suite.setup("learned", 0)
    r = torch.randn(ell.n_pad, generator=torch.Generator().manual_seed(SEED),
                    dtype=torch.float32).to(dev)
    applies = {"dense": lambda: m @ r, "factor": lambda: apply_f(m_data, r)}
    want, got = applies["dense"](), applies["factor"]()
    rel = float((got - want).abs().max() / want.abs().max())
    if not rel <= M_RTOL:
        failures.append(f"conv applies disagree: {rel:.3e}")
    issued = {name: [] for name in applies}
    for _ in range(CONV_APPLY_ROUNDS):
        for name, fn in applies.items():
            fn()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(CONV_APPLY_CALLS):
                fn()
            end.record()
            end.synchronize()
            issued[name].append(start.elapsed_time(end) / CONV_APPLY_CALLS)
    print(f"  conv applies alone, case 0 (n_pad {ell.n_pad}, ms per apply; "
          f"issued: median of {CONV_APPLY_ROUNDS} rounds of "
          f"{CONV_APPLY_CALLS} calls; graph: device time): " + "; ".join(
              f"{name} issued {np.median(issued[name]):.4f} (rounds "
              f"{min(issued[name]):.4f}-{max(issued[name]):.4f}) graph "
              f"{time_graph(fn, dev) * 1e3:.4f}"
              for name, fn in applies.items())
          + f"; factor vs dense {rel:.3e}")


def check_training_path(cases, card):
    """Phase 4f: one flagship training epoch through the train entry
    point against the JAX CPU float32 epoch; returns the launches and the
    run."""
    fixture = json.loads(TRAIN_FIXTURE.read_text())
    out = RESULTS / "train"
    args = train_entry.parse_args([
        "--init-from", str(TRAIN_INIT), "--checkpoint-dir", str(out),
        "--metrics-dir", str(out / "metrics"), "--validate-init"])
    cfg = fixture["config"]
    params = args.params
    if ((fixture["seed"], fixture["cases"], fixture["mesh_cells"]) != (
            SEED, params.number_samples, params.mesh_cells)
            or cfg != {"batch_size": params.batch_size, "width": args.width,
                       "hidden": args.hidden, "poly_degree": args.poly_degree,
                       "power": args.power, "range_h": 256, "loss": args.loss,
                       "pcg_steps": args.pcg_steps, "learning_rate": args.lr,
                       "select_by": args.select_by, "seed": params.seed}):
        raise AssertionError("the training fixture describes another run")
    (out / "metrics" / "metrics.jsonl").unlink(missing_ok=True)
    t0 = time.perf_counter()
    _backend.reset_launch_counts()
    run = train_entry.run(args, cases=cases)
    launches = _backend.launch_counts()
    hold_host("train")
    plain = _backend.plain_cuda_counts()
    wall_s = time.perf_counter() - t0
    data_set, state = run.data_set, run.state
    if (fixture["n_pad"], fixture["nnz0_pad"], fixture["split_cases"]) != (
            data_set.dof_pad, data_set.nnz0_pad,
            len(data_set) * data_set.batch_size):
        raise AssertionError("the training fixture describes another split")
    init, epoch = state.epochs
    losses = np.asarray(epoch["step_losses"])
    ref = np.asarray(fixture["step_losses"])
    failures = []
    if losses.shape != ref.shape:
        raise AssertionError(f"{losses.shape[0]} steps, reference "
                             f"{ref.shape[0]}")
    rel = np.abs(losses - ref) / np.abs(ref)
    expected = fixture["train_batches"] + 2 * fixture["val_batches"]
    step_ms = np.median(epoch["step_seconds"]) * 1e3
    print(f"training path: {len(data_set)} batches of "
          f"{data_set.batch_size}, n_pad {data_set.dof_pad}, plan kind "
          f"{run.plan_provider.kind}; {wall_s:.1f} s wall (split, plans, "
          f"init validation, epoch, checkpoints); epoch {epoch['seconds']:.2f}"
          f" s; train step median {step_ms:.3f} ms (min "
          f"{min(epoch['step_seconds']) * 1e3:.3f}, max "
          f"{max(epoch['step_seconds']) * 1e3:.3f}); the epoch's plan "
          f"builds {epoch['prepare_seconds']:.2f} s, outside the steps "
          f"[{card}]")
    print(f"  step losses against the JAX CPU f32 epoch: step 0 "
          f"{losses[0]:.7f} vs {ref[0]:.7f} (rel {rel[0]:.2e}, limit "
          f"{TRAIN_STEP0_RTOL}); worst rel {rel.max():.2e} at step "
          f"{int(rel.argmax())} (limit {TRAIN_STEP_RTOL}); epoch mean "
          f"{epoch['train_loss']:.7f} vs {fixture['train_loss']:.7f}")
    if not rel[0] <= TRAIN_STEP0_RTOL:
        failures.append(f"step 0 loss {losses[0]} vs {ref[0]}")
    if not (rel <= TRAIN_STEP_RTOL).all():
        failures.append(f"step {int(rel.argmax())} loss off by {rel.max()}")
    logged = [json.loads(line) for line in
              (out / "metrics" / "metrics.jsonl").read_text().splitlines()]
    logged = [r["value"] for r in logged if r["name"] == "train/loss/inverse"]
    if logged != [epoch["train_loss"]]:
        failures.append(f"metrics.jsonl train loss {logged}")
    for name, got in (("init", init), ("epoch", epoch)):
        want = fixture[name]
        iters, ref_iters = (np.asarray(got["val_iterations"]),
                            np.asarray(want["iterations"]))
        vrel = abs(got["val_loss"] - want["val_loss"]) / abs(want["val_loss"])
        print(f"  validation at {name}: iterations {iters.mean():.3f} (JAX "
              f"CPU f32 {ref_iters.mean():.3f}, max |delta| per case "
              f"{int(np.abs(iters - ref_iters).max())}), loss "
              f"{got['val_loss']:.6f} vs {want['val_loss']:.6f} (rel "
              f"{vrel:.2e}); B1 launches {got['b1_launches']}")
        if (np.abs(iters - ref_iters) > TRAIN_ITERS_CASE).any():
            failures.append(f"{name} validation: a case is off")
        if abs(iters.mean() - ref_iters.mean()) > (TRAIN_ITERS_MEAN
                                                   * ref_iters.mean()):
            failures.append(f"{name} validation mean {iters.mean()}")
        if not vrel <= TRAIN_VAL_RTOL:
            failures.append(f"{name} validation loss off by {vrel}")
    print(f"  B1 launches {launches['gauss_jordan']} (steps + validation "
          f"batches at init and after the epoch: {expected}); plain "
          f"versions on the card: {plain}")
    if launches["gauss_jordan"] != expected or epoch["b1_launches"] != (
            fixture["train_batches"] + fixture["val_batches"]):
        failures.append("B1 not launched once per step and validation batch")
    if any(plain.values()):
        failures.append(f"a plain version ran on the card: {plain}")
    payload = load_checkpoint(out / "best.msgpack")
    if not same_tree(payload["params"],
                     params_to_jax(state.model.state_dict())) or (
                         payload["step"] != state.step):
        failures.append("best.msgpack does not hold the trained model")
    if failures:
        raise AssertionError("; ".join(failures))
    return launches, run


def check_conv_training(cases, card):
    """Phase 4h: one epoch of each conv family through the train entry
    point against the JAX CPU float32 epoch; returns the launches."""
    fixture = json.loads(CONV_TRAIN_FIXTURE.read_text())
    failures = []
    launches = dict.fromkeys(_backend.KERNELS, 0)
    for model, ref in fixture["models"].items():
        out = RESULTS / "train" / model
        args = train_entry.parse_args([
            "--model", model, "--checkpoint-dir", str(out),
            "--metrics-dir", str(out / "metrics"), "--init-from",
            str(CONV_TRAIN_INIT[model])])
        params = args.params
        if ((fixture["seed"], fixture["cases"], fixture["mesh_cells"]) != (
                SEED, params.number_samples, params.mesh_cells)
                or fixture["config"] != {
                    "batch_size": params.batch_size,
                    "channels": params.channels, "loss": args.loss,
                    "learning_rate": args.lr, "schedule": params.schedule,
                    "select_by": args.select_by, "seed": params.seed,
                    "max_iter": 1024}):
            raise AssertionError("the conv training fixture describes "
                                 "another run")
        (out / "metrics" / "metrics.jsonl").unlink(missing_ok=True)
        torch.cuda.synchronize()
        base_bytes = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _backend.reset_launch_counts()
        run = train_entry.run(args, cases=cases)
        run_launches = _backend.launch_counts()
        hold_host("conv-train", ("conv_plan",) if model
                  == "PreconditionerNet" else ())
        plain = _backend.plain_cuda_counts()
        wall_s = time.perf_counter() - t0
        peak_bytes = torch.cuda.max_memory_allocated()
        for name, count in run_launches.items():
            launches[name] += count
        data_set, state = run.data_set, run.state
        [epoch] = state.epochs
        split = (data_set.order, data_set.dof_pad, data_set.nnz0_pad,
                 len(data_set) * data_set.batch_size)
        if split != (fixture["order"], fixture["n_pad"], fixture["nnz0_pad"],
                     fixture["split_cases"]):
            failures.append(f"{model}: another split or padding")
        if data_set.level_buckets != ref["level_buckets"]:
            failures.append(f"{model}: level buckets "
                            f"{data_set.level_buckets}, reference "
                            f"{ref['level_buckets']}")
        losses = np.asarray(epoch["step_losses"])
        want = np.asarray(ref["step_losses"])
        if losses.shape != want.shape:
            raise AssertionError(f"{model}: {losses.shape[0]} steps, "
                                 f"reference {want.shape[0]}")
        rel = np.abs(losses - want) / np.abs(want)
        plan_bytes = sum(t.numel() * t.element_size()
                         for i in range(len(data_set))
                         for plan in data_set[i].plans for t in plan)
        steps = np.asarray(epoch["step_seconds"]) * 1e3
        print(f"conv training {model}: {len(data_set)} batches of "
              f"{data_set.batch_size}, n_pad {data_set.dof_pad}, level "
              f"buckets {data_set.level_buckets}; plans "
              f"{data_set.plan_seconds:.2f} s (untimed prep); {wall_s:.1f} s"
              f" wall (split, plans, epoch, checkpoints); epoch "
              f"{epoch['seconds']:.2f} s; train step median "
              f"{np.median(steps):.3f} ms (min {steps.min():.3f}, max "
              f"{steps.max():.3f}); validation "
              f"{epoch['val_seconds_per_batch'] * 1e3:.1f} ms per batch; "
              f"plans on the card {plan_bytes / 2**20:.1f} MiB; peak memory "
              f"{peak_bytes / 2**30:.3f} GiB ({base_bytes / 2**30:.3f} GiB "
              f"held before the run) [{card}]")
        print(f"  step losses against the JAX CPU f32 epoch: step 0 "
              f"{losses[0]:.7f} vs {want[0]:.7f} (rel {rel[0]:.2e}, limit "
              f"{CONV_STEP0_RTOL}); worst rel {rel.max():.2e} at step "
              f"{int(rel.argmax())} (limit {CONV_STEP_RTOL}); first step "
              f"above 1e-4: "
              f"{int(np.argmax(rel > 1e-4)) if (rel > 1e-4).any() else None}"
              f"; epoch mean {epoch['train_loss']:.7f} vs "
              f"{ref['train_loss']:.7f}")
        if not rel[0] <= CONV_STEP0_RTOL:
            failures.append(f"{model}: step 0 loss {losses[0]} vs {want[0]}")
        if not (rel <= CONV_STEP_RTOL).all():
            failures.append(f"{model}: step {int(rel.argmax())} loss off by "
                            f"{rel.max()}")
        iters = np.asarray(epoch["val_iterations"])
        ref_iters = np.asarray(ref["val_iterations"])
        vrel = abs(epoch["val_loss"] - ref["val_loss"]) / abs(ref["val_loss"])
        mean, ref_mean, worst = hold_counts(
            f"{model} validation", iters, ref_iters, True, True,
            CONV_ITERS_CASE, CONV_ITERS_MEAN, failures)
        print(f"  validation after the epoch: iterations {mean:.3f} (JAX CPU "
              f"f32 {ref_mean:.3f}, max |delta| per case {worst}), loss "
              f"{epoch['val_loss']:.6f} vs {ref['val_loss']:.6f} (rel "
              f"{vrel:.2e}, limit {CONV_VAL_RTOL}); launches {run_launches},"
              f" plain versions on the card {plain}")
        if not vrel <= CONV_VAL_RTOL:
            failures.append(f"{model}: validation loss off by {vrel}")
        if any(run_launches.values()) or any(plain.values()):
            failures.append(f"{model}: a kernel or a plain version ran")
        logged = [json.loads(line) for line in
                  (out / "metrics" / "metrics.jsonl").read_text()
                  .splitlines()]
        if [(r["name"], r["value"]) for r in logged] != [
                ("train/loss/inverse", epoch["train_loss"]),
                ("val/loss/inverse", epoch["val_loss"]),
                ("val/metric/durations", epoch["val_seconds_per_batch"]),
                ("val/metric/iterations", epoch["val_mean_iterations"])]:
            failures.append(f"{model}: metrics.jsonl is not the epoch's")
        payload = load_checkpoint(out / "best.msgpack")
        if not same_tree(payload["params"], conv_params_to_jax(
                state.model.state_dict())) or payload["step"] != state.step:
            failures.append(f"{model}: best.msgpack does not hold the "
                            "trained model")
        del run, data_set, state
    print(card_line())
    if failures:
        raise AssertionError("; ".join(failures))
    return launches


def same_tree(a, b) -> bool:
    """Two trees of maps with numpy leaves: same keys, equal arrays."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(same_tree(a[k], b[k]) for k in a))
    return a.dtype == b.dtype and np.array_equal(a, b)


def check_gauss_jordan_training(run, card):
    """B1 against its plain version on the local systems of the first
    training batch (every case's columns in one launch)."""
    batch = run.data_set[0]
    plans = run.plan_provider(0, batch)
    with torch.no_grad():
        a_full = symmetrize_tril(batch.systems.to_dense())
        sub, e = local_systems(plans, range_local_blocks(plans, a_full))
        w = sub.shape[-1]
        sub, e = sub.reshape(-1, w, w), e.reshape(-1, w)
        n = sub.shape[0]
        err = check_gauss_jordan_on(sub, e, f"a training batch (N {n})")
        rec = measure(
            f"B1 on a training batch's local systems "
            f"({batch.features.shape[0]} cases, N {n}, w {w}; max abs err "
            f"{err:.3e}, rtol {GJ_RTOL}, atol {GJ_ATOL})",
            lambda: masked_gauss_jordan(sub, e),
            lambda: masked_gauss_jordan_torch(sub, e),
            lambda: torch.linalg.solve_ex(sub, e[..., None]),
            gauss_jordan_work(n, w), sub.device, card)
    return err, rec


def check_batched_path(suite, fixture, card):
    """Phase 4d: the batched protocol on the main path's split through
    the entry point's ``run_batched``, against the JAX reference's
    ``run_batched`` counts; returns the records and the launches."""
    ref = fixture["batched"]
    t0 = time.perf_counter()
    _backend.reset_launch_counts()
    batched = run_batched(suite)
    launches = _backend.launch_counts()
    hold_host("batched", ("ic0",))
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


def check_irregular_path(dev, fixture, card, cases):
    """Phase 4e: bench.py's irregular split (``cases``) per case through
    its entry point, against the JAX reference counts; returns the suite
    and its launches."""
    ref = fixture["irregular"]
    t0 = time.perf_counter()
    _backend.reset_launch_counts()
    suite = irregular.run(dev, results_directory=RESULTS / "irregular",
                          timing_reps=SHALLOW_TIMING_REPS, cases=cases)
    launches = _backend.launch_counts()
    hold_host("irregular")
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


def check_structured_training(dev, card):
    """Phase 4i: the structured trainer through its entry point from the
    JAX init, w 13 at the script's defaults (400 steps) and w 4 (25
    steps, power 1, degree 0), held against the JAX CPU f32 run
    (``structured_train.json``); one B1 launch per step, B2 launched
    forward and backward for every operator product, no plain version on
    the card, the payload read back equal; then the w-13 checkpoint
    deployed through ``run_scaling`` at 64^3 (fsai and learned).  Returns
    the launches and the runs."""
    fixture = json.loads(STRUCT_FIXTURE.read_text())
    launches = dict.fromkeys(_backend.KERNELS, 0)
    failures, runs = [], {}
    for tag, extra in STRUCT_ARGS.items():
        ref = fixture["runs"][tag]
        cfg = ref["config"]
        args = structured_train.parse_args(extra + [
            "--init-from", str(STRUCT_INIT[tag]),
            "--out", str(RESULTS / "train_structured" / f"{tag}.msgpack")])
        if cfg != dict(cfg, shape=[int(v) for v in args.shape.split(",")],
                       samples=args.samples, lr=args.lr, power=args.power,
                       degree=args.degree, hidden=args.hidden,
                       pcg_steps=args.pcg_steps, rhs=args.rhs, seed=args.seed,
                       sigma=list(structured_train.parse_sigma(args.sigma))):
            raise AssertionError(f"the {tag} fixture describes another run")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _backend.reset_launch_counts()
        t0 = time.perf_counter()
        run = structured_train.run(args, device=dev,
                                   log=lambda line: print("  " + line))
        counts = _backend.launch_counts()
        plain = _backend.plain_cuda_counts()
        wall_s = time.perf_counter() - t0
        for kernel, count in counts.items():
            launches[kernel] += count
        losses = np.asarray(run.losses)
        want = np.asarray(ref["losses"])
        got = losses[:len(want)]
        diff = np.abs(got - want)
        tight = want > STRUCT_TIGHT_ABOVE
        steps = np.asarray(run.step_seconds) * 1e3
        forward = args.pcg_steps * (1 + 2 * args.degree)
        print(f"structured training {tag}: width {run.model.width}, "
              f"{args.steps} steps of {args.samples} samples at "
              f"{args.shape}; {wall_s:.1f} s wall (data "
              f"{run.setup_seconds:.2f} s); step median "
              f"{np.median(steps):.3f} ms (min {steps.min():.3f}, max "
              f"{steps.max():.3f}); peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
              f"[{card}]")
        print(f"  against the JAX CPU f32 run ({len(want)} steps): step 0 "
              f"{got[0]:.6f} vs {want[0]:.6f} (|d| {diff[0]:.2e}, limit "
              f"{STRUCT_STEP0_ABS}); steps above {STRUCT_TIGHT_ABOVE}: "
              f"{int(tight.sum())}, worst |d| "
              f"{diff[tight].max() if tight.any() else 0.0:.2e} (limit "
              f"{STRUCT_STEP_ABS}); later steps' worst |d| "
              f"{diff[~tight].max() if (~tight).any() else 0.0:.3f}; best "
              f"{got.min():.4f} vs {want.min():.4f} (limit "
              f"{STRUCT_FINAL_ABS}); best over all {args.steps} steps "
              f"{run.best_loss:.4f} at step {run.best_step}")
        print(f"  launches {counts} (per step: B1 1, B2 {forward} forward + "
              f"{forward} backward); plain versions on the card {plain}")
        if not np.isfinite(losses).all() or not diff[0] <= STRUCT_STEP0_ABS:
            failures.append(f"{tag}: step 0 {got[0]} vs {want[0]}, or a "
                            "loss not finite")
        if tight.any() and not diff[tight].max() <= STRUCT_STEP_ABS:
            failures.append(f"{tag}: a step above {STRUCT_TIGHT_ABOVE} off "
                            f"by {diff[tight].max()}")
        if not abs(got.min() - want.min()) <= STRUCT_FINAL_ABS:
            failures.append(f"{tag}: best loss {got.min()} vs {want.min()}")
        if (counts["gauss_jordan"] != args.steps
                or counts["dia_spmv"] != 2 * forward * args.steps):
            failures.append(f"{tag}: launches {counts}")
        if any(plain.values()):
            failures.append(f"{tag}: a plain version ran on the card {plain}")
        payload = load_checkpoint(run.out)
        best = params_to_jax({k: v.float() for k, v in run.best_state.items()})
        if not same_tree(payload["params"], best) or (
                payload["final_loss"], payload["width"], payload["power"]) != (
                    run.best_loss, run.model.width, args.power):
            failures.append(f"{tag}: the payload does not hold the best "
                            "parameters")
        runs[tag] = run
    t0 = time.perf_counter()
    _backend.reset_launch_counts()
    deployed = scaling.run_scaling(
        dev, shapes=(STRUCT_DEPLOY_SIDE,), techniques=("fsai", "learned"),
        out=RESULTS / "scaling_trained.csv", ckpt=runs["w13"].out,
        smoother_ckpt=scaling.CHECKPOINT_DIR / scaling.SMOOTHER_CHECKPOINT)
    for kernel, count in _backend.launch_counts().items():
        launches[kernel] += count
    rows = {r["technique"]: r for r in deployed.rows}
    print(f"  the w-13 checkpoint deployed at {STRUCT_DEPLOY_SIDE}^3 "
          f"({time.perf_counter() - t0:.1f} s): learned "
          f"{rows['learned']['iterations']} iterations (converged "
          f"{rows['learned']['converged']}, q "
          f"{deployed.learned_q[STRUCT_DEPLOY_SIDE]}), "
          f"fsai {rows['fsai']['iterations']}; totals "
          f"{rows['learned']['total_s'] * 1e3:.3f} / "
          f"{rows['fsai']['total_s'] * 1e3:.3f} ms")
    if not (rows["learned"]["converged"] and rows["learned"]["iterations"]
            < rows["fsai"]["iterations"]):
        failures.append("the trained checkpoint does not beat fsai at 64^3")
    if failures:
        raise AssertionError("; ".join(failures))
    return launches, runs


def check_structured_kernels(dev, card):
    """B1 on the structured trainer's local systems (w 13 and w 4, N = 32
    samples x 2048 columns) and batched B2 at (32, 7, 2048), forward and
    its backward (B2 on A^T, and the autograd function's gradient against
    the plain product's), against the plain versions, timed as in phase
    3.  Returns the worst errors and the records."""
    shape, samples = (12, 12, 12), 32
    a, _ = structured_train.make_data(shape, samples, (1.0, 1.0), "random",
                                      69, device=dev)
    gj_err, dia_err, records = 0.0, 0.0, {}
    with torch.no_grad():
        a_scaled, _ = jacobi_scale_dia(a)
        for power in (2, 1):
            plan = build_structured_plan(shape, power=power)
            sub, e = _local_systems(
                _band_reads(a_scaled, plan), plan,
                slot_valid(plan, a.n_pad, dev), 0, a.n_pad)
            n, w = sub.shape[0], sub.shape[-1]
            err = check_gauss_jordan_on(sub, e, f"the structured trainer's "
                                        f"w {w}")
            gj_err = max(gj_err, err)
            records[("gauss_jordan", w)] = measure(
                f"B1 on the structured trainer's local systems ({samples} "
                f"samples, N {n}, w {w}; max abs err {err:.3e}, rtol "
                f"{GJ_RTOL}, atol {GJ_ATOL})",
                lambda: masked_gauss_jordan(sub, e),
                lambda: masked_gauss_jordan_torch(sub, e),
                lambda: torch.linalg.solve_ex(sub, e[..., None]),
                gauss_jordan_work(n, w), dev, card)
            del sub, e
        rng = np.random.default_rng(4)
        x, g = (torch.tensor(rng.standard_normal((samples, a.n_pad),
                                                 dtype=np.float32),
                             device=dev) for _ in range(2))
        a_t = a.transpose()
        for label, op, v in (("forward", a, x), ("backward (A^T)", a_t, g)):
            got = dia_matvec(op, v)
            torch.cuda.synchronize()
            ref = op.matvec(v)
            diff = (got - ref).abs()
            err = float(diff.max())
            if not bool(torch.isfinite(got).all()) or bool(
                    (diff > B2_ATOL + B2_RTOL * ref.abs()).any()):
                raise AssertionError(f"batched B2 {label} disagrees with its "
                                     f"plain version: {err}")
            dia_err = max(dia_err, err)
            csr = dia_csr(op)
            flat = v.reshape(-1)
            records[("dia_spmv", label)] = measure(
                f"B2 batched {label} ({samples} x {len(op.offsets)} bands x "
                f"{a.n_pad}; max abs err {err:.3e}; bit-equal "
                f"{torch.equal(got, ref)}; library block-diagonal "
                f"CSR nnz {csr.values().numel()})",
                lambda: dia_matvec(op, v), lambda: op.matvec(v),
                lambda: csr @ flat, dia_work(len(op.offsets),
                                             samples * a.n_pad), dev, card)
            print_against_library(f"B2 batched {label}",
                                  records[("dia_spmv", label)])
            del csr
    xr = x.clone().requires_grad_(True)
    dia_matvec(a, xr, a_t).backward(g)
    xp = x.clone().requires_grad_(True)
    a.matvec(xp).backward(g)
    grad_err = float((xr.grad - xp.grad).abs().max())
    print(f"B2 autograd function on the card: gradient against the plain "
          f"product's, max abs err {grad_err:.3e}")
    if not grad_err <= B2_ATOL + B2_RTOL * float(xp.grad.abs().max()):
        raise AssertionError("B2's backward disagrees with the plain product")
    return gj_err, dia_err, records


def run_large_solve(card):
    """Phase 4j: the matrix-free 256^3 CG through its entry point's
    function (``python -m deeppreconditioning_tpu_torch.bench.large_solve``):
    the reference's line; a finite x, and converged unless it ran to
    ``max_iter``.  No kernel: the stencil is plain PyTorch."""
    _backend.reset_launch_counts()
    t0 = time.perf_counter()
    res = large_solve(LARGE_GRID)
    launches = _backend.launch_counts()
    print(f"{res.line()} ({time.perf_counter() - t0:.1f} s wall with the "
          f"warm-up) [{card}]")
    if not bool(torch.isfinite(res.x).all()) or not (
            res.residual < 1e-8 or res.iterations == 1024):
        raise AssertionError(f"large solve: residual {res.residual} after "
                             f"{res.iterations} iterations")
    if any(launches.values()) or any(_backend.plain_cuda_counts().values()):
        raise AssertionError("the stencil solve ran a kernel or a plain "
                             "version")
    return launches


def check_gauss_jordan_f64(dev, card):
    """Phase 3d: B1's float64 instance against its float64 plain version
    at GJ64_SHAPES (rtol GJ64_RTOL / atol GJ64_ATOL), each timed as in
    phase 3 beside ``torch.linalg.solve_ex`` in float64 and the bound
    (float64 bytes at the HBM rate, or its flops at the FP64 rate)."""
    rng = np.random.default_rng(13)
    max_err, records = 0.0, {}
    for n, w in GJ64_SHAPES:
        a, e = spd_systems(rng, n, w, np.float64)
        sub = torch.tensor(a, device=dev)
        rhs = torch.tensor(e, device=dev)
        del a, e
        label = f"w={w} N={n} float64"
        err = check_gauss_jordan_on(sub, rhs, label, GJ64_RTOL, GJ64_ATOL)
        max_err = max(max_err, err)
        records[(n, w)] = measure(
            f"B1 float64 w={w:2d} N={n:6d} (max abs err {err:.3e}, rtol "
            f"{GJ64_RTOL}, atol {GJ64_ATOL})",
            lambda: masked_gauss_jordan(sub, rhs),
            lambda: masked_gauss_jordan_torch(sub, rhs),
            lambda: torch.linalg.solve_ex(sub, rhs[..., None]),
            gauss_jordan_work(n, w, itemsize=8), dev, card, fp64=True)
        del sub, rhs
    return max_err, records


def check_residual_parity(dev, card):
    """Phase 4m: the residual-parity report through its entry point
    (``python -m deeppreconditioning_tpu_torch.residual_parity``'s
    ``run``) on the first RESIDUAL_CASES cases, numpy assembly, against
    the JAX CPU fixture (``residual_parity.json``): float64 iterations
    within 1 per case and technique and each float64 curve within
    CURVE_RTOL over the common prefix; float32 within 2 (vanilla and
    jacobi max(2, 5%)); B1 launched once per learned setup in each dtype,
    no plain version and no host fallback on the card.  Returns the
    launches by dtype."""
    ref = json.loads(RESIDUAL_FIXTURE.read_text())
    if (ref["seed"], ref["mesh_cells"]) != (residual_parity.SEED,
                                            residual_parity.MESH_CELLS) or (
            ref["cases"] < RESIDUAL_CASES):
        raise AssertionError("the residual-parity fixture describes another "
                             "run")
    want = {(r["case"], r["technique"], r["dtype"]): r for r in ref["rows"]}
    t0 = time.perf_counter()
    _backend.reset_launch_counts()
    rows = residual_parity.run(RESIDUAL_CASES, device=dev,
                               log=lambda _: None)
    by_dtype = _backend.dtype_launch_counts()
    plain = _backend.plain_cuda_counts()
    hold_host("residual-parity", ("ic0", "levels"))
    wall_s = time.perf_counter() - t0
    residual_parity.write_csv(RESULTS / "residual_parity.csv", rows)
    header = (RESULTS / "residual_parity.csv").read_text().splitlines()[0]
    failures, worst_curve, deltas = [], 0.0, {}
    if header != ",".join(residual_parity.COLUMNS):
        failures.append(f"residual_parity.csv schema changed: {header}")
    for r in rows:
        key = (r["case"], r["technique"], r["dtype"])
        w = want[key]
        d = abs(r["iterations"] - w["iterations"])
        deltas.setdefault((r["technique"], r["dtype"]), []).append(d)
        if r["dtype"] == "f64":
            k = min(len(r["curve"]), len(w["curve"]))
            got_c, want_c = np.asarray(r["curve"][:k]), np.asarray(
                w["curve"][:k])
            rel = float(np.max(np.abs(got_c - want_c) / np.abs(want_c))
                        if k else 0.0)
            worst_curve = max(worst_curve, rel)
            if d > 1 or rel > CURVE_RTOL:
                failures.append(f"{key}: {r['iterations']} vs "
                                f"{w['iterations']}, curve rel {rel:.2e}")
        else:
            bar = (max(2, 0.05 * w["iterations"])
                   if r["technique"] in RESIDUAL_DRIFT else 2)
            if d > bar:
                failures.append(f"{key}: {r['iterations']} vs "
                                f"{w['iterations']}")
    learned = sum(r["technique"] == "learned" for r in rows) // 2
    f64 = by_dtype.get(("gauss_jordan", "float64"), 0)
    f32 = by_dtype.get(("gauss_jordan", "float32"), 0)
    print(f"residual parity: {RESIDUAL_CASES} cases x "
          f"{len(deltas) // 2} techniques x (f64, f32), {wall_s:.1f} s "
          f"wall; B1 launches float64 {f64}, float32 {f32} (learned "
          f"setups per dtype: {learned}); plain versions on the card "
          f"{plain}; worst float64 curve rel diff {worst_curve:.3e} (limit "
          f"{CURVE_RTOL}) [{card}]")
    for (tech, label), ds in sorted(deltas.items()):
        mine = [r["iterations"] for r in rows
                if (r["technique"], r["dtype"]) == (tech, label)]
        print(f"  {tech:<20} {label}: iterations {mine}, max |delta| "
              f"against the JAX CPU {label} {max(ds)}")
    residual_parity.summarize(rows, log=lambda line: print("  " + line))
    if f64 == 0 or f64 != learned or f32 != learned:
        failures.append(f"B1 not launched once per learned setup in each "
                        f"dtype: {by_dtype}")
    if any(plain.values()):
        failures.append(f"a plain version ran on the card: {plain}")
    if failures:
        raise AssertionError("; ".join(failures))
    return {"gauss_jordan": f32}, f64


def check_sharded_solver(dev, card):
    """Phase 4n: the distributed solver on the card in an NCCL group of
    world size 1, at SHARDED_GRID^3 through the scaling bench's setup
    (``python -m deeppreconditioning_tpu_torch.scaling_bench``): the fsai
    factor's build (B1 once, w 4, N 262 144, no plain version), then
    none / jacobi / block_jacobi_ic / fsai in allgather and halo modes:
    iterations equal to ``preconditioned_conjugate_gradient`` on one
    device with the same apply, within the scaling path's bars of the
    JAX CPU float32 count at one shard (vanilla and jacobi 5%, the others
    max(2, 2%)); the solve timed (median of SHARDED_REPS, CUDA events)
    beside the byte model.  Then B1 on the build's real local systems,
    timed as in phase 3.  Returns the launches, B1's error and record."""
    ref = json.loads(PARALLEL_FIXTURE.read_text())["scaling"]
    if (ref["grid"], ref["max_iter"], ref["sweeps"]) != (
            SHARDED_GRID, scaling_bench.MAX_ITER, 8):
        raise AssertionError("the parallel fixture describes another run")
    t0 = time.perf_counter()
    multihost.initialize_single(dev)
    try:
        world = multihost.solver_world(dev)
        backend = torch.distributed.get_backend()
        a, b_host = scaling_bench.scaling_system(SHARDED_GRID)
        _backend.reset_launch_counts()
        columns = scaling_bench.fsai_columns(a, dev)
        torch.cuda.synchronize()
        launches = _backend.launch_counts()
        by_dtype = _backend.dtype_launch_counts()
        plain = _backend.plain_cuda_counts()
        hold_host("sharded")
        failures = []
        print(f"sharded solver: {backend} group of world size "
              f"{world.size}, {SHARDED_GRID}^3 (n {a.shape[0]}); fsai "
              f"factor width {columns[2]}: B1 launches {launches} "
              f"{by_dtype}, plain versions on the card {plain} "
              f"({time.perf_counter() - t0:.1f} s with the system)")
        if launches["gauss_jordan"] != 1 or by_dtype.get(
                ("gauss_jordan", "float32")) != 1 or any(plain.values()):
            failures.append(f"the fsai build's B1: {launches}, {plain}")
        if backend != "nccl":
            failures.append(f"backend {backend}, not nccl")
        ell = ELLMatrix.from_scipy(a, dtype=torch.float32, device=dev)
        _backend.reset_launch_counts()
        for mode in SHARDED_MODES:
            for pre in SHARDED_PRECONDS:
                solve = scaling_bench.solver_setup(a, b_host, world, pre,
                                                   mode, columns=columns)
                res = solve.run()
                single = preconditioned_conjugate_gradient(
                    ell_matvec, ell, solve.b, solve.single_apply,
                    solve.m_data, max_iter=scaling_bench.MAX_ITER)
                ms = time_call(solve.run, dev, reps=SHARDED_REPS) * 1e3
                its, one = int(res.iterations), int(single.iterations)
                want = ref["iterations"][f"{mode}/{pre}"]
                bar = (0.05 * want if pre in ("none", "jacobi")
                       else max(2, 0.02 * want))
                x_diff = float((res.x - single.x).abs().max())
                print(f"  {mode:<9} {pre:<15} iterations {its} (one device "
                      f"{one}, JAX CPU f32 one shard {want}), residual "
                      f"{float(res.residual):.2e}, |x - x_one| {x_diff:.2e};"
                      f" solve {ms:.3f} ms (median of {SHARDED_REPS}); "
                      f"comm model {solve.comm_bytes} B/iter/shard "
                      f"[{card}]")
                if its != one or abs(its - want) > bar:
                    failures.append(f"{mode}/{pre}: {its} (one device "
                                    f"{one}, JAX {want})")
                del solve
        solves = _backend.launch_counts()
        if any(solves.values()) or any(_backend.plain_cuda_counts().values()):
            failures.append(f"the solves ran a kernel or a plain version: "
                            f"{solves}, {_backend.plain_cuda_counts()}")
        hold_host("sharded", ("ic0",))
    finally:
        multihost.shutdown()
    # B1 on the fsai build's real local systems (w 4, N 262 144)
    plan, l0_v = scaling_bench.fsai_plan_inputs(a)
    plan = plan.to(dev)
    with torch.no_grad():
        sub, e = local_systems(plan, lookup_local_blocks(
            plan, torch.as_tensor(l0_v, device=dev)))
    n, w = sub.shape[0], sub.shape[-1]
    err = check_gauss_jordan_on(sub, e, "the sharded fsai build")
    record = measure(
        f"B1 on the sharded fsai build's local systems (w {w}, N {n}; "
        f"max abs err {err:.3e}, rtol {GJ_RTOL}, atol {GJ_ATOL})",
        lambda: masked_gauss_jordan(sub, e),
        lambda: masked_gauss_jordan_torch(sub, e),
        lambda: torch.linalg.solve_ex(sub, e[..., None]),
        gauss_jordan_work(n, w), dev, card)
    print(f"sharded solver phase: {time.perf_counter() - t0:.1f} s")
    if failures:
        raise AssertionError("; ".join(failures))
    return launches, err, record


def _npz_arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def check_generate(card):
    """Phase 4o: the generate stage through its entry point (``python -m
    deeppreconditioning_tpu_torch.generate_data``'s ``run``), the first
    GENERATE_CASES cases on each route: on the numpy assembly every file
    equal to the JAX package's (``residual_parity.json``'s sha256 digests:
    the text files, the archive's members); on the native assembly (the
    default) ``fvm_assemble`` called once per case, no fallback, and A's
    pattern equal and values within GENERATE_RTOL of the numpy route's."""
    ref = json.loads(RESIDUAL_FIXTURE.read_text())["generate"]
    root = RESULTS / "generate"
    shutil.rmtree(root, ignore_errors=True)
    args = ["--samples", str(GENERATE_CASES), "--mesh-cells", "2",
            "--root"]
    t0 = time.perf_counter()
    _backend.reset_launch_counts()
    with numpy_assembly():
        out_np = generate_data.run(generate_data.parse_args(
            args + [str(root / "numpy")]), log=lambda _: None)
    t_np = time.perf_counter() - t0
    hold_host("generate-numpy")
    t0 = time.perf_counter()
    _backend.reset_launch_counts()
    out_nat = generate_data.run(generate_data.parse_args(
        args + [str(root / "native")]), log=lambda _: None)
    t_nat = time.perf_counter() - t0
    calls = _backend.host_call_counts()["fvm_assemble"]
    hold_host("generate-native", ("fvm_assemble",))
    failures = []
    digests = [case_digests(out_np / f"case_{i:04d}")
               for i in range(GENERATE_CASES)]
    differ = {}
    for i, (got, want) in enumerate(zip(digests, ref["digests"])):
        bad = [f for f in want if got.get(f) != want[f]]
        if bad or set(got) != set(want):
            differ[i] = bad
    worst = 0.0
    for i in range(GENERATE_CASES):
        a_np = _npz_arrays(out_np / f"case_{i:04d}" / "matrix.npz")
        a_nat = _npz_arrays(out_nat / f"case_{i:04d}" / "matrix.npz")
        if not all(np.array_equal(a_np[k], a_nat[k])
                   for k in ("row", "col", "shape", "format")):
            failures.append(f"case {i}: the native A's pattern differs")
            continue
        rel = np.abs(a_nat["data"] - a_np["data"]) / np.abs(a_np["data"])
        worst = max(worst, float(rel.max()))
    print(f"generate stage: {GENERATE_CASES} cases; numpy route {t_np:.2f} s,"
          f" files equal to the JAX package's digests on "
          f"{GENERATE_CASES - len(differ)} of {GENERATE_CASES} cases "
          f"(differing: {differ or 'none'}); native route {t_nat:.2f} s, "
          f"fvm_assemble calls {calls}, A's max rel diff to the numpy "
          f"route {worst:.3e} (limit {GENERATE_RTOL}) [{card}]")
    if differ:
        failures.append(f"files differ from the reference's on {differ}")
    if calls != GENERATE_CASES:
        failures.append(f"fvm_assemble called {calls} times")
    if worst > GENERATE_RTOL:
        failures.append(f"native A off the numpy one by {worst}")
    if failures:
        raise AssertionError("; ".join(failures))


def build_report(build_s):
    """Phase 2's record: the build's wall time, each source's nvcc time,
    and ptxas's registers and spills per kernel instance; fails on any
    spill in B1's, B2's or B3's instances."""
    print(f"build: {build_s:.1f} s (0 if cached); nvcc per source "
          + ", ".join(f"{src} {s:.1f} s"
                      for src, s in sorted(_backend.build_seconds.items())))
    spills, recorded = [], []
    for section in _backend.build_log.split("--- ")[1:]:
        source, text = section.split("\n", 1)
        for fn, stack, stores, loads, regs in PTXAS_FUNCTION.findall(text):
            print(f"ptxas {source} {fn}: {regs} registers, {stack} bytes "
                  f"stack, {stores} bytes spill stores, {loads} bytes spill "
                  f"loads")
            if source in NO_SPILL_SOURCES and int(stores) + int(loads):
                (recorded if SPILL_RECORDED.search(fn) else spills).append(
                    f"{fn} ({stores} B stores, {loads} B loads)")
    print(f"B1 float64 instances that spill (recorded, not refused): "
          f"{recorded or 'none'}")
    if spills:
        raise AssertionError(f"ptxas spilled registers in {spills}")


def main() -> None:
    # 1. device
    dev = _backend.device()
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(dev)}")

    # Every fixture-held path runs on the numpy FVM assembly its fixture
    # was made on; phase 4o, after them, runs both routes.
    assembly = contextlib.ExitStack()
    assembly.enter_context(numpy_assembly())

    # 2. build
    t0 = time.perf_counter()
    _backend.kernel_library()
    build_report(time.perf_counter() - t0)

    # 2b. the host runtime: built, loaded, held against numpy
    check_host_runtime(card)

    # 3. kernels against their plain versions
    gj_err, gj_times = check_gauss_jordan(dev, card)
    dia_err, dia_times = check_dia_spmv(dev, card)
    bsr_err, bsr_times, bsr_ops = check_bsr_spmm(dev, card)

    # 3d. B1's float64 instance
    t0 = time.perf_counter()
    gj64_err, gj64_times = check_gauss_jordan_f64(dev, card)
    print(f"phase 3d (B1 float64): {time.perf_counter() - t0:.1f} s")

    # 3c. the roofline path
    roofline_launches = run_roofline_path(dev, card, bsr_ops)
    del bsr_ops

    # 4. the per-case main path
    fixture = json.loads(FIXTURE.read_text())
    t0 = time.perf_counter()
    cases = flagship_cases()
    print(f"generated {len(cases)} sludge cases in "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _backend.reset_launch_counts()
    suite = run_main_path(dev, results_directory=RESULTS, cases=cases)
    launches = _backend.launch_counts()["gauss_jordan"]
    hold_host("per-case", ("ic0", "levels"))
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
          f"{wall_s:.1f} s wall (split, plans, timing reps)")
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

    # 4k. incomplete_lu per case on the same split
    check_ilu_path(cases, card)

    # 4g. the conv families on the same split
    conv_launches = check_conv_path(cases, card)

    # 4f. training on the same generated cases; B1 at its shape
    train_launches, train_run = check_training_path(cases, card)
    gj_train_err, _ = check_gauss_jordan_training(train_run, card)
    gj_err = max(gj_err, gj_train_err)
    del train_run

    # 4h. the conv families' training on the same generated cases
    conv_train_launches = check_conv_training(cases, card)
    del cases

    # 4d. the batched protocol on the same split; B1 at its shape
    _, batched_launches = check_batched_path(suite, batched_fixture, card)
    gj_batched_err, _ = check_gauss_jordan_group(
        suite, card, "range", "the batched learned build", GJ_BATCHED_W)
    gj_err = max(gj_err, gj_batched_err)
    del suite

    # 4e. the irregular split per case, then batched (the dense learned
    # build); B1 at the dense build's shape
    t0 = time.perf_counter()
    irregular_cases = irregular.generate_irregular_cases()
    print(f"generated {len(irregular_cases)} irregular cases in "
          f"{time.perf_counter() - t0:.1f} s")
    _, irregular_launches = check_irregular_path(dev, batched_fixture, card,
                                                 irregular_cases)
    probe_suite, irregular_batched_launches, irregular_peak = (
        check_irregular_batched(dev, card, irregular_cases))
    del irregular_cases
    gj_dense_err, _ = check_gauss_jordan_group(
        probe_suite, card, "generic", "the dense learned build",
        GJ_BATCHED_W)
    gj_err = max(gj_err, gj_dense_err)
    del probe_suite

    # 4b. the structured-grid scaling path, its sequences and protocols
    scaling_launches = check_scaling_path(dev, card)
    check_bands_against_cpu(dev)
    protocol_launches = check_scaling_protocols(dev, card)

    # 4i. the structured family's training; B1 and B2 at its shapes
    struct_launches, _ = check_structured_training(dev, card)
    gj_struct_err, dia_struct_err, _ = check_structured_kernels(
        dev, card)
    gj_err = max(gj_err, gj_struct_err)
    dia_err = max(dia_err, dia_struct_err)

    # 4j. the matrix-free 256^3 solve
    large_launches = run_large_solve(card)

    # 4c. the frame-structure family, per case and batched
    frames_suite, frames_launches, frames_peak = check_frames_path(dev, card)
    generic = sorted(frames_suite.generic_cases["learned"])
    range_case = min(set(range(len(frames_suite.data_set))) - set(generic))
    gj_err = max(gj_err, check_gauss_jordan_frames(frames_suite, card,
                                                   range_case))
    for kind in ("range", "generic"):
        gj_err = max(gj_err, check_gauss_jordan_group(
            frames_suite, card, kind, "the frames batched learned build",
            GJ_FRAMES_W)[0])
    check_setup_against_cpu(frames_suite, frames.CHECKPOINT,
                            cases=(range_case, generic[0]))
    del frames_suite

    # 4l. the mesh-generalization study
    mesh_launches, mesh_peak = check_mesh_study(dev, card)
    gj_err = max(gj_err, check_gauss_jordan_mesh(dev, card)[0])
    print(f"peak memory on {card} (GiB, garbage collected first): frames "
          f"{frames_peak:.3f}, irregular batched {irregular_peak:.3f}, mesh "
          f"study {mesh_peak:.3f}")

    # 4m. residual parity, float64 and float32 (B1 at float64)
    t0 = time.perf_counter()
    parity_launches, gj64_launches = check_residual_parity(dev, card)
    print(f"phase 4m (residual parity): {time.perf_counter() - t0:.1f} s")

    # 4n. the sharded solver in an NCCL group of world size 1
    t0 = time.perf_counter()
    sharded_launches, gj_sharded_err, _ = check_sharded_solver(dev, card)
    gj_err = max(gj_err, gj_sharded_err)
    print(f"phase 4n (sharded solver): {time.perf_counter() - t0:.1f} s")

    # 4o. the generate stage on both assembly routes
    assembly.close()
    t0 = time.perf_counter()
    check_generate(card)
    print(f"phase 4o (generate stage): {time.perf_counter() - t0:.1f} s")

    # 5. records
    paths = {"per-case": {"gauss_jordan": launches},
             "train": train_launches, "conv": conv_launches,
             "conv-train": conv_train_launches,
             "batched": batched_launches, "irregular": irregular_launches,
             "irregular-batched": irregular_batched_launches,
             "meshes": mesh_launches,
             "scaling": scaling_launches, "roofline": roofline_launches,
             "frames": frames_launches,
             "scaling-protocols": protocol_launches,
             "structured-train": struct_launches,
             "large-solve": large_launches,
             "residual-parity": parity_launches,
             "sharded": sharded_launches}
    print("launches per path: " + "; ".join(
        f"{path} {counts}" for path, counts in paths.items()))
    print(f"B1 float64 launches on the residual-parity path: "
          f"{gj64_launches}")
    print("host runtime calls per path (no numpy fallback on any): "
          + "; ".join(f"{path} {counts}"
                      for path, counts in HOST_PATHS.items()))
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
        "name": "gauss_jordan_f64",
        "route": "cuda",
        "source": "deeppreconditioning_tpu_torch/csrc/gauss_jordan.cu",
        "replaces": "deeppreconditioning_tpu/ops/fsai.py:614",
        "launches": gj64_launches,
        "max_abs_err": gj64_err,
        **gj64_times[GJ64_MAIN_SHAPE],
    }, {
        "name": "dia_spmv",
        "route": "cuda",
        "source": "deeppreconditioning_tpu_torch/csrc/dia_spmv.cu",
        "replaces": "deeppreconditioning_tpu/ops/pallas_spmv.py:32",
        "launches": sum(c.get("dia_spmv", 0) for c in paths.values()),
        "max_abs_err": dia_err,
        **dia_times[B2_MAIN],
    }, {
        "name": "bsr_spmm",
        "route": "cuda",
        "source": "deeppreconditioning_tpu_torch/csrc/bsr_spmm.cu",
        "replaces": "deeppreconditioning_tpu/ops/pallas_bsr.py:69",
        "launches": sum(c.get("bsr_spmm", 0) for c in paths.values()),
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
