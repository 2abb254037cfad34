"""PyTorch / CUDA port of the learned-preconditioner framework.

Mirrors the module paths of ``deeppreconditioning_tpu`` (the JAX
reference, left unchanged beside it): every ported function keeps its
name and its relative file.  This package imports torch, numpy and scipy
only — never jax, flax or yaml — so it runs on a machine that has none of
them.

Layer map (entry point down to the card):
    bench/     per-case suite and its ``python -m`` entry point; the
               structured-grid scaling run and the SpMV roofline section
    train/     NeuralFSAI trainer and its ``python -m`` entry point; Flax
               msgpack checkpoints, read and written (no msgpack/flax)
    metrics    the training losses
    models/    NeuralFSAI as an ``nn.Module`` (local solves + MLP + wrap),
               the training batches' plan provider
    solvers/   chunked PCG (one host read per chunk), fixed-trip PCG
    ops/       FSAI range plans and setups; structured FSAI; geometric
               multigrid; the Gauss–Jordan (B1) and DIA SpMV (B2) wrappers
    sparse/    ELL, DIA, BSR and batched COO matrices
    data/      FVM sludge-pattern generator, host and training datasets,
               DIA Poisson
    utils/     timing and bounds; the metrics logger; CUDA-graph replay
    csrc/      hand-written CUDA kernels for sm_90a, built on first use
    _backend   device selection, kernel build/load, launch counters
"""

__version__ = "0.1.0"
