"""The multichip dry run: one step of every distributed path at world
size n.

    python -m deeppreconditioning_tpu_torch.dryrun [--device cpu]
    torchrun --nproc-per-node N -m deeppreconditioning_tpu_torch.dryrun

Counterpart of ``__graft_entry__.dryrun_multichip(n)``.  Started alone it
makes a process group of its own (world size 1); under ``torchrun`` it
reads env:// and each rank takes the card of its ``LOCAL_RANK`` (NCCL;
gloo with ``--device cpu``).  At the world's size n, in float32:

1.  a data-parallel train step of ``PreconditionerNet`` (channels (1, 8,
    16, 8, 1)) on a ``RandomSPDDataSet`` batch of n systems of dof 16
    (sparsity 0.9, seed 0), one case a rank, Adam at 1e-3;
1b. a data-parallel train step of ``NeuralFSAI`` (width 16) on a batch of
    n systems (seed 1) with its FSAI plans (power 2, the kind settled on
    the whole batch), ``pcg_loss`` over 4 steps, Adam at 1e-4 (B1 once on
    the rank's columns);
2.  the row-sharded PCG in halo mode with Jacobi on the tridiagonal
    system (-1, 2.5, -1) of 32 n rows (right-hand side standard normal,
    seed 0): relative residual of the gathered x below 1e-3;
3.  the exact sharded poly-FSAI apply (q = (0.9, 0.05), the factor on
    tril(|A|^2) of the tridiagonal system with diagonal 2 + 0.5 cos(i),
    32 n rows) in the sharded PCG, against the single-device PCG with
    the dense M = C q(B) q(B)^T C^T: iterations within 2, x within rtol
    1e-3 / atol 1e-5.

The reference asserts each train step's loss finite; here each step's
loss, the global batch's, is also held within 1e-5 (relative) of the
single-device loss of the whole batch at the same parameters, computed
on every rank before the step.  Rank 0 prints one JSON line of the
results; any failed check raises.
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import scipy.sparse as sp
import torch

from deeppreconditioning_tpu_torch.data.datasets import RandomSPDDataSet
from deeppreconditioning_tpu_torch.models import (
    PreconditionerNet,
    init_params,
    precond_net_specs,
)
from deeppreconditioning_tpu_torch.models import neural_fsai as nf
from deeppreconditioning_tpu_torch.ops.fsai import (
    fsai_factor_scipy,
    tril_power_pattern,
)
from deeppreconditioning_tpu_torch.parallel import multihost
from deeppreconditioning_tpu_torch.parallel.data_parallel import (
    broadcast_parameters,
    case_span,
)
from deeppreconditioning_tpu_torch.parallel.fsai import (
    build_sharded_fsai,
    make_fsai_poly_sharded_apply,
)
from deeppreconditioning_tpu_torch.parallel.partition import (
    pad_vector,
    shard_ell_rows,
)
from deeppreconditioning_tpu_torch.parallel.pcg import (
    diag_local,
    gather_vector,
    pcg_sharded,
)
from deeppreconditioning_tpu_torch.solvers.cg import (
    dense_matvec,
    ell_matvec,
    preconditioned_conjugate_gradient,
)
from deeppreconditioning_tpu_torch.sparse.ell import ELLMatrix
from deeppreconditioning_tpu_torch.train import trainer

LOSS_RTOL = 1e-5  # DP step loss against the single-device loss, float32
PCG_RESIDUAL = 1e-3
POLY_Q = (0.9, 0.05)


def _random_spd(n: int, seed: int, specs, device) -> RandomSPDDataSet:
    """``__graft_entry__._tiny_batch``'s data: n systems of dof 16."""
    return RandomSPDDataSet("train", dof=16, batch_size=n, specs=specs,
                            sparsity=0.9, length=max(2 * n, 4), seed=seed,
                            shuffle=False, device=device)


def _close(got: float, want: float, label: str) -> None:
    if not (math.isfinite(got)
            and abs(got - want) <= LOSS_RTOL * abs(want)):
        raise AssertionError(f"{label}: data-parallel loss {got} against "
                             f"the single-device {want}")


def conv_step(world) -> dict:
    """Step 1: the conv family's data-parallel step."""
    n, device = world.size, world.device
    channels = (1, 8, 16, 8, 1)
    ds = _random_spd(n, 0, precond_net_specs(channels), device)
    model = PreconditionerNet(channels=channels).to(device)
    init_params(model, torch.Generator().manual_seed(0))
    broadcast_parameters(model, world)
    with torch.no_grad():
        single = float(trainer.conv_loss(model, ds[0]))
    share = ds.share(0, case_span(n, world.rank, n))
    loss = float(trainer.train_step(
        model, trainer.adam(model, 1e-3), share, world=world, n_global=n))
    _close(loss, single, "conv step")
    return {"conv_loss": loss, "conv_single": single}


def fsai_step(world) -> dict:
    """Step 1b: the NeuralFSAI family's data-parallel step."""
    n, device = world.size, world.device
    ds = _random_spd(n, 1, None, device)
    provider = nf.FSAIPlanProvider(ds, power=2, width=16)
    batch = ds[0]
    kind = provider.settle(batch)
    model = nf.NeuralFSAI(width=16).to(device)
    nf.init_params(model, torch.Generator().manual_seed(0))
    broadcast_parameters(model, world)
    a_tril = batch.systems.to_dense()
    with torch.no_grad():
        plans = provider(0, batch)
        single = float(trainer.fsai_loss(
            model, plans, trainer._fsai_operands(
                plans, batch.features[:, :, 0], a_tril),
            a_tril, batch.right_hand_sides, "pcg_loss", 4))
    share = ds.share(0, case_span(n, world.rank, n))
    plans = provider(0, share)
    loss = float(trainer.fsai_train_step(
        model, trainer.adam(model, 1e-4), plans, share.features[:, :, 0],
        share.systems.to_dense(), share.right_hand_sides, "pcg_loss", 4,
        world=world, n_global=n))
    _close(loss, single, "NeuralFSAI step")
    return {"fsai_loss": loss, "fsai_single": single, "plan_kind": kind}


def _local(x: np.ndarray, world, rows: int) -> torch.Tensor:
    return torch.as_tensor(x[world.rank * rows:(world.rank + 1) * rows],
                           dtype=torch.float32, device=world.device)


def halo_pcg(world) -> dict:
    """Step 2: the sharded PCG in halo mode with Jacobi."""
    n = 32 * world.size
    a = sp.diags([-np.ones(n - 1), 2.5 * np.ones(n), -np.ones(n - 1)],
                 [-1, 0, 1]).tocsr()
    sharded = shard_ell_rows(ELLMatrix.from_scipy(a, dtype=torch.float32),
                             world.size)
    rng = np.random.default_rng(0)
    b = pad_vector(rng.standard_normal(n).astype(np.float32),
                   sharded.n_total)
    d = pad_vector((1.0 / a.diagonal()).astype(np.float32), sharded.n_total)
    rows = sharded.rows_per_shard
    res = pcg_sharded(
        world, sharded.shard(world.rank, world.device, torch.float32),
        _local(b, world, rows), _local(d, world, rows), diag_local,
        mode="halo", max_iter=256)
    x = gather_vector(res.x, world)[:n].double().cpu().numpy()
    resid = float(np.linalg.norm(a @ x - b[:n]) / np.linalg.norm(b[:n]))
    if not resid < PCG_RESIDUAL:
        raise AssertionError(f"sharded PCG residual {resid}")
    return {"pcg_iterations": int(res.iterations), "pcg_residual": resid}


def poly_fsai(world) -> dict:
    """Step 3: the exact sharded poly-FSAI apply against the dense M."""
    n, device = 32 * world.size, world.device
    a = sp.diags([-np.ones(n - 1), 2.0 + 0.5 * np.cos(np.arange(n)),
                  -np.ones(n - 1)], [-1, 0, 1]).tocsr()
    tril = sp.tril(a).tocoo()
    pr, pc = tril_power_pattern(tril.row.astype(np.int32),
                                tril.col.astype(np.int32), n, power=2)
    c_sp = fsai_factor_scipy(a, pr, pc).tocsc()
    ell = ELLMatrix.from_scipy(a, dtype=torch.float32)
    n_pad = ell.n_pad
    rng = np.random.default_rng(0)
    rng.standard_normal(n)  # step 2's draw: the reference's one stream
    b = pad_vector(rng.standard_normal(n).astype(np.float32), n_pad)

    c_d = c_sp.toarray()
    qb = POLY_Q[0] * np.eye(n) + POLY_Q[1] * (c_d.T @ a.toarray() @ c_d)
    m_dense = np.zeros((n_pad, n_pad), np.float32)
    m_dense[:n, :n] = c_d @ qb @ qb.T @ c_d.T
    single = preconditioned_conjugate_gradient(
        ell_matvec, ELLMatrix.from_scipy(a, dtype=torch.float32,
                                         device=device),
        torch.as_tensor(b, device=device), dense_matvec,
        torch.as_tensor(m_dense, device=device))

    sharded = shard_ell_rows(ell, world.size)
    w = int(np.diff(c_sp.indptr).max())
    out_rows = np.full((n_pad, w), n_pad, np.int64)
    c_vals = np.zeros((n_pad, w))
    for j in range(n):
        lo, hi = c_sp.indptr[j], c_sp.indptr[j + 1]
        out_rows[j, :hi - lo] = c_sp.indices[lo:hi]
        c_vals[j, :hi - lo] = c_sp.data[lo:hi]
    sf = build_sharded_fsai(out_rows, c_vals, world.size,
                            n_total=sharded.n_total)
    a_shard = sharded.shard(world.rank, device, torch.float32)
    m_data = sf.shard(world.rank, device, torch.float32)
    m_data.update(q=torch.tensor(POLY_Q, dtype=torch.float32, device=device),
                  a=a_shard)
    rows = sharded.rows_per_shard
    res = pcg_sharded(world, a_shard,
                      _local(pad_vector(b, sharded.n_total), world, rows),
                      m_data, make_fsai_poly_sharded_apply(world, 1),
                      mode="halo")
    x = gather_vector(res.x, world)[:n].cpu().numpy()
    x_single = single.x[:n].cpu().numpy()
    its, its_single = int(res.iterations), int(single.iterations)
    if abs(its - its_single) > 2:
        raise AssertionError(f"sharded poly-FSAI iterations {its}, single "
                             f"device {its_single}")
    np.testing.assert_allclose(x, x_single, rtol=1e-3, atol=1e-5)
    return {"poly_iterations": its, "poly_single_iterations": its_single,
            "poly_x_max_diff": float(np.abs(x - x_single).max())}


def run(world) -> dict:
    """Steps 1, 1b, 2 and 3 on this rank; returns their results."""
    return {"world_size": world.size, **conv_step(world),
            **fsai_step(world), **halo_pcg(world), **poly_fsai(world)}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        prog="python -m deeppreconditioning_tpu_torch.dryrun")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    device = multihost.rank_device(args.device)  # the card, or raise
    started = False
    if not torch.distributed.is_initialized():
        if not multihost.initialize_if_needed(device):
            multihost.initialize_single(device)
        started = True
    try:
        world = multihost.train_world(device)
        result = run(world)
        if world.rank == 0:
            print(json.dumps(result), flush=True)
        return result
    finally:
        if started:
            multihost.shutdown()


if __name__ == "__main__":
    main()
