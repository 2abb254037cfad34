"""Training loops of the sparse-conv and NeuralFSAI model families.

Counterpart of ``deeppreconditioning_tpu/train/trainer.py``.  The conv
half: ``_make_l_coo``, ``conv_loss`` (the reference's
``_loss_from_batch``, all five losses), ``train_step``,
``_validate_device``, ``validate`` and ``train`` (Adam at a constant or
warmup-cosine rate, ``init_from``, selection by validation loss or
iterations).  The NeuralFSAI half: ``_fsai_operands``,
``fsai_train_step``, ``_fsai_validate_device`` and ``train_neural_fsai``.
Both trainers run one epoch loop (``_fit``: early stopping on the
validation criterion, ``latest`` / ``best`` checkpoints in Flax msgpack,
the four metric series under the reference's names); ``resume_state``
restores either family's checkpoint.

The optimizer is ``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)``,
optax ``adam``'s update: bias-corrected moments, eps added to the square
root of the second one.  A scheduled rate is set on the optimizer before
each step from the step count, as optax evaluates its schedule at the
count before the update.  The train steps are eager.  The conv forward is
the gather-GEMM of ``ops/sparse_conv`` (its backward is autograd's: a
scatter-add); no hand-written kernel runs on the conv path, as no Pallas
kernel runs on the reference's.  The NeuralFSAI forward's local solves
launch kernel B1 once per batch (every column of every case).  The dense
products (L L^T, M, the unrolled PCG of ``pcg_loss``, the backward) are
full-float32 ``torch.matmul`` on the card.  Validation solves the batch
with the batched PCG and a dense M (``max_iter`` 1024).

The reference's ``mesh`` argument (data-parallel training over a device
mesh, ``dp_shard``) has no counterpart yet: it waits for the port's
``parallel/`` package.
"""

from __future__ import annotations

import math
import time
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

from deeppreconditioning_tpu_torch import _backend
from deeppreconditioning_tpu_torch import metrics as metrics_lib
from deeppreconditioning_tpu_torch.models import (
    CONV_MODELS,
    conv_params_from_jax,
    conv_params_to_jax,
)
from deeppreconditioning_tpu_torch.models import neural_fsai as nf
from deeppreconditioning_tpu_torch.models.neural_fsai import (
    batched_dense_factor,
    batched_dense_m,
)
from deeppreconditioning_tpu_torch.models.precond_net import (
    init_params as init_conv_params,
    output_to_dense,
)
from deeppreconditioning_tpu_torch.ops.fsai import RangeFSAIPlan
from deeppreconditioning_tpu_torch.solvers.cg import (
    batched_preconditioned_conjugate_gradient,
)
from deeppreconditioning_tpu_torch.sparse.coo import BatchedCOO
from deeppreconditioning_tpu_torch.train.checkpoint import (
    adam_state_from_jax,
    adam_state_to_jax,
    load_checkpoint,
    save_checkpoint,
)
from deeppreconditioning_tpu_torch.utils.logging import MetricsLogger

FSAI_LOSSES = ("pcg_loss", "inverse_loss", "kaporin_loss")
CONV_LOSSES = ("inverse_loss", "frobenius_loss", "hutchinson_trace",
               "condition_loss", "pcg_loss")


class TrainState(NamedTuple):
    model: torch.nn.Module
    optimizer: torch.optim.Adam
    step: int
    epochs: list  # one record per epoch (``_fit``)


class EarlyStopping:
    """Patience counter on the validation criterion."""

    def __init__(self, patience: int = 16, min_delta: float = 0.0) -> None:
        self.patience = patience
        self.min_delta = min_delta
        self.best = float("inf")
        self.counter = 0

    def __call__(self, val_loss: float) -> bool:
        if val_loss < self.best - self.min_delta:
            self.best = val_loss
            self.counter = 0
            return False
        self.counter += 1
        return self.counter >= self.patience


def adam(model: torch.nn.Module, learning_rate: float) -> torch.optim.Adam:
    """optax ``adam(learning_rate)``'s counterpart."""
    return torch.optim.Adam(model.parameters(), lr=learning_rate,
                            betas=(0.9, 0.999), eps=1e-8)


def _bmv(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (a @ x[..., None])[..., 0]


# -- the sparse-conv families -------------------------------------------------


def warmup_cosine_decay(init_value: float, peak_value: float,
                        warmup_steps: int, decay_steps: int,
                        end_value: float) -> Callable[[int], float]:
    """optax ``warmup_cosine_decay_schedule``: linear from ``init_value``
    to ``peak_value`` over ``warmup_steps``, then a cosine decay to
    ``end_value`` over the rest of ``decay_steps`` (which includes the
    warmup), then ``end_value``."""
    cosine_steps = decay_steps - warmup_steps
    if not cosine_steps > 0:
        raise ValueError("the cosine schedule needs decay_steps > "
                         f"warmup_steps, got {decay_steps} <= {warmup_steps}")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - max(count, 0) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, cosine_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / cosine_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def _make_l_coo(values: torch.Tensor, final_plan, n: int) -> BatchedCOO:
    """Batched model output -> ``BatchedCOO`` of L at the final plan's
    sites (for ``frobenius_loss``)."""
    bsz, nnz = values.shape
    batch_idx = torch.arange(bsz, device=values.device)[:, None].expand(
        bsz, nnz)
    indices = torch.stack([batch_idx, final_plan.rows, final_plan.cols],
                          dim=-1).reshape(bsz * nnz, 3)
    return BatchedCOO(indices=indices, values=values.reshape(bsz * nnz),
                      valid=final_plan.valid.reshape(bsz * nnz),
                      batch_size=bsz, spatial_shape=(n, n))


def conv_loss(model, batch, loss: str = "inverse_loss",
              generator: torch.Generator | None = None,
              probes: torch.Tensor | None = None) -> torch.Tensor:
    """The training objective of a conv model by name, on a
    ``DeviceBatch`` with plans: ``frobenius_loss`` on the sparse L,
    ``pcg_loss`` (16 unrolled PCG steps with M = L L^T),
    ``inverse_loss``, ``hutchinson_trace`` (probes from ``generator``, or
    ``probes``) or ``condition_loss`` on the dense L."""
    if loss not in CONV_LOSSES:
        raise ValueError(f"unknown loss {loss}")
    values = model(batch.features, batch.plans)
    n = batch.solutions.shape[1]
    if loss == "frobenius_loss":
        l_coo = _make_l_coo(values, batch.plans[-1], n)
        return metrics_lib.frobenius_loss(l_coo, batch.solutions,
                                          batch.right_hand_sides)
    l_dense = output_to_dense(values, batch.plans[-1], n)
    a_tril = batch.systems.to_dense()
    if loss == "pcg_loss":
        return metrics_lib.pcg_residual_loss(
            a_tril, l_dense @ l_dense.mT, batch.right_hand_sides)
    if loss == "inverse_loss":
        return metrics_lib.inverse_loss(a_tril, l_dense)
    if loss == "hutchinson_trace":
        return metrics_lib.hutchinson_trace(a_tril, l_dense,
                                            generator=generator,
                                            probes=probes)
    return metrics_lib.condition_loss(a_tril, l_dense)


def train_step(model, optimizer: torch.optim.Optimizer, batch,
               loss: str = "inverse_loss",
               generator: torch.Generator | None = None,
               probes: torch.Tensor | None = None) -> torch.Tensor:
    """One optimization step of a conv model (forward, loss, backward,
    Adam); returns the loss at the parameters before the update,
    detached."""
    optimizer.zero_grad(set_to_none=True)
    value = conv_loss(model, batch, loss, generator, probes)
    value.backward()
    optimizer.step()
    return value.detach()


@torch.no_grad()
def _validate_device(model, batch, max_iter: int = 1024):
    """Validation of one batch: the inverse loss and the per-case PCG
    iterations on the symmetrized A~ with M = L L^T -> (loss, iterations
    (B,))."""
    values = model(batch.features, batch.plans)
    l_dense = output_to_dense(values, batch.plans[-1],
                              batch.solutions.shape[1])
    a_tril = batch.systems.to_dense()
    loss = metrics_lib.inverse_loss(a_tril, l_dense)
    res = batched_preconditioned_conjugate_gradient(
        _bmv, metrics_lib.symmetrize_tril(a_tril), batch.right_hand_sides,
        _bmv, l_dense @ l_dense.mT, max_iter=max_iter)
    return loss, res.iterations


def validate_conv(model, val_set, max_iter: int = 1024):
    """Validation of a conv model over ``val_set`` -> (per-batch losses,
    per-case iterations, seconds per batch)."""
    losses, iters = [], []
    start = time.perf_counter()
    for i in range(len(val_set)):
        loss, its = _validate_device(model, val_set[i], max_iter=max_iter)
        losses.append(float(loss))
        iters.extend(its.cpu().tolist())
    seconds = (time.perf_counter() - start) / max(len(val_set), 1)
    return losses, iters, seconds


def validate(model, dataset, max_iter: int = 1024):
    """The reference's ``validate``: (mean loss, mean iterations, mean
    seconds per batch)."""
    losses, iters, seconds = validate_conv(model, dataset, max_iter)
    return float(np.mean(losses)), float(np.mean(iters)), seconds


# -- the NeuralFSAI family ----------------------------------------------------


def _fsai_operands(plans, feats: torch.Tensor,
                   a_tril: torch.Tensor) -> torch.Tensor:
    """The model operand per plan kind: the dense scaled A~ for range
    plans, the tril value vectors otherwise."""
    if isinstance(plans, RangeFSAIPlan):
        return metrics_lib.symmetrize_tril(a_tril)
    return feats


def fsai_loss(model, plans, operands: torch.Tensor, a_tril: torch.Tensor,
              rhs: torch.Tensor | None, loss: str = "inverse_loss",
              pcg_steps: int = 16) -> torch.Tensor:
    """The training objective by name: ``pcg_loss`` (unrolled PCG residual
    with M = C q(B) q(B)^T C^T), ``kaporin_loss`` or ``inverse_loss`` (on
    the dense factor C)."""
    out = model(plans, operands)
    if loss == "pcg_loss":
        a_full = metrics_lib.symmetrize_tril(a_tril)
        m = batched_dense_m(plans, out, a_full)
        return metrics_lib.pcg_residual_loss(a_tril, m, rhs,
                                             k_steps=pcg_steps)
    if loss not in FSAI_LOSSES:
        raise ValueError(f"unsupported NeuralFSAI loss {loss}")
    c_dense = batched_dense_factor(plans, out.c_vals)
    if loss == "kaporin_loss":
        return metrics_lib.kaporin_loss(a_tril, c_dense)
    return metrics_lib.inverse_loss(a_tril, c_dense)


def fsai_train_step(model, optimizer: torch.optim.Optimizer, plans,
                    feats: torch.Tensor, a_tril: torch.Tensor,
                    rhs: torch.Tensor | None = None,
                    loss: str = "inverse_loss",
                    pcg_steps: int = 16) -> torch.Tensor:
    """One optimization step (forward, loss, backward, Adam); returns the
    loss at the parameters before the update, detached."""
    operands = _fsai_operands(plans, feats, a_tril)
    optimizer.zero_grad(set_to_none=True)
    value = fsai_loss(model, plans, operands, a_tril, rhs, loss, pcg_steps)
    value.backward()
    optimizer.step()
    return value.detach()


@torch.no_grad()
def _fsai_validate_device(model, plans, feats: torch.Tensor,
                          a_tril: torch.Tensor,
                          right_hand_sides: torch.Tensor,
                          max_iter: int = 1024):
    """Validation of one batch: the mean ||M A~ - I||_F and the per-case
    PCG iterations on the scaled systems -> (loss, iterations (B,))."""
    operands = _fsai_operands(plans, feats, a_tril)
    out = model(plans, operands)
    a_full = metrics_lib.symmetrize_tril(a_tril)
    m = batched_dense_m(plans, out, a_full)
    eye = torch.eye(a_full.shape[-1], dtype=a_full.dtype,
                    device=a_full.device)[None]
    loss = torch.sqrt(((m @ a_full - eye) ** 2).sum(dim=(1, 2))).mean()
    res = batched_preconditioned_conjugate_gradient(
        _bmv, a_full, right_hand_sides, _bmv, m, max_iter=max_iter)
    return loss, res.iterations


def validate_fsai(model, val_set, plan_provider, max_iter: int = 1024):
    """Validation over ``val_set`` -> (per-batch losses, per-case
    iterations, seconds per batch)."""
    losses, iters = [], []
    start = time.perf_counter()
    for i in range(len(val_set)):
        batch = val_set[i]
        plans = plan_provider(i, batch)
        vl, vi = _fsai_validate_device(
            model, plans, batch.features[:, :, 0], batch.systems.to_dense(),
            batch.right_hand_sides, max_iter=max_iter)
        losses.append(float(vl))
        iters.extend(vi.cpu().tolist())
    seconds = (time.perf_counter() - start) / max(len(val_set), 1)
    return losses, iters, seconds


# -- checkpoints --------------------------------------------------------------


def _param_names(model) -> dict:
    return {p: name for name, p in model.named_parameters()}


def _trees(model):
    """The family's (params_to_jax, params_from_jax) pair."""
    if isinstance(model, CONV_MODELS):
        return conv_params_to_jax, conv_params_from_jax
    return nf.params_to_jax, nf.params_from_jax


def checkpoint_payload(model, optimizer, step: int, scheduled: bool = False,
                       **settings) -> dict:
    """The trainer's checkpoint tree: params and optax-layout Adam state
    (Flax's layout; ``scheduled``: the schedule's count beside it), step,
    and the family's ``settings`` (``channels`` for a conv model, as the
    reference's ``save_checkpoint``; width, hidden, poly_degree and power
    for NeuralFSAI)."""
    to_tree = _trees(model)[0]
    return {
        "params": to_tree(model.state_dict()),
        "opt_state": adam_state_to_jax(optimizer, _param_names(model),
                                       to_tree, scheduled),
        "step": int(step),
        **settings,
    }


def load_params(model, payload: dict) -> None:
    """Copy a checkpoint's params into ``model`` (its dtype and device)."""
    state = _trees(model)[1](payload["params"])
    ref = next(model.parameters())
    model.load_state_dict({k: v.to(ref) for k, v in state.items()})


def resume_state(path: Path, model, optimizer: torch.optim.Adam) -> int:
    """Load a checkpoint (the port's or the reference's, either family)
    into ``model`` and ``optimizer`` for an exact resume; returns its
    step."""
    payload = load_checkpoint(Path(path))
    load_params(model, payload)
    adam_state_from_jax(optimizer, _param_names(model), payload["opt_state"],
                        _trees(model)[1])
    return int(payload["step"])


# -- the epoch loop -----------------------------------------------------------


def _launches() -> int:
    return _backend.launch_counts()["gauss_jordan"]


def _fit(model, optimizer, train_set, val_set, step_fn, validate_fn,
         payload_fn, patience: int, max_epochs: int, checkpoint_dir: Path,
         metrics_dir: Path, select_by: str, validate_init: bool,
         on_epoch: Callable[[dict], None] | None,
         prepare_fn: Callable | None = None) -> TrainState:
    """The epoch loop both families share: ``prepare_fn(i, batch)`` makes
    train batch ``i``'s step inputs (default: the batch) outside the timed
    step, ``step_fn(inputs, step)`` takes one step and returns its loss,
    ``validate_fn(val_set)`` gives (per-batch losses, per-case iterations,
    seconds per batch), ``payload_fn(step)`` the checkpoint tree.  Each
    epoch logs the four series, writes ``latest.msgpack`` and, when the
    criterion (``select_by``: validation "loss" or mean "iterations")
    improves, ``best.msgpack``; training stops after ``patience`` epochs
    without improvement.  ``on_epoch`` receives each epoch's record: the
    per-step losses and seconds (step only, synchronized), the summed
    seconds of ``prepare_fn``, the train and
    validation losses, the per-case validation iterations, the epoch's
    seconds and its B1 launches.  ``validate_init`` first validates the
    starting parameters and passes that record as epoch -1 (it is not
    logged, and is the first of the returned records)."""
    logger = MetricsLogger(metrics_dir)
    stopper = EarlyStopping(patience=patience)
    best_val = float("inf")
    step, epochs = 0, []

    if validate_init:
        b1_before = _launches()
        v_losses, v_iters, val_duration = validate_fn(val_set)
        epochs.append({
            "epoch": -1, "step": 0, "val_loss": float(np.mean(v_losses)),
            "val_losses": v_losses, "val_iterations": v_iters,
            "val_mean_iterations": float(np.mean(v_iters)),
            "val_seconds_per_batch": val_duration,
            "b1_launches": _launches() - b1_before,
        })
        if on_epoch is not None:
            on_epoch(epochs[-1])

    for epoch in range(max_epochs):
        t_epoch = time.perf_counter()
        b1_before = _launches()
        step_losses, step_seconds, prepare_seconds = [], [], 0.0
        for i in range(len(train_set)):
            batch = train_set[i]
            t0 = time.perf_counter()
            inputs = batch if prepare_fn is None else prepare_fn(i, batch)
            prepare_seconds += time.perf_counter() - t0
            t0 = time.perf_counter()
            step_losses.append(float(step_fn(inputs, step)))
            step_seconds.append(time.perf_counter() - t0)
            step += 1
        train_loss = float(np.mean(step_losses))

        v_losses, v_iters, val_duration = validate_fn(val_set)
        val_loss = float(np.mean(v_losses))
        val_iters = float(np.mean(v_iters))
        logger.log_metric("train/loss/inverse", train_loss)
        logger.log_metric("val/loss/inverse", val_loss)
        logger.log_metric("val/metric/durations", val_duration)
        logger.log_metric("val/metric/iterations", val_iters)
        logger.next_step()

        save_checkpoint(checkpoint_dir / "latest.msgpack", payload_fn(step))
        criterion = val_iters if select_by == "iterations" else val_loss
        if criterion < best_val:
            best_val = criterion
            save_checkpoint(checkpoint_dir / "best.msgpack",
                            payload_fn(step))
        record = {
            "epoch": epoch, "step": step, "step_losses": step_losses,
            "step_seconds": step_seconds, "prepare_seconds": prepare_seconds,
            "train_loss": train_loss,
            "val_loss": val_loss, "val_losses": v_losses,
            "val_iterations": v_iters, "val_mean_iterations": val_iters,
            "val_seconds_per_batch": val_duration,
            "seconds": time.perf_counter() - t_epoch,
            "b1_launches": _launches() - b1_before,
        }
        epochs.append(record)
        if on_epoch is not None:
            on_epoch(record)
        # early-stop on the criterion that picks best.msgpack
        if stopper(criterion):
            break

    logger.close()
    return TrainState(model, optimizer, step, epochs)


def train(
    model,
    train_set,
    val_set,
    learning_rate: float = 1e-3,
    patience: int = 16,
    max_epochs: int = 10_000,
    checkpoint_dir: Path | str = Path("assets/results/torch/train"),
    metrics_dir: Path | str = Path("assets/results/torch/train/metrics"),
    seed: int = 69,
    loss: str = "inverse_loss",
    schedule: str = "constant",
    warmup_epochs: int = 5,
    select_by: str = "loss",
    init_from: Path | str | None = None,
    on_epoch: Callable[[dict], None] | None = None,
) -> TrainState:
    """Train a conv model (already on the batches' device and dtype) on
    ``train_set``, validating on ``val_set`` every epoch (the reference's
    ``train``; the loop is ``_fit``'s).

    The parameters start from ``init_params`` drawn from
    ``torch.Generator().manual_seed(seed)``, or from the params of the
    checkpoint ``init_from`` (fresh optimizer).  ``schedule`` "constant"
    keeps ``learning_rate``; "cosine" is optax's
    ``warmup_cosine_decay_schedule(lr / 10, lr, warmup_epochs * steps,
    max_epochs * steps, lr / 100)`` with ``steps`` the batches per epoch.
    ``hutchinson_trace`` draws its probes from a generator seeded 0 on the
    model's device.  The validation loss is ``inverse_loss`` whatever
    ``loss`` trains, and the epoch's mean train loss is logged as
    ``train/loss/inverse`` whatever its name.  Checkpoints hold the reference's ``save_checkpoint``
    payload (params, the optax Adam state, step, channels).
    """
    if loss not in CONV_LOSSES:
        raise ValueError(f"unknown loss {loss}")
    checkpoint_dir = Path(checkpoint_dir)
    if schedule == "cosine":
        steps = max(len(train_set), 1)
        rate = warmup_cosine_decay(learning_rate / 10, learning_rate,
                                   warmup_epochs * steps, max_epochs * steps,
                                   learning_rate / 100)
    elif schedule == "constant":
        rate = None
    else:
        raise ValueError(f"unknown schedule {schedule}")
    init_conv_params(model, torch.Generator().manual_seed(seed))
    if init_from is not None:
        load_params(model, load_checkpoint(Path(init_from)))
    optimizer = adam(model, learning_rate)
    device = next(model.parameters()).device
    generator = (torch.Generator(device=device).manual_seed(0)
                 if loss == "hutchinson_trace" else None)

    def step_fn(batch, step):
        if rate is not None:
            for group in optimizer.param_groups:
                group["lr"] = rate(step)
        return train_step(model, optimizer, batch, loss, generator)

    return _fit(
        model, optimizer, train_set, val_set, step_fn,
        lambda val: validate_conv(model, val),
        lambda step: checkpoint_payload(
            model, optimizer, step, scheduled=rate is not None,
            # Flax stores a list as a map keyed "0", "1", ...
            channels={str(i): int(c) for i, c in enumerate(model.channels)}),
        patience, max_epochs, checkpoint_dir, Path(metrics_dir), select_by,
        validate_init=False, on_epoch=on_epoch)


def train_neural_fsai(
    model,
    train_set,
    val_set,
    plan_provider,
    learning_rate: float = 1e-3,
    patience: int = 16,
    max_epochs: int = 200,
    checkpoint_dir: Path | str = Path("assets/results/torch/train"),
    metrics_dir: Path | str = Path("assets/results/torch/train/metrics"),
    seed: int = 69,
    loss: str = "inverse_loss",
    pcg_steps: int = 16,
    select_by: str = "loss",
    init_from: Path | str | None = None,
    validate_init: bool = False,
    on_epoch: Callable[[dict], None] | None = None,
) -> TrainState:
    """Train ``model`` (already on the batches' device and dtype) on
    ``train_set``, validating on ``val_set`` every epoch (the loop is
    ``_fit``'s; its records count B1's launches).

    The parameters start from Flax's fresh initialization drawn from
    ``torch.Generator().manual_seed(seed)`` (``init_params``), or from the
    params of the checkpoint ``init_from`` (fresh optimizer).
    """
    nf.init_params(model, torch.Generator().manual_seed(seed))
    if init_from is not None:
        load_params(model, load_checkpoint(Path(init_from)))
    optimizer = adam(model, learning_rate)
    power = int(getattr(plan_provider, "power", 0))

    def step_fn(inputs, step):
        batch, plans = inputs
        return fsai_train_step(
            model, optimizer, plans, batch.features[:, :, 0],
            batch.systems.to_dense(), batch.right_hand_sides, loss, pcg_steps)

    return _fit(
        model, optimizer, train_set, val_set, step_fn,
        lambda val: validate_fsai(model, val, plan_provider),
        lambda step: checkpoint_payload(
            model, optimizer, step, width=model.width, hidden=model.hidden,
            poly_degree=model.poly_degree, power=power),
        patience, max_epochs, Path(checkpoint_dir), Path(metrics_dir),
        select_by, validate_init=validate_init, on_epoch=on_epoch,
        # a batch's first plan build stays out of the timed step
        prepare_fn=lambda i, batch: (batch, plan_provider(i, batch)))
