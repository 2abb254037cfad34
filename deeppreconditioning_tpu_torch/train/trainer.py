"""Training loop of the NeuralFSAI model family.

Counterpart of the NeuralFSAI half of
``deeppreconditioning_tpu/train/trainer.py``: ``EarlyStopping``,
``_fsai_operands``, ``fsai_train_step``, ``_fsai_validate_device`` and
``train_neural_fsai`` (Adam, early stopping on the validation criterion,
``latest`` / ``best`` checkpoints in Flax msgpack, the four metric
series), plus ``resume_state``.

The optimizer is ``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)``,
optax ``adam``'s update: bias-corrected moments, eps added to the square
root of the second one.  The train step is eager: the forward's local
solves launch kernel B1 once per batch (every column of every case), and
the dense products (M, the unrolled PCG of ``pcg_loss``, the backward) are
full-float32 ``torch.matmul`` on the card.  Validation solves the batch
with the batched PCG and a dense M (``max_iter`` 1024).

The reference's ``mesh`` argument (data-parallel training over a device
mesh, ``dp_shard``) has no counterpart yet: it waits for the port's
``parallel/`` package.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

from deeppreconditioning_tpu_torch import _backend
from deeppreconditioning_tpu_torch import metrics as metrics_lib
from deeppreconditioning_tpu_torch.models.neural_fsai import (
    batched_dense_factor,
    batched_dense_m,
    init_params,
    params_from_jax,
    params_to_jax,
)
from deeppreconditioning_tpu_torch.ops.fsai import RangeFSAIPlan
from deeppreconditioning_tpu_torch.solvers.cg import (
    batched_preconditioned_conjugate_gradient,
)
from deeppreconditioning_tpu_torch.train.checkpoint import (
    adam_state_from_jax,
    adam_state_to_jax,
    load_checkpoint,
    save_checkpoint,
)
from deeppreconditioning_tpu_torch.utils.logging import MetricsLogger

FSAI_LOSSES = ("pcg_loss", "inverse_loss", "kaporin_loss")


class TrainState(NamedTuple):
    model: torch.nn.Module
    optimizer: torch.optim.Adam
    step: int
    epochs: list  # one record per epoch (``train_neural_fsai``)


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


def _fsai_operands(plans, feats: torch.Tensor,
                   a_tril: torch.Tensor) -> torch.Tensor:
    """The model operand per plan kind: the dense scaled A~ for range
    plans, the tril value vectors otherwise."""
    if isinstance(plans, RangeFSAIPlan):
        return metrics_lib.symmetrize_tril(a_tril)
    return feats


def adam(model: torch.nn.Module, learning_rate: float) -> torch.optim.Adam:
    """optax ``adam(learning_rate)``'s counterpart."""
    return torch.optim.Adam(model.parameters(), lr=learning_rate,
                            betas=(0.9, 0.999), eps=1e-8)


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


def _bmv(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (a @ x[..., None])[..., 0]


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


def _param_names(model) -> dict:
    return {p: name for name, p in model.named_parameters()}


def checkpoint_payload(model, optimizer, step: int, power: int) -> dict:
    """The trainer's checkpoint tree: params and optax-layout Adam state
    (Flax's layout), step, width, hidden, poly_degree, power."""
    return {
        "params": params_to_jax(model.state_dict()),
        "opt_state": adam_state_to_jax(optimizer, _param_names(model),
                                       params_to_jax),
        "step": int(step),
        "width": model.width,
        "hidden": model.hidden,
        "poly_degree": model.poly_degree,
        "power": int(power),
    }


def load_params(model, payload: dict) -> None:
    """Copy a checkpoint's params into ``model`` (its dtype and device)."""
    state = params_from_jax(payload["params"])
    ref = next(model.parameters())
    model.load_state_dict({k: v.to(ref) for k, v in state.items()})


def resume_state(path: Path, model, optimizer: torch.optim.Adam) -> int:
    """Load a checkpoint (the port's or the reference's) into ``model``
    and ``optimizer`` for an exact resume; returns its step."""
    payload = load_checkpoint(Path(path))
    load_params(model, payload)
    adam_state_from_jax(optimizer, _param_names(model), payload["opt_state"],
                        params_from_jax)
    return int(payload["step"])


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
    ``train_set``, validating on ``val_set`` every epoch.

    The parameters start from Flax's fresh initialization drawn from
    ``torch.Generator().manual_seed(seed)`` (``init_params``), or from the
    params of the checkpoint ``init_from`` (fresh optimizer).  Each epoch
    logs the four series, writes ``latest.msgpack`` and, when the
    criterion (``select_by``: validation "loss" or mean "iterations")
    improves, ``best.msgpack``; training stops after ``patience`` epochs
    without improvement.  ``on_epoch`` receives each epoch's record: the
    per-step losses and seconds (step only, synchronized), the train and
    validation losses, the per-case validation iterations, the epoch's
    seconds and its B1 launches.  ``validate_init`` first validates the
    starting parameters and passes that record as epoch -1 (it is not
    logged, and is the first of the returned records).
    """
    checkpoint_dir = Path(checkpoint_dir)
    init_params(model, torch.Generator().manual_seed(seed))
    if init_from is not None:
        load_params(model, load_checkpoint(Path(init_from)))
    optimizer = adam(model, learning_rate)
    power = int(getattr(plan_provider, "power", 0))

    logger = MetricsLogger(metrics_dir)
    stopper = EarlyStopping(patience=patience)
    best_val = float("inf")
    step, epochs = 0, []

    def _ckpt(path):
        save_checkpoint(path, checkpoint_payload(model, optimizer, step,
                                                 power))

    if validate_init:
        b1_before = _backend.launch_counts()["gauss_jordan"]
        v_losses, v_iters, val_duration = validate_fsai(
            model, val_set, plan_provider)
        epochs.append({
            "epoch": -1, "step": 0, "val_loss": float(np.mean(v_losses)),
            "val_losses": v_losses, "val_iterations": v_iters,
            "val_mean_iterations": float(np.mean(v_iters)),
            "val_seconds_per_batch": val_duration,
            "b1_launches": (_backend.launch_counts()["gauss_jordan"]
                            - b1_before),
        })
        if on_epoch is not None:
            on_epoch(epochs[-1])

    for epoch in range(max_epochs):
        t_epoch = time.perf_counter()
        b1_before = _backend.launch_counts()["gauss_jordan"]
        step_losses, step_seconds = [], []
        for i in range(len(train_set)):
            batch = train_set[i]
            plans = plan_provider(i, batch)
            t0 = time.perf_counter()
            value = fsai_train_step(
                model, optimizer, plans, batch.features[:, :, 0],
                batch.systems.to_dense(), batch.right_hand_sides, loss,
                pcg_steps)
            step_losses.append(float(value))
            step_seconds.append(time.perf_counter() - t0)
            step += 1
        train_loss = float(np.mean(step_losses))

        v_losses, v_iters, val_duration = validate_fsai(
            model, val_set, plan_provider)
        val_loss = float(np.mean(v_losses))
        val_iters = float(np.mean(v_iters))
        logger.log_metric("train/loss/inverse", train_loss)
        logger.log_metric("val/loss/inverse", val_loss)
        logger.log_metric("val/metric/durations", val_duration)
        logger.log_metric("val/metric/iterations", val_iters)
        logger.next_step()

        _ckpt(checkpoint_dir / "latest.msgpack")
        criterion = val_iters if select_by == "iterations" else val_loss
        if criterion < best_val:
            best_val = criterion
            _ckpt(checkpoint_dir / "best.msgpack")
        record = {
            "epoch": epoch, "step": step, "step_losses": step_losses,
            "step_seconds": step_seconds, "train_loss": train_loss,
            "val_loss": val_loss, "val_losses": v_losses,
            "val_iterations": v_iters, "val_mean_iterations": val_iters,
            "val_seconds_per_batch": val_duration,
            "seconds": time.perf_counter() - t_epoch,
            "b1_launches": (_backend.launch_counts()["gauss_jordan"]
                            - b1_before),
        }
        epochs.append(record)
        if on_epoch is not None:
            on_epoch(record)
        # early-stop on the criterion that picks best.msgpack
        if stopper(criterion):
            break

    logger.close()
    return TrainState(model, optimizer, step, epochs)
