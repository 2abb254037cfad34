"""Preconditioner-generating models.

``PreconditionerNet`` and ``PreconditionerSparseUNet`` (the sparse-conv
families) and ``NeuralFSAI`` (``models.neural_fsai``).  ``plan_builder_for``
picks a conv family's dataset plan builder by model name, as the
reference's ``models/__init__.py``; ``conv_model_from_checkpoint`` carries
a conv checkpoint's parameter tree across, ``conv_params_to_jax`` /
``conv_params_from_jax`` map a conv ``state_dict`` to and from Flax's
variables tree (the trainer writes checkpoints with them), and
``init_params`` (``models.precond_net``) draws either family's fresh
parameters.
"""

from __future__ import annotations

import numpy as np
import torch

from deeppreconditioning_tpu_torch.models.neural_fsai import NeuralFSAI
from deeppreconditioning_tpu_torch.models.precond_net import (
    PreconditionerNet,
    init_params,
    precond_net_specs,
)
from deeppreconditioning_tpu_torch.models.sparse_unet import (
    PreconditionerSparseUNet,
    UNetPlanBuilder,
)

CONV_MODELS = (PreconditionerNet, PreconditionerSparseUNet)


def plan_builder_for(model_name: str, channels):
    """The dataset plan builder of a conv model class name."""
    if model_name == "PreconditionerSparseUNet":
        return UNetPlanBuilder()
    return precond_net_specs(channels)


def conv_params_to_jax(state: dict) -> dict:
    """A conv ``state_dict`` (or any map with its keys, such as an
    optimizer moment per parameter) -> Flax's variables
    ``{"params": {...}}`` with numpy leaves, keys in Flax's sorted
    order."""
    return {"params": {name: np.ascontiguousarray(
        state[name].detach().cpu().numpy()) for name in sorted(state)}}


def conv_params_from_jax(tree: dict) -> dict:
    """The inverse of ``conv_params_to_jax``: Flax's variables tree ->
    ``state_dict`` keys and CPU tensors."""
    return {name: torch.from_numpy(np.array(value))
            for name, value in tree["params"].items()}


def conv_model_from_checkpoint(model_name: str, payload: dict,
                               channels=None) -> torch.nn.Module:
    """A conv model of ``model_name`` with the payload's weights (float32):
    the checkpoint's ``{"params": {...}}`` leaves are the ``state_dict``,
    same names, same layouts; ``channels`` defaults to the payload's."""
    from deeppreconditioning_tpu_torch.config import get_model_class

    cls = get_model_class(model_name)
    if cls not in CONV_MODELS:
        raise ValueError(f"{model_name} is not a conv model")
    if channels is None:
        channels = [int(payload["channels"][str(i)])
                    for i in range(len(payload["channels"]))]
    model = cls(channels=tuple(channels))
    if set(payload["params"]["params"]) != set(model.state_dict()):
        raise ValueError(f"the checkpoint holds no {model_name} parameters")
    model.load_state_dict(conv_params_from_jax(payload["params"]))
    return model


__all__ = [
    "CONV_MODELS",
    "NeuralFSAI",
    "PreconditionerNet",
    "PreconditionerSparseUNet",
    "UNetPlanBuilder",
    "conv_model_from_checkpoint",
    "conv_params_from_jax",
    "conv_params_to_jax",
    "init_params",
    "plan_builder_for",
    "precond_net_specs",
]
