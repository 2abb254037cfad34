"""Settings from ``params.yaml`` without a YAML library.

Counterpart of ``deeppreconditioning_tpu/config.py::params_show``, cut to
the keys the port reads: the benchmark's (model, data, number_samples,
mesh_cells, channels, checkpoint_dir) and the trainer's
(batch_size, learning_rate, patience, loss, schedule, seed, fsai_width,
fsai_power, data_root).  ``params.yaml`` keeps these as flat ``key: value`` lines,
``channels`` as a block list (``- 16`` lines under ``channels:``); other
blocks are skipped.  Each value takes the type of its default (so
``learning_rate`` is a float, a ``channels`` entry an int).
``params_flat`` reads every key of those lines (``repro``'s stage
records).  ``get_model_class`` / ``get_dataset_class`` select a class by
its name,
as the reference's.  ``fsai_width`` and ``fsai_power`` are extra keys in the
reference; their defaults here are ``scripts/train_fsai.py``'s
fallbacks.  The reference's ``max_epochs`` and ``metrics_dir`` are not
read: the port's train entry point runs one epoch unless told otherwise
and keeps its metrics beside its own checkpoints.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import List

DEFAULT_PARAMS = {
    "model": "PreconditionerNet",
    "data": "SludgePatternDataSet",
    "number_samples": 500,
    "mesh_cells": 2,
    "channels": [1, 16, 32, 64, 32, 16, 1],
    "checkpoint_dir": "assets/checkpoints",
    "batch_size": 4,
    "learning_rate": 0.001,
    "patience": 16,
    "loss": "inverse_loss",
    "schedule": "constant",
    "seed": 69,
    "fsai_width": 16,
    "fsai_power": 3,
    "data_root": "assets/data/raw",
}


@dataclass
class Params:
    model: str
    data: str
    number_samples: int
    mesh_cells: int
    channels: List[int]
    checkpoint_dir: str
    batch_size: int
    learning_rate: float
    patience: int
    loss: str
    schedule: str
    seed: int
    fsai_width: int
    fsai_power: int
    data_root: str


def params_show(path: str | Path = "params.yaml") -> Params:
    """Read the flat ``key: value`` lines and the ``channels`` list of
    ``path`` over the defaults."""
    merged = dict(DEFAULT_PARAMS, channels=list(DEFAULT_PARAMS["channels"]))
    p = Path(path)
    listing = None  # the list key whose ``- item`` lines follow
    if p.exists():
        for line in p.read_text().splitlines():
            line = line.split("#", 1)[0].rstrip()
            if listing is not None and line.startswith("- "):
                merged[listing].append(int(line[2:].strip()))
                continue
            listing = None
            if not line or line[0] in " \t-" or ":" not in line:
                continue
            key, value = (s.strip() for s in line.split(":", 1))
            if key not in merged:
                continue
            if isinstance(DEFAULT_PARAMS[key], list):
                if not value:
                    merged[key], listing = [], key
            elif value:
                merged[key] = type(DEFAULT_PARAMS[key])(value)
    return Params(**merged)


def _scalar(text: str):
    """A ``key: value`` line's value as int, float or string."""
    for kind in (int, float):
        try:
            return kind(text)
        except ValueError:
            pass
    return text


def params_flat(path: str | Path = "params.yaml") -> dict:
    """Every flat ``key: value`` of ``path`` (int, float or string, as
    the text reads) and every block list of ``- item`` lines, in file
    order; nothing for a missing file."""
    out: dict = {}
    p = Path(path)
    if not p.exists():
        return out
    listing = None
    for line in p.read_text().splitlines():
        line = line.split("#", 1)[0].rstrip()
        if listing is not None and line.startswith("- "):
            out[listing].append(_scalar(line[2:].strip()))
            continue
        listing = None
        if not line or line[0] in " \t-" or ":" not in line:
            continue
        key, value = (s.strip() for s in line.split(":", 1))
        if value:
            out[key] = _scalar(value)
        else:
            out[key], listing = [], key
    return out


def get_model_class(name: str):
    """Model class by name (``models``' exports)."""
    import deeppreconditioning_tpu_torch.models as models

    return getattr(models, name)


def get_dataset_class(name: str):
    """Dataset class by name (``data.datasets``' classes)."""
    import deeppreconditioning_tpu_torch.data.datasets as datasets

    return getattr(datasets, name)
