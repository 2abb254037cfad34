"""Settings from ``params.yaml`` without a YAML library.

Counterpart of ``deeppreconditioning_tpu/config.py::params_show``, cut to
the keys the port reads: the benchmark's (model, number_samples,
mesh_cells, checkpoint_dir) and the trainer's (batch_size,
learning_rate, patience, seed, fsai_width, fsai_power, data_root).
``params.yaml`` keeps these as flat ``key: value`` lines; list values
(``channels``) and nested blocks belong to the conv families and are
skipped.  Each value takes the type of its default (so ``learning_rate``
is a float).  ``fsai_width`` and ``fsai_power`` are extra keys in the
reference; their defaults here are ``scripts/train_fsai.py``'s
fallbacks.  The reference's ``max_epochs`` and ``metrics_dir`` are not
read: the port's train entry point runs one epoch unless told otherwise
and keeps its metrics beside its own checkpoints.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

DEFAULT_PARAMS = {
    "model": "PreconditionerNet",
    "number_samples": 500,
    "mesh_cells": 2,
    "checkpoint_dir": "assets/checkpoints",
    "batch_size": 4,
    "learning_rate": 0.001,
    "patience": 16,
    "seed": 69,
    "fsai_width": 16,
    "fsai_power": 3,
    "data_root": "assets/data/raw",
}


@dataclass
class Params:
    model: str
    number_samples: int
    mesh_cells: int
    checkpoint_dir: str
    batch_size: int
    learning_rate: float
    patience: int
    seed: int
    fsai_width: int
    fsai_power: int
    data_root: str


def params_show(path: str | Path = "params.yaml") -> Params:
    """Read the flat ``key: value`` lines of ``path`` over the defaults."""
    merged = dict(DEFAULT_PARAMS)
    p = Path(path)
    if p.exists():
        for line in p.read_text().splitlines():
            line = line.split("#", 1)[0].rstrip()
            if not line or line[0] in " \t-" or ":" not in line:
                continue
            key, value = (s.strip() for s in line.split(":", 1))
            if key in merged and value:
                merged[key] = type(DEFAULT_PARAMS[key])(value)
    return Params(**merged)
