"""NeuralFSAI: FSAI local solves + learned refinement + polynomial wrap.

Counterpart of ``deeppreconditioning_tpu/models/neural_fsai.py``.  Three
parts:

1. FSAI base (``ops/fsai.range_fsai_columns`` on a range plan,
   ``ops/fsai.fsai_values_lookup`` on a generic ``FSAIPlan``): Kaporin-optimal
   column values from batched local solves (kernel B1 on the card).
2. Per-column refinement MLP over the features
   ``[c / max(|c_diag|, 1e-20), a_col, pos1h, pad]`` (4w inputs):
   ``c_ref = c * exp(alpha) + (1 - pos1h) * beta * c_diag``, masked by
   ``live = (out_rows < n_pad) * (1 - pad)``.
3. Learned polynomial wrap: q = e0 + q_coeffs (the stored delta), and
   M = C q(B) q(B)^T C^T with B = C^T A~ C: in Gram form on a range
   plan, through the dense factor C on a generic plan.

Flax's ``nn.gelu`` is the tanh approximation, hence
``nn.GELU(approximate="tanh")``.  ``params_from_jax`` maps a Flax
parameter tree onto this module's ``state_dict``.  The forward also takes
a group of plans (``ops/fsai.stack_plans``) with one operand per case,
the reference's vmapped ``model.apply`` of the batched protocol: one B1
launch for the whole group.  A generic plan's local blocks are always
looked up in the value vector, the reference's ``gather="lookup"`` form
(its default gather from the dense matrix gives the same values).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from deeppreconditioning_tpu_torch.ops.fsai import (
    FSAIPlan,
    fsai_dense_factor,
    fsai_dense_from_l0,
    fsai_values_lookup,
    poly_preconditioner_dense,
    poly_preconditioner_from_gram,
    range_fsai_columns,
    range_m_from_strips,
    range_strips,
)


class NeuralFSAIOut(NamedTuple):
    """Model output: refined factor columns + polynomial coefficients."""

    c_vals: torch.Tensor  # (n_pad, w) refined column values of C
    q_coeffs: torch.Tensor  # (poly_degree + 1,) coefficients of q


class NeuralFSAI(nn.Module):
    """FSAI base + refinement MLP + polynomial wrap (see module docstring).

    ``forward(plan, operand)`` takes a plan on the operand's device: a
    ``RangeFSAIPlan`` with the dense scaled symmetric matrix A~
    (n_pad, n_pad), or an ``FSAIPlan`` with the scaled tril value vector;
    or a group of such plans with the operands stacked, and then returns
    per-case outputs with a leading case axis.  With zero alpha/beta
    heads and q_coeffs it reproduces classical FSAI.
    """

    def __init__(self, width: int, hidden: int = 64,
                 poly_degree: int = 1) -> None:
        super().__init__()
        self.width = width
        self.hidden = hidden
        self.poly_degree = poly_degree
        self.dense0 = nn.Linear(4 * width, hidden)
        self.dense1 = nn.Linear(hidden, hidden)
        self.alpha = nn.Linear(hidden, width)
        self.beta = nn.Linear(hidden, width)
        for head in (self.alpha, self.beta):  # zero init: identity refine
            nn.init.zeros_(head.weight)
            nn.init.zeros_(head.bias)
        self.q_coeffs = nn.Parameter(torch.zeros(poly_degree + 1))
        self.act = nn.GELU(approximate="tanh")

    def forward(self, plan, operand: torch.Tensor) -> NeuralFSAIOut:
        w = self.width
        if plan.width != w:
            raise ValueError(f"plan width {plan.width} != model width {w}")
        columns = (fsai_values_lookup if isinstance(plan, FSAIPlan)
                   else range_fsai_columns)
        c, a_col = columns(plan, operand, with_aux=True)

        pad = plan.diag_pad.to(c.dtype)
        pos1h = torch.zeros_like(c).scatter_(-1, plan.pos[..., None], 1.0)
        c_diag = c.gather(-1, plan.pos[..., None])  # (..., n_pad, 1)
        denom = torch.clamp(c_diag.abs(), min=1e-20)
        feats = torch.cat([c / denom, a_col, pos1h, pad], dim=-1)

        h = self.act(self.dense0(feats))
        h = self.act(self.dense1(h))
        alpha = self.alpha(h)
        beta = self.beta(h)

        live = (plan.out_rows < plan.n_pad).to(c.dtype) * (1.0 - pad)
        refined = c * torch.exp(alpha) + (1.0 - pos1h) * beta * c_diag
        c_out = refined * live

        q0 = torch.zeros(self.poly_degree + 1, dtype=c.dtype, device=c.device)
        q0[0] = 1.0
        q = (q0 + self.q_coeffs).expand(*c.shape[:-2], self.poly_degree + 1)
        return NeuralFSAIOut(c_vals=c_out, q_coeffs=q)


def params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """Flax NeuralFSAI variables (``{"params": {...}}``, as a checkpoint
    stores them) -> ``NeuralFSAI.state_dict()``.  Flax ``Dense`` kernels
    are (in, out); ``nn.Linear`` weights are (out, in), so they are
    transposed.  ``q_coeffs`` is the stored delta over e0.
    """
    tree = params["params"]
    state = {}
    for name in ("dense0", "dense1", "alpha", "beta"):
        state[f"{name}.weight"] = torch.from_numpy(
            np.array(tree[name]["kernel"]).T.copy()
        )
        state[f"{name}.bias"] = torch.from_numpy(np.array(tree[name]["bias"]))
    state["q_coeffs"] = torch.from_numpy(np.array(tree["q_coeffs"]))
    return state


def neural_fsai_from_checkpoint(payload: dict) -> NeuralFSAI:
    """Model with the payload's hyper-parameters and weights (float32)."""
    model = NeuralFSAI(
        width=int(payload["width"]),
        hidden=int(payload.get("hidden", 64)),
        poly_degree=int(payload.get("poly_degree", 1)),
    )
    model.load_state_dict(params_from_jax(payload["params"]))
    return model


def neural_fsai_dense_preconditioner(
    model: NeuralFSAI,
    plan,
    operand: torch.Tensor,
    scales: torch.Tensor,
    n0: int,
    dtype=torch.float32,
) -> torch.Tensor:
    """Deployed single-case setup: model forward -> dense effective
    preconditioner on the RAW system (Jacobi scaling folded, padding
    masked); assembled in Gram form from strips on a range plan, through
    the dense factor on a generic plan."""
    operand = operand.to(dtype)
    out = model(plan, operand)
    d_isqrt = 1.0 / torch.sqrt(scales.to(dtype))
    if isinstance(plan, FSAIPlan):
        return poly_preconditioner_dense(
            fsai_dense_factor(plan, out.c_vals),
            fsai_dense_from_l0(plan, operand), out.q_coeffs,
            d_isqrt=d_isqrt, n0=n0,
        )
    strips = range_strips(plan, out.c_vals)
    s_eff = range_m_from_strips(plan, strips, d_isqrt=d_isqrt, n0=n0)
    d_sqrt = torch.sqrt(scales.to(dtype))
    a_raw = d_sqrt[:, None] * operand * d_sqrt[None, :]
    return poly_preconditioner_from_gram(s_eff, a_raw, out.q_coeffs)
