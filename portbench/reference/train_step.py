"""Plain reference of the NeuralFSAI training step with ``pcg_loss``, in
float64 torch.

A batch's cases are Jacobi-scaled and padded with identity rows to
n_pad; each case's pattern is tril(|A~|^power) of its tril sites (the
padding's diagonal included), at most ``width`` a column.  The factor C~
comes from ``reference/neural_fsai``'s local solves and refinement MLP
(here with a gradient to the MLP's parameters), M = C~ q(B) q(B)^T C~^T
with B = C~^T A~ C~ over all n_pad rows, and the loss is the batch mean of
log(max(r_k.r_k / b.b, 1e-12)) after ``pcg_steps`` PCG steps from x = 0
on the scaled system (b~ 1 on the padding).  The step is
``torch.optim.Adam`` (lr, betas 0.9 / 0.999, eps 1e-8) on float64
copies of the parameters.  ``precision="bf16"`` rounds every stage (the
control).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.fsai_pattern import (
    column_rows,
    scaled_tril,
    tril_power_pattern,
)
from portbench.reference.neural_fsai import gelu_tanh, rounder

def scaled_system(case, n_pad: int):
    """(dense symmetric A~ (n_pad, n_pad) with identity padding, b~
    (n_pad), the tril sites (rows, cols))."""
    rows, cols, vals, diag = scaled_tril(case, n_pad)
    a = np.zeros((n_pad, n_pad))
    a[rows, cols] = vals
    a = a + np.tril(a, -1).T
    b = np.ones(n_pad)
    b[:case.n] = case.rhs / np.sqrt(diag)
    return a, b, (rows, cols)


class Model(torch.nn.Module):
    """The MLP's parameters as float64 leaves named as the port's."""

    def __init__(self, state: dict, device):
        super().__init__()
        self.p = torch.nn.ParameterDict({
            k.replace(".", "_"): torch.nn.Parameter(
                torch.as_tensor(v, dtype=torch.float64, device=device)
                .clone())
            for k, v in state.items()})

    def leaf(self, name: str) -> torch.Tensor:
        return self.p[name.replace(".", "_")]


def case_loss(model: Model, a, b, site_rows, site_cols, width: int,
              power: int, degree: int, pcg_steps: int, rnd, device):
    n = a.shape[0]
    pr, pc = tril_power_pattern(site_rows, site_cols, n, power)
    s = torch.as_tensor(column_rows(pr, pc, n, width), device=device)
    a_t = rnd(torch.as_tensor(a, device=device))
    live = s >= 0
    s_c = torch.where(live, s, 0)
    pair = live[:, :, None] & live[:, None, :]
    sub = torch.where(pair, a_t[s_c[:, :, None], s_c[:, None, :]], 0.0)
    sub = sub + torch.eye(width, dtype=torch.float64,
                          device=device) * (~live)[:, None, :]
    e = torch.zeros(n, width, dtype=torch.float64, device=device)
    e[:, 0] = 1.0
    with torch.no_grad():
        y = torch.linalg.solve(sub, e)
    c = rnd(torch.where(live, y / torch.sqrt(y[:, :1]), 0.0))
    j = torch.arange(n, device=device)
    a_col = torch.where(live, a_t[s_c, j[:, None]], 0.0)
    pos1h = torch.zeros_like(c)
    pos1h[:, 0] = 1.0
    pad = (~live).double()
    denom = torch.clamp(c[:, :1].abs(), min=1e-20)
    feats = rnd(torch.cat([c / denom, a_col, pos1h, pad], dim=-1))

    def dense(name, x):
        return rnd(x @ model.leaf(f"{name}.weight").T
                   + model.leaf(f"{name}.bias"))

    h = rnd(gelu_tanh(dense("dense0", feats)))
    h = rnd(gelu_tanh(dense("dense1", h)))
    refined = (c * torch.exp(dense("alpha", h))
               + (1.0 - pos1h) * dense("beta", h) * c[:, :1]) * (1.0 - pad)
    refined = rnd(refined)
    flat = (s_c * n + j[:, None])[live]
    c_dense = torch.zeros(n * n, dtype=torch.float64, device=device)
    c_dense = c_dense.index_put((flat,), refined[live]).reshape(n, n)
    q = model.leaf("q_coeffs") + torch.eye(
        1, degree + 1, dtype=torch.float64, device=device)[0]
    bmat = rnd(c_dense.T @ a_t @ c_dense)
    eye = torch.eye(n, dtype=torch.float64, device=device)
    qb = eye * q[degree]
    for i in range(degree - 1, -1, -1):
        qb = rnd(qb @ bmat) + q[i] * eye
    cq = rnd(c_dense @ qb)
    m = rnd(cq @ cq.T)
    bt = torch.as_tensor(b, device=device)
    bb = torch.clamp(bt @ bt, min=1e-30)
    x = torch.zeros_like(bt)
    r, z = bt, m @ bt
    p = z
    for _ in range(pcg_steps):
        ap = a_t @ p
        rz = r @ z
        den = ap @ p
        alpha = rz / torch.where(den == 0, 1.0, den)
        x = x + alpha * p
        r = r - alpha * ap
        z = m @ r
        beta = (r @ z) / torch.where(rz == 0, 1.0, rz)
        p = z + beta * p
    return torch.log(torch.clamp((r @ r) / bb, min=1e-12))


def train_steps(batches, state: dict, n_pad: int, width: int, power: int,
                degree: int, lr: float, pcg_steps: int, device,
                precision: str | None = None) -> dict:
    """Adam steps of ``pcg_loss`` on ``batches`` (lists of raw cases) from
    the parameters ``state``: the losses, the first gradient per leaf
    and the parameters after the steps."""
    rnd = rounder(precision)
    model = Model(state, device)
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    systems = [[scaled_system(c, n_pad) for c in batch] for batch in batches]
    losses, first_grad = [], None
    for batch in systems:
        opt.zero_grad(set_to_none=True)
        loss = torch.stack([
            case_loss(model, a, b, rows, cols, width, power, degree,
                      pcg_steps, rnd, device)
            for a, b, (rows, cols) in batch]).mean()
        loss.backward()
        if first_grad is None:
            first_grad = {k: model.leaf(k).grad.detach().clone()
                          for k in state}
        opt.step()
        losses.append(float(loss.detach()))
    return {"losses": losses, "first_grad": first_grad,
            "params": {k: model.leaf(k).detach().clone() for k in state}}
