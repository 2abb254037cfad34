"""Plain reference of the NeuralFSAI setups, in float64 torch.

FSAI builds a lower-triangular C on a fixed pattern with C^T A~ C ~ I:
column j solves A~[S_j, S_j] y = e_j (S_j the column's pattern rows, j
the first of them) and takes c_j = y / sqrt(y_j).  The refinement MLP
(tanh GELU) reads, per column, [c / max(|c_j|, 1e-20), a_col, pos1h, pad]
with a_col[k] = A~[S_j[k], j], and gives c * exp(alpha) + (1 - pos1h) *
beta * c_j on the live slots; q = e0 + q_coeffs.  The preconditioner of
the raw system is M = C q(B) q(B)^T C^T with C = D^-1/2 C~ and B = C^T A
C.

``precision="bf16"`` is the control of a float32 configuration: every
stage's inputs and outputs are rounded to bfloat16 (the nearest precision
below float32), the rest is float64; ``"fp8"`` (float8 e4m3, scaled per
tensor) rounds as the step below a stage the configuration states in
bfloat16.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.fsai_pattern import column_rows


def rounder(precision: str | None):
    if precision is None:
        return lambda t: t
    if precision == "bf16":
        return lambda t: t.to(torch.bfloat16).to(torch.float64)
    if precision == "fp8":
        return _round_fp8

    raise ValueError(f"precision {precision!r}")


def _round_fp8(t: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 with one scale a tensor (its largest magnitude at the
    format's largest finite value, 448), as fp8 storage is used."""
    scale = torch.clamp(t.abs().max(), min=1e-300) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float64) * scale


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def refine(weights: dict, c, a_col, pos1h, pad, rnd):
    """The refinement MLP on (..., w) columns; returns the refined columns
    (dead slots 0) before any scaling."""
    dev = c.device

    def dense(name, x):
        kernel, bias = weights[name]
        return rnd(x @ torch.as_tensor(kernel, device=dev)
                   + torch.as_tensor(bias, device=dev))

    c_diag = (c * pos1h).sum(-1, keepdim=True)
    denom = torch.clamp(c_diag.abs(), min=1e-20)
    feats = rnd(torch.cat([c / denom, a_col, pos1h, pad], dim=-1))
    h = rnd(gelu_tanh(dense("dense0", feats)))
    h = rnd(gelu_tanh(dense("dense1", h)))
    alpha = dense("alpha", h)
    beta = dense("beta", h)
    refined = c * torch.exp(alpha) + (1.0 - pos1h) * beta * c_diag
    return rnd(refined * (1.0 - pad))


def q_vector(weights: dict, device) -> torch.Tensor:
    q = torch.as_tensor(weights["q_coeffs"], device=device).clone()
    q[0] += 1.0
    return q


def learned_factor(case, pattern, weights: dict, device,
                   precision: str | None = None):
    """(C = D^-1/2 C~ as a dense (n, n) lower-triangular float64 matrix,
    q) of one raw sludge case."""
    rnd = rounder(precision)
    n, w = case.n, weights["width"]
    a = torch.as_tensor(case.csr().toarray(), device=device)
    d_isqrt = 1.0 / torch.sqrt(torch.diagonal(a))
    a_s = rnd(d_isqrt[:, None] * a * d_isqrt[None, :])
    s = torch.as_tensor(column_rows(*pattern, n, w), device=device)
    live = s >= 0
    s_c = torch.where(live, s, 0)
    pair = live[:, :, None] & live[:, None, :]
    sub = torch.where(pair, a_s[s_c[:, :, None], s_c[:, None, :]], 0.0)
    eye = torch.eye(w, dtype=torch.float64, device=device)
    sub = sub + eye * (~live)[:, None, :]
    j = torch.arange(n, device=device)
    if not bool((s[:, 0] == j).all()):
        raise ValueError("a column's pattern must start at its diagonal")
    e = torch.zeros(n, w, dtype=torch.float64, device=device)
    e[:, 0] = 1.0
    y = torch.linalg.solve(sub, e)
    c = rnd(torch.where(live, y / torch.sqrt(y[:, :1]), 0.0))
    a_col = torch.where(live, a_s[s_c, j[:, None]], 0.0)
    pos1h = torch.zeros_like(c)
    pos1h[:, 0] = 1.0
    refined = refine(weights, c, a_col, pos1h, (~live).double(), rnd)

    c_t = torch.zeros(n, n, dtype=torch.float64, device=device)
    c_t[s_c[live], j[:, None].expand(n, w)[live]] = refined[live]
    return rnd(d_isqrt[:, None] * c_t), rnd(q_vector(weights, device))


def dense_learned_m(case, pattern, weights: dict, device,
                    precision: str | None = None) -> torch.Tensor:
    """The (n, n) learned M of one raw sludge case (float64)."""
    rnd = rounder(precision)
    c_eff, q = learned_factor(case, pattern, weights, device, precision)
    n = case.n
    a = torch.as_tensor(case.csr().toarray(), device=device)
    b = rnd(c_eff.T @ a @ c_eff)
    qb = q[-1] * torch.eye(n, dtype=torch.float64, device=device)
    for coef in q.flip(0)[1:]:
        qb = rnd(qb @ b) + coef * torch.eye(n, dtype=torch.float64,
                                            device=device)
    cq = rnd(c_eff @ qb)
    return rnd(cq @ cq.T)


def band_form(c_eff: torch.Tensor, d_max: int, n_pad: int) -> torch.Tensor:
    """bands[d, j] = C[j + d, j] of a dense lower-triangular C, (d_max,
    n_pad), zero past the matrix."""
    n = c_eff.shape[0]
    bands = torch.zeros(d_max, n_pad, dtype=c_eff.dtype,
                        device=c_eff.device)
    for d in range(min(d_max, n)):
        bands[d, :n - d] = torch.diagonal(c_eff, -d)
    return bands
