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
parameter tree onto this module's ``state_dict`` and ``params_to_jax``
back; ``init_params`` is Flax's fresh initialization.  The forward also
takes a group of plans (``ops/fsai.stack_plans``) with one operand per
case, the reference's vmapped ``model.apply`` (the batched protocol and
the training batches): one B1 launch for the whole group.  So the
reference's ``batched_apply_fsai(model, params, plans, operands)`` is
``model(plans, operands)`` here, and its ``stack_fsai_plans`` is
``ops/fsai.stack_plans``.  A generic plan's local blocks are always looked up in
the value vector, the reference's ``gather="lookup"`` form (its default
gather from the dense matrix gives the same values).
``neural_fsai_case_setup`` is the one-off deployed setup of a raw scipy
system (``compare_meshes``), split into its input preparation (the host
plan, moved to the device: ``neural_fsai_case_plan``) and the setup proper
(``neural_fsai_case_m``) so that a caller can time the latter alone.
On a CUDA device ``neural_fsai_dense_preconditioner`` replays the forward
and the wrap of a setup whose shapes come back from two CUDA graphs (see
its docstring).

The parameters enter after the local solves, so the solves carry no
gradient to the parameters, in the reference as here: when the operand
needs no gradient they run under ``torch.no_grad()``.  (B1's CUDA wrapper
refuses an operand that needs one: it would drop the gradient.)
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np
import torch
from torch import nn

from deeppreconditioning_tpu_torch import _backend
from deeppreconditioning_tpu_torch.ops.fsai import (
    FSAIPlan,
    RangeFSAIPlan,
    build_fsai_plan,
    build_range_fsai_plan,
    fsai_dense_factor,
    fsai_dense_from_l0,
    fsai_values_lookup,
    pattern_col_width,
    poly_preconditioner_dense,
    poly_preconditioner_from_gram,
    range_dense_factor_slabs,
    range_fsai_columns,
    range_m_from_strips,
    range_strips,
    stack_plans,
    tril_power_pattern,
    tril_power_pattern_capped,
)
from deeppreconditioning_tpu_torch.utils import graphs
from deeppreconditioning_tpu_torch.utils.tracing import count, span

LAYERS = ("alpha", "beta", "dense0", "dense1")  # Flax's (sorted) names


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
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and operand.requires_grad):
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

        # e0 by a kernel (no host copy, so a CUDA graph can capture it)
        q0 = torch.eye(1, self.poly_degree + 1, dtype=c.dtype,
                       device=c.device)[0]
        q = (q0 + self.q_coeffs).expand(*c.shape[:-2], self.poly_degree + 1)
        return NeuralFSAIOut(c_vals=c_out, q_coeffs=q)


def params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """Flax NeuralFSAI variables (``{"params": {...}}``, as a checkpoint
    stores them) -> ``NeuralFSAI.state_dict()``.  Flax ``Dense`` kernels
    are (in, out); ``nn.Linear`` weights are (out, in), so they are
    transposed.  ``q_coeffs`` is the stored delta over e0.  Also maps an
    optimizer moment tree of the same layout.
    """
    tree = params["params"]
    state = {}
    for name in LAYERS:
        state[f"{name}.weight"] = torch.from_numpy(
            np.array(tree[name]["kernel"]).T.copy()
        )
        state[f"{name}.bias"] = torch.from_numpy(np.array(tree[name]["bias"]))
    state["q_coeffs"] = torch.from_numpy(np.array(tree["q_coeffs"]))
    return state


def params_to_jax(state: dict[str, torch.Tensor]) -> dict:
    """The inverse of ``params_from_jax``: a ``state_dict`` (or any map
    with its keys, such as an optimizer moment per parameter) -> Flax's
    variables ``{"params": {...}}`` with numpy leaves, keys in Flax's
    sorted order."""
    def host(t):
        return np.ascontiguousarray(t.detach().cpu().numpy())

    tree = {name: {"bias": host(state[f"{name}.bias"]),
                   "kernel": host(state[f"{name}.weight"].T)}
            for name in LAYERS}
    tree["q_coeffs"] = host(state["q_coeffs"])
    return {"params": tree}


_TRUNC_STD = 0.87962566103423978  # std of a standard normal cut to [-2, 2]


def _truncated_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard normal draws cut to [-2, 2] (inverse-CDF sampling, float64
    on the CPU)."""
    lo, hi = (0.5 * (1.0 + math.erf(x / math.sqrt(2.0))) for x in (-2, 2))
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    u = lo + (hi - lo) * u
    x = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    return x.clamp(-2.0, 2.0)


def init_params(model: NeuralFSAI, generator: torch.Generator) -> None:
    """Flax's fresh initialization of ``model``, in place, drawn from
    ``generator``: ``dense0`` and ``dense1`` kernels ``lecun_normal`` (a
    normal cut to +-2 standard deviations and rescaled to variance
    1 / fan_in), every bias zero, the ``alpha`` and ``beta`` heads and
    ``q_coeffs`` zero.  This matches Flax's distribution, not its bits:
    the draws come from torch's generator, not from a JAX key."""
    with torch.no_grad():
        for layer in (model.dense0, model.dense1):
            fan_in = layer.weight.shape[1]
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            w = _truncated_normal(layer.weight.shape, generator) * std
            layer.weight.copy_(w)
            nn.init.zeros_(layer.bias)
        for head in (model.alpha, model.beta):
            nn.init.zeros_(head.weight)
            nn.init.zeros_(head.bias)
        nn.init.zeros_(model.q_coeffs)


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
    n0,
    dtype=torch.float32,
    precision=None,
) -> torch.Tensor:
    """Deployed setup: model forward -> dense effective preconditioner on
    the RAW system (Jacobi scaling folded, padding masked); assembled in
    Gram form from strips on a range plan, through the dense factor on a
    generic plan.  One case, or a group plan with stacked operands,
    scales and one ``n0`` per case (the forward is then one B1 launch).
    ``n0`` is an int or a 0-dim integer tensor for a case, a ``(cases,)``
    one for a group.  ``precision`` is the polynomial wrap's
    (``ops/fsai._matmul``).  Under a ``torch.profiler`` it records the
    span ``fsai.setup`` with the children ``fsai.forward`` and
    ``fsai.wrap`` (``utils/tracing.py``).

    On a CUDA device a setup whose key comes back is replayed from two
    CUDA graphs (``utils/graphs.py``), the forward's and the wrap's, where
    the seam's eager rule lets it with the model's parameters.  The key
    adds to the walk of ``(plan, operand, scales)`` the model object, its
    parameters' addresses, shapes and dtypes, whether ``n0`` is one value
    or one per case (not its value), ``dtype`` and ``precision``, and is
    captured on its second call (``SETUP_GRAPHS``).  Its entry adds ``n0``
    as an int64 device tensor.  The capturing call returns the M of its
    warm-up; a replay runs the forward inside ``fsai.forward`` and the wrap
    inside ``fsai.wrap`` and returns a fresh copy of M.  Each replayed
    setup counts ``fsai.graph_setups``, each key captured
    ``fsai.graph_captures``."""
    dev = operand.device
    with span("fsai.setup", dev):
        key, leaves = _setup_key(model, plan, operand, scales, n0, dtype,
                                 precision)
        if graphs.eager_because(leaves, model.parameters()) is None:
            graph = SETUP_GRAPHS.lookup(key, lambda: _SetupGraph(
                leaves, model, plan, operand, scales, n0, dtype, precision))
            if graph is not None:
                return graph.run(leaves, n0)
        operand = operand.to(dtype)
        with span("fsai.forward", dev):
            out = model(plan, operand)
        with span("fsai.wrap", dev):
            return _setup_wrap(plan, out, operand, scales, n0, dtype,
                               precision)


def _setup_wrap(plan, out: NeuralFSAIOut, operand, scales, n0, dtype,
                precision):
    """The setup's polynomial wrap of the forward's ``out`` (``operand``
    already in ``dtype``): M on the raw system."""
    d_isqrt = 1.0 / torch.sqrt(scales.to(dtype))
    if isinstance(plan, FSAIPlan):
        return poly_preconditioner_dense(
            fsai_dense_factor(plan, out.c_vals),
            fsai_dense_from_l0(plan, operand), out.q_coeffs,
            d_isqrt=d_isqrt, n0=n0, precision=precision,
        )
    strips = range_strips(plan, out.c_vals)
    s_eff = range_m_from_strips(plan, strips, d_isqrt=d_isqrt, n0=n0)
    d_sqrt = torch.sqrt(scales.to(dtype))
    a_raw = d_sqrt[..., :, None] * operand * d_sqrt[..., None, :]
    return poly_preconditioner_from_gram(s_eff, a_raw, out.q_coeffs,
                                         precision=precision)


# -- the setup replayed from CUDA graphs --------------------------------------

def _setup_key(model, plan, operand, scales, n0, dtype, precision):
    """(key, input tensors in walk order) of a setup (see
    ``neural_fsai_dense_preconditioner``)."""
    operands, leaves = graphs.walk((plan, operand, scales))
    params = tuple((p.data_ptr(), tuple(p.shape), p.dtype)
                   for p in model.parameters())
    n0_shape = tuple(n0.shape) if torch.is_tensor(n0) else ()
    return (model, params, operands, n0_shape, dtype, precision), leaves


class _SetupGraph(graphs.GraphEntry):
    """One key's static ``n0`` and its forward and wrap graphs (see
    ``neural_fsai_dense_preconditioner``)."""

    def __init__(self, leaves, model, plan, operand, scales, n0, dtype,
                 precision) -> None:
        super().__init__((plan, operand, scales), operand.device)
        self.plan, self.operand, self.scales = self.operands
        self.model, self.dtype, self.precision = model, dtype, precision
        self.n0 = torch.empty(n0.shape if torch.is_tensor(n0) else (),
                              dtype=torch.int64, device=self.device)
        self.load(leaves, n0)
        self.first, self.graphs = graphs.capture_graphs(
            self.device, self._warm, self._forward, self._wrap)
        count("fsai.graph_captures")

    def _forward(self) -> None:
        self.cast = self.operand.to(self.dtype)
        self.out = self.model(self.plan, self.cast)

    def _wrap(self) -> None:
        self.m = _setup_wrap(self.plan, self.out, self.cast, self.scales,
                             self.n0, self.dtype, self.precision)

    def _warm(self) -> torch.Tensor:
        """The setup run eagerly: its M, the capturing call's."""
        self._forward()
        self._wrap()
        m, self.cast, self.out, self.m = self.m, None, None, None
        return m

    def load(self, leaves, n0) -> None:
        super().load(leaves)
        if torch.is_tensor(n0):
            self.n0.copy_(n0)
        else:
            self.n0.fill_(n0)

    def run(self, leaves, n0) -> torch.Tensor:
        """The setup of inputs ``leaves`` (``_setup_key``'s) and ``n0``:
        a fresh M (on the capturing call, its warm-up's)."""
        if self.first is not None:
            m, self.first = self.first, None
            return m
        forward, wrap = self.graphs
        dev = self.device
        self.load(leaves, n0)
        with span("fsai.forward", dev):
            forward.replay()
        with span("fsai.wrap", dev):
            wrap.replay()
        count("fsai.graph_setups")
        return self.m.clone()


# key -> _SetupGraph, captured on the key's second call
SETUP_GRAPHS = graphs.GraphCache(capture_on=2)


class CasePlan(NamedTuple):
    """Input of the one-off deployed setup for one raw system, on the
    device (``neural_fsai_case_plan``)."""

    plan: FSAIPlan  # generic plan at the model's width
    l0_vals: torch.Tensor  # (nnz + n_pad - n,) scaled tril values
    scales: torch.Tensor  # (n_pad,) diag(A), 1 on the padding
    n: int
    n_pad: int


def scaled_tril(a_csr):
    """The Jacobi-scaled tril of a raw scipy system, sorted by (row,
    col): ``(rows, cols, vals, diag)`` with int32 indices, the values of
    D^-1/2 A D^-1/2 and diag(A)."""
    a = a_csr.tocsr()
    coo = a.tocoo()
    keep = coo.row >= coo.col
    rows, cols = coo.row[keep], coo.col[keep]
    diag = a.diagonal()
    d_isqrt = 1.0 / np.sqrt(diag)
    vals = coo.data[keep] * d_isqrt[rows] * d_isqrt[cols]
    order = np.argsort(rows.astype(np.int64) * a.shape[0] + cols)
    return (rows[order].astype(np.int32), cols[order].astype(np.int32),
            vals[order], diag)


def neural_fsai_case_plan(a_csr, power: int, width: int,
                          dtype=torch.float32, device=None) -> CasePlan:
    """Input preparation of the one-off deployed setup, as the reference's
    ``neural_fsai_case_setup`` does it on the host: Jacobi-scale the raw
    system, keep its tril sorted by (row, col) with a unit diagonal on the
    padding up to ``n_pad`` (a multiple of 128), take tril(|A|^power),
    capped to the ``width`` strongest couplings per column when wider,
    build the generic plan; then move it and the values to ``device``
    (the card unless the caller passes the CPU) in ``dtype``."""
    device = _backend.device() if device is None else torch.device(device)
    rows, cols, vals, diag = scaled_tril(a_csr)
    n = a_csr.shape[0]
    n_pad = ((n + 127) // 128) * 128
    # the padding's rows follow every real one: the order stays sorted
    pad_ids = np.arange(n, n_pad, dtype=np.int32)
    l0_rows = np.concatenate([rows, pad_ids])
    l0_cols = np.concatenate([cols, pad_ids])
    l0_vals = np.concatenate([vals, np.ones(n_pad - n)])
    pr, pc = tril_power_pattern(l0_rows, l0_cols, n_pad, power=power)
    if pattern_col_width(pr, pc) > width:
        pr, pc = tril_power_pattern_capped(l0_rows, l0_cols, l0_vals, n_pad,
                                           power=power, width=width)
    plan = build_fsai_plan(l0_rows, l0_cols, pr, pc, n_pad, width=width)
    scales = np.ones(n_pad)
    scales[:n] = diag

    def t(x):
        return torch.as_tensor(x, device=device).to(dtype)

    return CasePlan(plan.to(device), t(l0_vals), t(scales), n, n_pad)


def neural_fsai_case_m(model: NeuralFSAI, case: CasePlan) -> torch.Tensor:
    """The one-off deployed setup proper, on the case's device and dtype:
    ``neural_fsai_dense_preconditioner`` on its generic plan (one B1
    launch) at full precision, rows and columns >= n masked: the
    (n_pad, n_pad) M for the RAW system.  ``model`` is moved to that
    device and dtype (in place, as the suite does)."""
    operand = case.l0_vals
    model = model.to(device=operand.device, dtype=operand.dtype)
    with torch.no_grad():
        return neural_fsai_dense_preconditioner(
            model, case.plan, operand, case.scales, case.n,
            dtype=operand.dtype)


def neural_fsai_case_setup(model: NeuralFSAI, a_csr, power: int,
                           dtype=torch.float32, device=None):
    """The one-off deployed setup of a raw scipy system (the reference's
    ``neural_fsai_case_setup``, the shared path of ``compare_meshes`` and
    ``residual_parity``): ``neural_fsai_case_plan``, then
    ``neural_fsai_case_m`` on ``device`` (the card unless the caller
    passes the CPU).  Returns ``(m, n_pad)``."""
    case = neural_fsai_case_plan(a_csr, power, model.width, dtype, device)
    return neural_fsai_case_m(model, case), case.n_pad


# -- batches of plans (the training path) -------------------------------------


def batched_dense_factor(plans, c_vals: torch.Tensor) -> torch.Tensor:
    """Dense C of every case of a group -> (B, n_pad, n_pad), by plan
    kind, in scaled space."""
    if isinstance(plans, RangeFSAIPlan):
        return range_dense_factor_slabs(plans, c_vals)
    return fsai_dense_factor(plans, c_vals)


def batched_dense_m(plans, out: NeuralFSAIOut,
                    a_full: torch.Tensor) -> torch.Tensor:
    """Batched dense preconditioner M~ = C q(B) q(B)^T C^T in scaled space
    (no scaling fold, no n0 mask: the scaled systems are what training
    solves)."""
    c_dense = batched_dense_factor(plans, out.c_vals)
    return poly_preconditioner_dense(c_dense, a_full, out.q_coeffs)


class FSAIPlanProvider:
    """Builds and caches the group FSAI plan of each training batch.

    Per sample it derives the pattern tril(|A|^power) from the batch's
    level-0 sites and builds a range plan at window height
    ``min(range_h, n_pad)`` without static starts, or a generic plan; the
    group goes to the dataset's device.  ``kind`` "auto" settles on
    "range" at the first sample whose range plan builds, else on
    "generic", for good.  Plans are cached per batch index in the
    dataset (``batch.index``) and share of its cases (``batch.span``), so
    each is built once and reused every epoch.

    A rank's share (data-parallel training) must not settle "auto" on
    its own first case, which differs between ranks: ``settle`` decides
    it on a whole batch, as a single device's first call would, and a
    share's plans are refused while the kind is still "auto".
    """

    def __init__(self, dataset, power: int = 3, width: int = 16,
                 range_h: int = 256, kind: str = "auto") -> None:
        self.dataset = dataset
        self.power = power
        self.width = width
        self.range_h = range_h
        self.kind = kind  # "auto" | "range" | "generic"
        self._cache: dict = {}

    def _sample_plan(self, rows, cols, valid, n_pad, sentinel):
        nnz = int(valid.sum())
        r0 = rows[:nnz].astype(np.int32)
        c0 = cols[:nnz].astype(np.int32)
        pr, pc = tril_power_pattern(r0, c0, n_pad, power=self.power)
        need = pattern_col_width(pr, pc)
        if need > self.width:
            raise ValueError(
                f"fsai pattern width {need} exceeds configured width "
                f"{self.width}; raise params fsai_width"
            )
        if self.kind == "auto":
            try:
                plan = build_range_fsai_plan(
                    pr, pc, n_pad, width=self.width,
                    range_h=min(self.range_h, n_pad),
                )
                self.kind = "range"
                return plan
            except ValueError:
                self.kind = "generic"
        if self.kind == "range":
            return build_range_fsai_plan(
                pr, pc, n_pad, width=self.width,
                range_h=min(self.range_h, n_pad),
            )
        return build_fsai_plan(
            r0, c0, pr, pc, n_pad, width=self.width, sentinel=sentinel
        )

    def settle(self, batch) -> str:
        """Settle "auto" on ``batch``'s first case, as the first call on
        that whole batch would; returns the kind."""
        if self.kind == "auto":
            sites = [np.asarray(x[0].cpu()) for x in batch.sites]
            self._sample_plan(*sites, batch.solutions.shape[1],
                              batch.features.shape[1])
        return self.kind

    def __call__(self, index: int, batch):
        # keyed on the batch's index in the dataset, not ``index``: split
        # views renumber their batches from 0
        del index
        key = (batch.index if batch.span is None
               else (batch.index, batch.span))
        if key in self._cache:
            return self._cache[key]
        if batch.span is not None and self.kind == "auto":
            raise ValueError("a share of a batch needs the plan kind "
                             "settled on a whole batch first (settle)")
        sites = [np.asarray(x.cpu()) for x in batch.sites]
        n_pad = batch.solutions.shape[1]
        sentinel = batch.features.shape[1]
        plans: List = [
            self._sample_plan(rows, cols, valid, n_pad, sentinel)
            for rows, cols, valid in zip(*sites)
        ]
        plan = stack_plans(plans).to(self.dataset.device)
        self._cache[key] = plan
        return plan
