"""Sparse 2-D convolution as gather-GEMM over precomputed index plans.

Counterpart of ``deeppreconditioning_tpu/ops/sparse_conv.py``.  The host
half is a numpy copy: ``ConvSpec``, ``build_conv_maps`` (output active
set and one gather map per kernel offset, for ordinary, strided and
submanifold layers), ``build_inverse_conv_maps`` (the inverse conv that
restores a strided conv's input set), ``build_sample_plan`` (a chain of
layers on one sample), ``pad_plans_by_level`` / ``pad_sample_plans``
(padding to per-level buckets) and ``stack_plans``.  The reference takes a
native branch for sorted stride-1 ordinary layers; it returns the same
integers as the numpy path kept here.

The device half is ``apply_sparse_conv``: ``out = sum_k feat_ext[gather[k]]
@ W[k] + b`` at the valid output sites, where ``feat_ext`` is the input
with one zero row appended at index ``level_bucket[in_level]`` (the
sentinel every padded or absent gather entry points at).  The reference
computes this product in XLA, outside any Pallas kernel, so here it is
plain PyTorch: one gather of the K x nnz rows, one batched matmul over K,
then a sum.

Topology is expressed through site-set levels: layer ``li`` maps the
feature array on level ``in_level[li]`` to the one on ``out_level[li]``.
A chain (``PreconditionerNet``) has levels 0, 1, 2, ...; the U-Net
re-uses levels for its skip connections.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class ConvSpec:
    """Static description of one sparse-conv layer: ``submanifold`` keeps
    the output active set equal to the input set; ``stride`` > 1
    downsamples."""

    kernel: Tuple[int, int]
    padding: Tuple[int, int]
    stride: int = 1
    submanifold: bool = False

    def out_shape(self, hw: Tuple[int, int]) -> Tuple[int, int]:
        if self.submanifold:
            return hw
        kh, kw = self.kernel
        ph, pw = self.padding
        s = self.stride
        return (
            (hw[0] + 2 * ph - kh) // s + 1,
            (hw[1] + 2 * pw - kw) // s + 1,
        )


class LayerPlan(NamedTuple):
    """Index plan of one conv layer, with optional leading batch dims.

    ``gather`` (..., K, nnz_out_pad): per kernel offset, the row of the
    zero-row-extended input (the sentinel, the input level's bucket, is
    the zero row); ``rows`` / ``cols`` (..., nnz_out_pad): the output
    sites; ``valid`` (..., nnz_out_pad): the real output sites.
    """

    gather: torch.Tensor
    rows: torch.Tensor
    cols: torch.Tensor
    valid: torch.Tensor

    def to(self, device) -> "LayerPlan":
        return LayerPlan(*(t.to(device) for t in self))


def _lookup(lin_sorted, order, cand, inb):
    """Map candidate linearized sites to input indices (-1 if absent)."""
    nnz_in = lin_sorted.shape[0]
    if nnz_in == 0:
        return np.full(cand.shape, -1, np.int32)
    pos = np.searchsorted(lin_sorted, cand)
    pos_c = np.clip(pos, 0, nnz_in - 1)
    found = inb & (pos < nnz_in) & (lin_sorted[pos_c] == cand)
    return np.where(found, order[pos_c], -1).astype(np.int32)


def build_conv_maps(
    rows: np.ndarray,
    cols: np.ndarray,
    hw_in: Tuple[int, int],
    spec: ConvSpec,
) -> tuple:
    """Output active set and gather maps of one (strided / submanifold)
    conv layer.  Ordinary conv: out(i, j) = sum_{ki, kj} in(i*s - ph + ki,
    j*s - pw + kj), so the output set is the input set pushed through the
    kernel footprint; submanifold: the output set is the input set.

    Returns (out_rows, out_cols, gather (K, nnz_out), hw_out).
    """
    kh, kw = spec.kernel
    ph, pw = spec.padding
    s = spec.stride
    h_out, w_out = spec.out_shape(hw_in)
    w_in = hw_in[1]

    lin_in = rows.astype(np.int64) * w_in + cols
    order = np.argsort(lin_in, kind="stable").astype(np.int32)
    lin_sorted = lin_in[order]

    if spec.submanifold:
        out_rows = rows.astype(np.int32)
        out_cols = cols.astype(np.int32)
    else:
        parts = []
        for ki in range(kh):
            for kj in range(kw):
                ro = rows.astype(np.int64) + ph - ki
                co = cols.astype(np.int64) + pw - kj
                if s > 1:
                    div = (ro % s == 0) & (co % s == 0)
                    ro, co = ro[div] // s, co[div] // s
                ok = (ro >= 0) & (ro < h_out) & (co >= 0) & (co < w_out)
                parts.append(ro[ok] * w_out + co[ok])
        out_lin = np.unique(np.concatenate(parts))
        out_rows = (out_lin // w_out).astype(np.int32)
        out_cols = (out_lin % w_out).astype(np.int32)

    nnz_out = out_rows.shape[0]
    gather = np.empty((kh * kw, nnz_out), np.int32)
    for k, (ki, kj) in enumerate(
        (a, b) for a in range(kh) for b in range(kw)
    ):
        ri = out_rows.astype(np.int64) * s - ph + ki
        ci = out_cols.astype(np.int64) * s - pw + kj
        inb = (ri >= 0) & (ri < hw_in[0]) & (ci >= 0) & (ci < w_in)
        gather[k] = _lookup(lin_sorted, order, ri * w_in + ci, inb)
    return out_rows, out_cols, gather, (h_out, w_out)


def build_inverse_conv_maps(
    down_rows: np.ndarray,
    down_cols: np.ndarray,
    hw_down: Tuple[int, int],
    orig_rows: np.ndarray,
    orig_cols: np.ndarray,
    spec: ConvSpec,
) -> np.ndarray:
    """Gather maps of the inverse of the strided conv ``spec``: the output
    sites are the strided conv's input sites (``orig``), and site o takes
    downsampled site d through offset (ki, kj) iff d_r * s - ph + ki ==
    o_r (the same for columns).  Returns gather (K, nnz_orig) into the
    downsampled feature array."""
    kh, kw = spec.kernel
    ph, pw = spec.padding
    s = spec.stride
    w_down = hw_down[1]

    lin_down = down_rows.astype(np.int64) * w_down + down_cols
    order = np.argsort(lin_down, kind="stable").astype(np.int32)
    lin_sorted = lin_down[order]

    gather = np.empty((kh * kw, orig_rows.shape[0]), np.int32)
    for k, (ki, kj) in enumerate(
        (a, b) for a in range(kh) for b in range(kw)
    ):
        num_r = orig_rows.astype(np.int64) + ph - ki
        num_c = orig_cols.astype(np.int64) + pw - kj
        div = (num_r % s == 0) & (num_c % s == 0)
        dr = num_r // s
        dc = num_c // s
        inb = div & (dr >= 0) & (dr < hw_down[0]) & (dc >= 0) & (
            dc < w_down
        )
        gather[k] = _lookup(lin_sorted, order, dr * w_down + dc, inb)
    return gather


@dataclass
class SamplePlanHost:
    """Host plan of a whole network on one sample, before padding: layer
    ``li`` gathers from level ``in_level[li]`` and writes level
    ``out_level[li]``; ``level_nnz[lv]`` is level lv's site count (level 0
    is the network's input)."""

    layer_rows: List[np.ndarray] = field(default_factory=list)
    layer_cols: List[np.ndarray] = field(default_factory=list)
    layer_gather: List[np.ndarray] = field(default_factory=list)
    shapes: List[Tuple[int, int]] = field(default_factory=list)
    in_level: List[int] = field(default_factory=list)
    out_level: List[int] = field(default_factory=list)
    level_nnz: List[int] = field(default_factory=list)


def build_sample_plan(
    rows: np.ndarray,
    cols: np.ndarray,
    hw: Tuple[int, int],
    specs: Sequence[ConvSpec],
) -> SamplePlanHost:
    """Chain the layer plans of a sequential network on one sample."""
    cur_rows, cur_cols = rows.astype(np.int32), cols.astype(np.int32)
    cur_hw = hw
    out = SamplePlanHost(shapes=[hw], level_nnz=[rows.shape[0]])
    for li, spec in enumerate(specs):
        if spec == ConvSpec((1, 1), (0, 0)):
            gather = np.arange(cur_rows.shape[0], dtype=np.int32)[None, :]
            o_rows, o_cols = cur_rows, cur_cols
        else:
            o_rows, o_cols, gather, cur_hw = build_conv_maps(
                cur_rows, cur_cols, cur_hw, spec
            )
        out.layer_rows.append(o_rows)
        out.layer_cols.append(o_cols)
        out.layer_gather.append(gather)
        out.shapes.append(cur_hw)
        out.in_level.append(li)
        out.out_level.append(li + 1)
        out.level_nnz.append(o_rows.shape[0])
        cur_rows, cur_cols = o_rows, o_cols
    return out


def _round_up(n: int, m: int) -> int:
    return ((max(n, 1) + m - 1) // m) * m


def pad_plans_by_level(
    plans: Sequence[SamplePlanHost],
    level_buckets: Sequence[int],
) -> List[List[LayerPlan]]:
    """Pad per-sample plans to shared per-level buckets (CPU tensors,
    int64 indices).  ``level_buckets[lv]`` is the padded site count of
    level lv; a gather sentinel is ``level_buckets[in_level]``, the zero
    row appended to that level's feature array."""
    result: List[List[LayerPlan]] = []
    for p in plans:
        sample_layers: List[LayerPlan] = []
        for li in range(len(p.layer_rows)):
            nnz_out = p.layer_rows[li].shape[0]
            np_out = level_buckets[p.out_level[li]]
            sentinel = level_buckets[p.in_level[li]]
            g = p.layer_gather[li]
            gather = np.full((g.shape[0], np_out), sentinel, np.int64)
            gather[:, :nnz_out] = np.where(g >= 0, g, sentinel)
            rows = np.zeros((np_out,), np.int64)
            cols = np.zeros((np_out,), np.int64)
            rows[:nnz_out] = p.layer_rows[li]
            cols[:nnz_out] = p.layer_cols[li]
            valid = np.zeros((np_out,), bool)
            valid[:nnz_out] = True
            sample_layers.append(LayerPlan(*(
                torch.from_numpy(x) for x in (gather, rows, cols, valid))))
        result.append(sample_layers)
    return result


def pad_sample_plans(
    plans: Sequence[SamplePlanHost],
    nnz0: Sequence[int],
    bucket: int = 256,
) -> List[List[LayerPlan]]:
    """Pad plans to buckets derived from these samples alone (datasets
    compute dataset-global buckets instead)."""
    n_levels = max(max(p.out_level) for p in plans) + 1
    buckets = []
    for lv in range(n_levels):
        m = max(p.level_nnz[lv] for p in plans)
        if lv == 0:
            m = max(m, max(nnz0))
        buckets.append(_round_up(m, bucket))
    return pad_plans_by_level(plans, buckets)


def stack_plans(plans_padded: List[List[LayerPlan]]) -> List[LayerPlan]:
    """Stack per-sample LayerPlans into batched (B, ...) LayerPlans."""
    return [
        LayerPlan(*(torch.stack(xs) for xs in zip(*[p[li]
                                                    for p in plans_padded])))
        for li in range(len(plans_padded[0]))
    ]


def apply_sparse_conv(
    features: torch.Tensor,  # (B, nnz_in_pad, Cin)
    plan: LayerPlan,  # batched: gather (B, K, nnz_out_pad)
    weights: torch.Tensor,  # (K, Cin, Cout)
    bias: torch.Tensor | None,  # (Cout,)
) -> torch.Tensor:
    """Gather-GEMM of one layer over a batch; (B, nnz_out_pad, Cout).  The
    bias is added at the valid sites only: padded rows stay zero."""
    b, _, cin = features.shape
    k, nnz_out = plan.gather.shape[-2:]
    feat_ext = torch.cat([features, features.new_zeros(b, 1, cin)], dim=1)
    index = plan.gather.reshape(b, k * nnz_out, 1).expand(-1, -1, cin)
    taken = torch.gather(feat_ext, 1, index).reshape(b, k, nnz_out, cin)
    out = torch.matmul(taken, weights).sum(dim=1)
    if bias is not None:
        out = out + bias
    return torch.where(plan.valid[..., None], out, 0.0)
