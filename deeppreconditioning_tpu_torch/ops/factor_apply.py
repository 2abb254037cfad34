"""Sparse factored-preconditioner apply: z = L (L^T r) as pure gathers.

Counterpart of the conv half of ``deeppreconditioning_tpu/ops/
factor_apply.py``.  The host builds a ``FactorApplyPlan`` from L's
pattern: for every row a fixed-width list of (value index, vector index)
pairs for the L half and for the L^T half.  The device apply is two
gather-multiply-rowsum passes, ``t = L^T r`` then ``z = L t``, on the
net's output value vector as it stands (the setup is the forward alone).
Padding entries point at a sentinel value slot that holds 0.  The
widths are static; a row wider than its width raises ``ValueError``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


class FactorApplyPlan(NamedTuple):
    """Gather plan of z = L (L^T r) over one L pattern: ``l_*`` are
    (n_pad, w_lower), ``u_*`` (n_pad, w_upper); ``l_src`` / ``u_src``
    index the zero-extended value vector (sentinel nnz_pad), ``l_col`` /
    ``u_row`` the vector operand."""

    l_src: torch.Tensor
    l_col: torch.Tensor
    u_src: torch.Tensor
    u_row: torch.Tensor

    @property
    def n_pad(self) -> int:
        return self.l_src.shape[0]

    def to(self, device) -> "FactorApplyPlan":
        return FactorApplyPlan(*(t.to(device) for t in self))


def _group_fixed_width(
    group: np.ndarray,
    payload_src: np.ndarray,
    payload_idx: np.ndarray,
    n_groups: int,
    width: int,
    sentinel: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pack (group -> [(src, idx), ...]) into fixed-width row-major
    arrays."""
    order = np.argsort(group, kind="stable")
    group_s = group[order]
    counts = np.bincount(group_s, minlength=n_groups)
    if counts.size and counts.max(initial=0) > width:
        raise ValueError(
            f"row width {counts.max()} exceeds static width {width}"
        )
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    slot = np.arange(group_s.shape[0]) - starts[group_s]
    src = np.full((n_groups, width), sentinel, np.int32)
    idx = np.zeros((n_groups, width), np.int32)
    src[group_s, slot] = payload_src[order]
    idx[group_s, slot] = payload_idx[order]
    return src, idx


def pattern_widths(
    rows: np.ndarray, cols: np.ndarray, valid: np.ndarray
) -> Tuple[int, int]:
    """(max nnz per row, max nnz per column) of a pattern."""
    w_l = int(np.bincount(rows[valid]).max(initial=1))
    w_u = int(np.bincount(cols[valid]).max(initial=1))
    return w_l, w_u


def build_factor_apply_plan(
    rows: np.ndarray,
    cols: np.ndarray,
    valid: np.ndarray,
    n_pad: int,
    widths: Optional[Tuple[int, int]] = None,
) -> FactorApplyPlan:
    """The gather plan of one L pattern (CPU tensors, int64).

    ``rows`` / ``cols`` / ``valid`` (nnz_pad,): the sites of L's value
    vector (the final conv plan's); ``widths``: static (w_lower,
    w_upper), by default this pattern's own maxima.
    """
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    valid = np.asarray(valid)
    sentinel = rows.shape[0]
    if widths is None:
        widths = pattern_widths(rows, cols, valid)
    w_l, w_u = widths
    idx = np.flatnonzero(valid).astype(np.int32)
    r = rows[idx].astype(np.int64)
    c = cols[idx].astype(np.int64)
    # z_i = sum_j L_ij t_j: group by row, gather t at col
    l_src, l_col = _group_fixed_width(r, idx, c.astype(np.int32), n_pad,
                                      w_l, sentinel)
    # t_j = sum_i L_ij r_i: group by col, gather r at row
    u_src, u_row = _group_fixed_width(c, idx, r.astype(np.int32), n_pad,
                                      w_u, sentinel)
    return FactorApplyPlan(*(torch.from_numpy(x.astype(np.int64))
                             for x in (l_src, l_col, u_src, u_row)))


def factor_apply(plan: FactorApplyPlan, vals: torch.Tensor,
                 r: torch.Tensor) -> torch.Tensor:
    """z = L (L^T r), L given by (plan, vals): ``vals`` in the plan's site
    order (nnz_pad,), zero at padded and masked sites."""
    vals_ext = torch.cat([vals, vals.new_zeros(1)])
    t = torch.sum(vals_ext[plan.u_src] * r[plan.u_row], dim=1)
    return torch.sum(vals_ext[plan.l_src] * t[plan.l_col], dim=1)


def factor_normal_apply(m_data, r: torch.Tensor) -> torch.Tensor:
    """The suite's apply: ``m_data`` = (FactorApplyPlan, vals)."""
    plan, vals = m_data
    return factor_apply(plan, vals, r)
