"""Factorized sparse approximate inverse (FSAI): host plans, range path.

Counterpart of ``deeppreconditioning_tpu/ops/fsai.py``.  FSAI builds a
lower-triangular C on a fixed pattern with ``C^T A C ~= I``; column j is

    solve  A[S_j, S_j] y = e_pos(j),   c_j = y / sqrt(y_pos(j))

with S_j = {i >= j : (i, j) in pattern}, and M = C C^T ~= A^-1.

Host half (numpy copies of the reference's plan builders, held equal to
them by ``tests/test_torch_fsai_plan.py`` and
``tests/test_torch_fsai_generic.py``): ``tril_power_pattern``,
``tril_power_pattern_capped``, ``pattern_col_width``,
``cap_pattern_spread``, ``build_range_fsai_plan`` and ``build_fsai_plan``.

Device half, two paths that share the local solves (kernel B1 through
``ops/gauss_jordan.py``) and the Kaporin normalization:
- the range-blocked path of banded orderings: slab gather, strips,
  slab-wise Gram assembly and the Gram-form polynomial wrap;
- the generic ``FSAIPlan`` path for any pattern (a case whose pattern
  does not fit a range plan): the local blocks looked up in the tril value
  vector (``fsai_values_lookup``, one case or a group), a dense factor C
  and M = C C^T, or the polynomial wrap on C with the dense scaled matrix
  (``fsai_dense_from_l0``).
Gathers are plain indexing here; the reference's one-hot matmuls were a
TPU stand-in for them (``range_dense_factor`` keeps its one-hot placement
as a reference).  The polynomial wraps take the reference's ``precision``:
full float32 products, or ``"bf16"`` inputs with float32 sums (the batched
protocol's bf16 attempt).  ``fsai_factor_scipy`` is the float64 host
factor, column by column.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Tuple

import numpy as np
import scipy.sparse as sp
import torch

from deeppreconditioning_tpu_torch.ops.gauss_jordan import masked_gauss_jordan
from deeppreconditioning_tpu_torch.ops.gram_assembly import gram_assembly

BLOCK_COLS = 8  # JB: consecutive columns that share one row window

# -- host: pattern + plan ---------------------------------------------------


def tril_power_pattern(
    rows: np.ndarray,
    cols: np.ndarray,
    n: int,
    power: int = 3,
) -> Tuple[np.ndarray, np.ndarray]:
    """Lower-triangular pattern of |A|^power from A's tril COO pattern
    (graph symmetrized first); (rows, cols) sorted by (col, row)."""
    ones = np.ones(rows.shape[0], np.int8)
    a = sp.csr_matrix((ones, (rows, cols)), shape=(n, n))
    a = ((a + a.T) > 0).astype(np.int8)
    p = a
    for _ in range(power - 1):
        p = ((p @ a) > 0).astype(np.int8)
    p = sp.tril(p).tocoo()
    order = np.argsort(p.col.astype(np.int64) * n + p.row, kind="stable")
    return p.row[order].astype(np.int32), p.col[order].astype(np.int32)


def tril_power_pattern_capped(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n: int,
    power: int = 3,
    width: int = 24,
) -> Tuple[np.ndarray, np.ndarray]:
    """tril(|A|^power) capped to ``width`` entries per column: the
    diagonal plus the (width - 1) largest |A|^power couplings.  Returns
    (rows, cols) sorted by (col, row)."""
    a = sp.csr_matrix((np.abs(vals), (rows, cols)), shape=(n, n))
    a = a + sp.tril(a, -1).T  # symmetrize magnitudes
    p = a.copy()
    for _ in range(power - 1):
        p = p @ a
    p = sp.tril(p).tocsc()
    keep_r, keep_c = [], []
    for j in range(n):
        lo, hi = p.indptr[j], p.indptr[j + 1]
        idx = p.indices[lo:hi]
        mag = p.data[lo:hi]
        if idx.shape[0] > width:
            is_diag = idx == j
            order = np.argsort(-mag)
            sel = order[:width]
            if not is_diag[sel].any():
                sel = np.concatenate(
                    [order[: width - 1], np.flatnonzero(is_diag)]
                )
            idx = idx[sel]
        keep_r.append(idx)
        keep_c.append(np.full(idx.shape[0], j, idx.dtype))
    pr = np.concatenate(keep_r).astype(np.int32)
    pc = np.concatenate(keep_c).astype(np.int32)
    order = np.argsort(pc.astype(np.int64) * n + pr, kind="stable")
    return pr[order], pc[order]


def pattern_col_width(pat_rows: np.ndarray, pat_cols: np.ndarray) -> int:
    """Max nnz per column: the dataset-global max is the static width."""
    return int(np.bincount(pat_cols).max(initial=1))


def cap_pattern_spread(
    pat_rows: np.ndarray,
    pat_cols: np.ndarray,
    spread_max: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Drop pattern entries with row - col > spread_max (a legal FSAI
    pattern filter: the diagonal always stays)."""
    keep = (pat_rows - pat_cols) <= spread_max
    return pat_rows[keep], pat_cols[keep]


@dataclass
class RangeFSAIPlan:
    """Range-blocked FSAI plan for banded orderings.

    For a block of JB consecutive columns every S_j lies in one row window
    [lo_b, lo_b + H).  Shapes (n_pad columns, B = n_pad / JB, width w):
        lo: (B,) int64 window starts (clipped to n_pad - H).
        local: (n_pad, w) int64, S_j[k] - lo_blk(j); sentinel H.
        pos: (n_pad,) int64 slot of j inside S_j.
        diag_pad: (n_pad, w) float32, 1 on dead slots.
        out_rows: (n_pad, w) int64, S_j; sentinel n_pad.
        lo_static: the window starts min(JB b, n_pad - H) as a tuple when
            the plan was built with ``static_lo`` (the same for every case
            of a dataset), else None.
    Arrays are numpy from ``build_range_fsai_plan``; ``to`` moves them.
    A group of plans (``stack_plans``) has a leading case axis on every
    array.
    """

    lo: object
    local: object
    pos: object
    diag_pad: object
    out_rows: object
    h: int
    lo_static: tuple | None = None

    @property
    def n_pad(self) -> int:
        return self.local.shape[-2]

    @property
    def width(self) -> int:
        return self.local.shape[-1]

    @property
    def block_cols(self) -> int:
        return self.n_pad // self.lo.shape[-1]

    def to(self, device) -> "RangeFSAIPlan":
        """The plan as tensors on ``device`` (integers int64)."""
        def t(x):
            return torch.as_tensor(np.asarray(x), device=device)

        return RangeFSAIPlan(
            lo=t(self.lo).long(), local=t(self.local).long(),
            pos=t(self.pos).long(), diag_pad=t(self.diag_pad),
            out_rows=t(self.out_rows).long(), h=self.h,
            lo_static=self.lo_static,
        )


def build_range_fsai_plan(
    pat_rows: np.ndarray,
    pat_cols: np.ndarray,
    n_pad: int,
    width: int,
    range_h: int,
    static_lo: bool = False,
) -> RangeFSAIPlan:
    """Host build of the range-blocked plan (numpy arrays), with blocks of
    ``BLOCK_COLS`` columns and windows of height min(range_h, n_pad).

    ``static_lo`` pins the window starts to lo_b = min(JB b, n_pad - H),
    which depend on n_pad, H and JB only (the batched setups stack such
    plans); it needs H >= the block's rows from JB b on.

    Raises ValueError if a column is wider than ``width`` or the pattern's
    block row spread exceeds ``range_h`` (a non-banded ordering).
    """
    w = width
    jb = BLOCK_COLS
    if n_pad % jb:
        raise ValueError(f"n_pad={n_pad} not a multiple of {jb}")

    order = np.argsort(
        pat_cols.astype(np.int64) * n_pad + pat_rows, kind="stable"
    )
    r_s = pat_rows[order].astype(np.int64)
    c_s = pat_cols[order].astype(np.int64)
    counts = np.bincount(c_s, minlength=n_pad)
    if counts.max(initial=0) > w:
        raise ValueError(
            f"column width {counts.max()} exceeds static width {w}"
        )
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    slot = np.arange(r_s.shape[0]) - starts[c_s]
    s_mat = np.full((n_pad, w), n_pad, np.int64)
    s_mat[c_s, slot] = r_s

    pos = np.argmax(s_mat == np.arange(n_pad)[:, None], axis=1)
    if not (s_mat[np.arange(n_pad), pos] == np.arange(n_pad)).all():
        raise ValueError("FSAI pattern must contain the diagonal")
    diag_pad = (s_mat == n_pad).astype(np.float32)

    live = s_mat < n_pad
    any_live = live.any(axis=1)
    s_min = np.where(
        any_live, np.where(live, s_mat, n_pad).min(axis=1), np.arange(n_pad)
    )
    s_max = np.where(
        any_live, np.where(live, s_mat, -1).max(axis=1), np.arange(n_pad)
    )
    blk = np.arange(n_pad) // jb
    lo_b = np.minimum.reduceat(s_min, np.arange(0, n_pad, jb))
    hi_b = np.maximum.reduceat(s_max, np.arange(0, n_pad, jb))
    spread = int((hi_b - lo_b + 1).max(initial=1))
    if spread > range_h:
        raise ValueError(f"block row spread {spread} exceeds range_h {range_h}")
    h = min(range_h, n_pad)
    lo_tuple = None
    if static_lo:
        lo_b = np.minimum(jb * np.arange(n_pad // jb), n_pad - h)
        need = int((hi_b - lo_b + 1).max(initial=1))
        if need > h:
            raise ValueError(f"static block row spread {need} exceeds "
                             f"range_h {h}")
        lo_tuple = tuple(int(x) for x in lo_b)
    lo_b = np.minimum(lo_b, n_pad - h).astype(np.int32)

    local = (s_mat - lo_b[blk][:, None]).astype(np.int32)
    local[s_mat >= n_pad] = h

    return RangeFSAIPlan(
        lo=lo_b,
        local=local,
        pos=pos.astype(np.int32),
        diag_pad=diag_pad,
        out_rows=s_mat.astype(np.int32),
        h=h,
        lo_static=lo_tuple,
    )


@dataclass
class FSAIPlan:
    """Generic FSAI plan: any lower-triangular pattern with the diagonal.

    Shapes (n_pad columns, width w, ``sentinel`` = length of the tril value
    vector the plan indexes):
        sub_idx: (n_pad, w, w) int64, index into the value vector of
            A[S_j[p], S_j[q]] (symmetric lookup); ``sentinel`` reads 0.
        pos: (n_pad,) int64 slot of j inside S_j.
        out_rows: (n_pad, w) int64, S_j; sentinel n_pad.
        diag_pad: (n_pad, w) float32, 1 on dead slots.
        l0_rows, l0_cols: (sentinel,) int64 scatter coordinates of the
            value vector; its padded tail lands in row n_pad.
    Arrays are numpy from ``build_fsai_plan``; ``to`` moves them.  A
    group of plans (``stack_plans``) has a leading case axis on every
    array.
    """

    sub_idx: object
    pos: object
    out_rows: object
    diag_pad: object
    l0_rows: object
    l0_cols: object

    @property
    def n_pad(self) -> int:
        return self.sub_idx.shape[-3]

    @property
    def width(self) -> int:
        return self.sub_idx.shape[-2]

    def to(self, device) -> "FSAIPlan":
        """The plan as tensors on ``device`` (integers int64)."""
        def t(x):
            return torch.as_tensor(np.asarray(x), device=device)

        return FSAIPlan(
            sub_idx=t(self.sub_idx).long(), pos=t(self.pos).long(),
            out_rows=t(self.out_rows).long(), diag_pad=t(self.diag_pad),
            l0_rows=t(self.l0_rows).long(), l0_cols=t(self.l0_cols).long(),
        )


def build_fsai_plan(
    l0_rows: np.ndarray,
    l0_cols: np.ndarray,
    pat_rows: np.ndarray,
    pat_cols: np.ndarray,
    n_pad: int,
    width: int | None = None,
    sentinel: int | None = None,
) -> FSAIPlan:
    """Host build of the generic plan (numpy arrays).

    ``l0_rows / l0_cols``: the tril(A) value-vector sites, sorted by
    (row, col).  ``pat_rows / pat_cols``: the lower-triangular FSAI
    pattern.  ``sentinel``: length of the value vector if it is padded
    past ``len(l0_rows)`` (the padding values must be 0).  Raises
    ValueError if the sites are not sorted, a column is wider than
    ``width`` or misses its diagonal.
    """
    l0_lin = l0_rows.astype(np.int64) * n_pad + l0_cols
    if not np.all(l0_lin[:-1] <= l0_lin[1:]):
        raise ValueError("level-0 sites must be sorted by (row, col)")
    sentinel_val = l0_rows.shape[0] if sentinel is None else int(sentinel)
    w = pattern_col_width(pat_rows, pat_cols) if width is None else width

    order = np.argsort(
        pat_cols.astype(np.int64) * n_pad + pat_rows, kind="stable"
    )
    r_s = pat_rows[order].astype(np.int64)
    c_s = pat_cols[order].astype(np.int64)
    counts = np.bincount(c_s, minlength=n_pad)
    if counts.max(initial=0) > w:
        raise ValueError(
            f"column width {counts.max()} exceeds static width {w}"
        )
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    slot = np.arange(r_s.shape[0]) - starts[c_s]
    s_mat = np.full((n_pad, w), n_pad, np.int64)
    s_mat[c_s, slot] = r_s

    pos = np.argmax(s_mat == np.arange(n_pad)[:, None], axis=1)
    if not (s_mat[np.arange(n_pad), pos] == np.arange(n_pad)).all():
        raise ValueError("FSAI pattern must contain the diagonal")

    # A[S_p, S_q] looked up under the symmetric (hi, lo) key
    p = s_mat[:, :, None]
    q = s_mat[:, None, :]
    in_range = (p < n_pad) & (q < n_pad)
    key = np.where(in_range, np.maximum(p, q) * n_pad + np.minimum(p, q),
                   -1).reshape(-1)
    nnz = l0_lin.shape[0]
    idx = np.searchsorted(l0_lin, key)
    idx_c = np.clip(idx, 0, max(nnz - 1, 0))
    found = (key >= 0) & (idx < nnz) & (l0_lin[idx_c] == key)
    sub_idx = np.where(found, idx_c, sentinel_val).astype(np.int32)

    sc_rows = np.full(sentinel_val, n_pad, np.int32)
    sc_cols = np.zeros(sentinel_val, np.int32)
    sc_rows[:nnz] = l0_rows
    sc_cols[:nnz] = l0_cols
    return FSAIPlan(
        sub_idx=sub_idx.reshape(n_pad, w, w),
        pos=pos.astype(np.int32),
        out_rows=s_mat.astype(np.int32),
        diag_pad=(s_mat == n_pad).astype(np.float32),
        l0_rows=sc_rows,
        l0_cols=sc_cols,
    )


# -- groups of plans ----------------------------------------------------------


def stack_plans(plans):
    """Stack per-case plans of one class and shape into a group plan: every
    array gains a leading case axis (numpy; ``to`` moves the group).  Range
    plans must share H, and either the same static window starts or none
    (then each case keeps its own ``lo``, as the training batches' plans
    do)."""
    first = plans[0]
    arrays = {f.name: np.stack([np.asarray(getattr(p, f.name)) for p in plans])
              for f in fields(first) if f.name not in ("h", "lo_static")}
    if isinstance(first, RangeFSAIPlan):
        if any(p.h != first.h or p.lo_static != first.lo_static
               for p in plans):
            raise ValueError("a range group needs one H and one kind of "
                             "window starts")
        return RangeFSAIPlan(h=first.h, lo_static=first.lo_static, **arrays)
    return FSAIPlan(**arrays)


def take_cases(plan, sel):
    """The cases ``sel`` (a slice or an index tensor) of a group plan."""
    return replace(plan, **{f.name: getattr(plan, f.name)[sel]
                            for f in fields(plan)
                            if f.name not in ("h", "lo_static")})


def _per_case(n0, ndim: int):
    """``n0`` (a number, or one per case of a group) shaped to broadcast
    against a per-case array of ``ndim`` trailing dims."""
    if torch.is_tensor(n0) and n0.dim() == 1:
        return n0.reshape(n0.shape[0], *([1] * ndim))
    return n0


def _live(n_pad: int, n0, device) -> torch.Tensor:
    """(..., n_pad) bool: index < n0, per case for a group."""
    return torch.arange(n_pad, device=device) < _per_case(n0, 1)


# -- device: local solves (both paths) ---------------------------------------


def local_systems(plan, sub: torch.Tensor):
    """The local systems B1 solves: the (..., n_pad, w, w) blocks
    A~[S_j, S_j] made identity on dead slots, and e, the one-hot of each
    column's diagonal slot."""
    w = plan.width
    pad = plan.diag_pad.to(sub.dtype)
    live = 1.0 - pad
    sub = sub * live[..., :, None] * live[..., None, :]
    sub = sub + torch.eye(w, dtype=sub.dtype, device=sub.device) * pad[..., :, None]
    e = torch.zeros_like(pad)
    e.scatter_(-1, plan.pos[..., None], 1.0)
    return sub.contiguous(), e


def _fsai_solve_columns(plan, sub: torch.Tensor, with_aux: bool = False):
    """Shared tail of the FSAI setups: ``local_systems``, kernel B1 for
    the local solves (one launch for every column of every case of a
    group), the Kaporin normalization.  ``with_aux`` also returns
    a_col[..., j, k] = A~[S_j[k], j]."""
    n_pad, w = plan.n_pad, plan.width
    sub, e = local_systems(plan, sub)
    y = masked_gauss_jordan(sub.reshape(-1, w, w), e.reshape(-1, w))
    y = y.reshape(e.shape)
    y_pos = y.gather(-1, plan.pos[..., None])[..., 0]
    c = y / torch.sqrt(torch.clamp(y_pos, min=1e-30))[..., None]
    c = torch.where(plan.out_rows < n_pad, c, 0.0)
    if with_aux:
        a_col = sub.gather(-1, plan.pos[..., None, None].expand(
            *sub.shape[:-1], 1))[..., 0]
        return c, a_col * (1.0 - plan.diag_pad.to(sub.dtype))
    return c


# -- device: generic path ----------------------------------------------------


def fsai_dense_from_l0(plan: FSAIPlan, l0_vals: torch.Tensor) -> torch.Tensor:
    """Dense symmetric scaled matrix A~ from the tril value vector (the
    padded tail lands in a dropped row n_pad); one case or a group."""
    n_pad = plan.n_pad
    flat = plan.l0_rows * n_pad + plan.l0_cols
    a = l0_vals.new_zeros(*l0_vals.shape[:-1], (n_pad + 1) * n_pad)
    a.scatter_add_(-1, flat, l0_vals)
    a = a[..., :n_pad * n_pad].reshape(*l0_vals.shape[:-1], n_pad, n_pad)
    return a + torch.tril(a, -1).mT


def fsai_values_lookup(plan: FSAIPlan, l0_vals: torch.Tensor,
                       with_aux: bool = False):
    """Column values of C (..., n_pad, w) on the generic plan: entry
    [j, k] is C[S_j[k], j], 0 on dead slots.  The local blocks
    A~[S_j, S_j] are looked up in the value vector through the plan's
    ``sub_idx`` (O(n_pad w^2) memory, no dense matrix).  Takes a group
    plan with one value vector per case."""
    return _fsai_solve_columns(plan, lookup_local_blocks(plan, l0_vals),
                               with_aux)


def lookup_local_blocks(plan: FSAIPlan,
                        l0_vals: torch.Tensor) -> torch.Tensor:
    """The (..., n_pad, w, w) local blocks A~[S_j, S_j] of the generic
    path, looked up in the value vector through ``sub_idx`` (its sentinel
    reads 0); one case or a group."""
    vals_ext = torch.cat([l0_vals, l0_vals.new_zeros(*l0_vals.shape[:-1], 1)],
                         dim=-1)
    idx = plan.sub_idx.clamp(max=vals_ext.shape[-1] - 1)
    return vals_ext.gather(-1, idx.flatten(-3)).reshape(idx.shape)


def fsai_dense_factor(plan: FSAIPlan, c_vals: torch.Tensor,
                      d_isqrt: torch.Tensor | None = None,
                      n0=None) -> torch.Tensor:
    """Dense lower-triangular C from the column values; optionally folds
    the Jacobi scaling (C_raw = D^-1/2 C) and masks rows and columns
    >= n0 (per case for a group)."""
    n_pad = plan.n_pad
    j_idx = torch.arange(n_pad, device=c_vals.device)[:, None]
    flat = (plan.out_rows * n_pad + j_idx).flatten(-2)  # row n_pad: dropped
    c = c_vals.new_zeros(*c_vals.shape[:-2], (n_pad + 1) * n_pad)
    c.scatter_add_(-1, flat, c_vals.flatten(-2))
    c = c[..., :n_pad * n_pad].reshape(*c_vals.shape[:-2], n_pad, n_pad)
    if d_isqrt is not None:
        c = d_isqrt[..., :, None] * c
    if n0 is not None:
        mask = _live(n_pad, n0, c.device)
        c = torch.where(mask[..., :, None] & mask[..., None, :], c, 0.0)
    return c


def fsai_dense_preconditioner(
    plan: FSAIPlan,
    l0_vals: torch.Tensor,
    d_isqrt: torch.Tensor | None = None,
    n0=None,
    dtype=torch.float32,
) -> torch.Tensor:
    """Generic FSAI setup: dense M = C C^T (Jacobi scaling folded, rows
    and columns >= n0 masked), computed in ``l0_vals``' dtype and cast to
    ``dtype``, as the reference does; one case or a group."""
    c = fsai_dense_factor(plan, fsai_values_lookup(plan, l0_vals), d_isqrt,
                          n0)
    m = c @ c.transpose(-1, -2)
    if n0 is not None:
        mask = _live(plan.n_pad, n0, m.device)
        m = torch.where(mask[..., :, None] & mask[..., None, :], m, 0.0)
    return m.to(dtype)


# -- device: range-blocked setup ---------------------------------------------


def _windows(plan: RangeFSAIPlan) -> torch.Tensor:
    """(..., B, H) row ids of every block's window: lo_b + [0, H)."""
    return plan.lo[..., :, None] + torch.arange(plan.h,
                                                device=plan.lo.device)


def range_local_blocks(plan: RangeFSAIPlan,
                       a_dense: torch.Tensor) -> torch.Tensor:
    """The (..., n_pad, w, w) local blocks A~[S_j, S_j] of the range path:
    each column's rows lo_b + local (dead slots clamped into the window,
    read and then masked by ``local_systems``), gathered from the dense
    scaled matrix in one ``gather``; a group takes (cases, n_pad, n_pad)."""
    n_pad, h, jb, w = plan.n_pad, plan.h, plan.block_cols, plan.width
    blk = torch.arange(n_pad, device=a_dense.device) // jb
    rows = plan.lo[..., blk][..., None] + plan.local.clamp(max=h - 1)
    idx = rows[..., :, None] * n_pad + rows[..., None, :]
    return a_dense.flatten(-2).gather(-1, idx.flatten(-3)).reshape(
        *rows.shape[:-1], w, w)


def range_fsai_columns(plan: RangeFSAIPlan, a_dense: torch.Tensor,
                       with_aux: bool = False):
    """FSAI column values (..., n_pad, w) via the range-blocked path:
    ``range_local_blocks``, then ``_fsai_solve_columns``.  On a group plan
    with (cases, n_pad, n_pad) operands it is the group form: one B1
    launch for all cases' columns, bit-equal on the CPU to the per-case
    calls.  ``with_aux`` also returns a_col[..., j, k] = A~[S_j[k], j]."""
    return _fsai_solve_columns(plan, range_local_blocks(plan, a_dense),
                               with_aux)


def range_strips(plan: RangeFSAIPlan, c_vals: torch.Tensor) -> torch.Tensor:
    """Column values (..., n_pad, w) -> block-local strips (..., B, JB, H):
    strip[b, jj, h] = C[lo_b + h, b*JB + jj]."""
    n_pad, h, jb = plan.n_pad, plan.h, plan.block_cols
    lead = c_vals.shape[:-2]
    strips = c_vals.new_zeros(*lead, n_pad, h + 1)  # column H: sentinels
    strips.scatter_add_(-1, plan.local, c_vals)
    return strips[..., :h].reshape(*lead, n_pad // jb, jb, h)


def range_m_from_strips(
    plan: RangeFSAIPlan,
    strips: torch.Tensor,
    d_isqrt: torch.Tensor,
    n0,
) -> torch.Tensor:
    """Dense M = C_eff C_eff^T from block-local strips, where
    C_eff = D^-1/2 C (``d_isqrt`` folds the Jacobi scaling into the rows)
    with rows and columns >= n0 masked: per block the (H, H) Gram slab
    G_b = c_b^T c_b, accumulated at (lo_b, lo_b).  Windows overlap, so the
    slabs are added in ascending b: on a plan with static window starts
    (every group) by one slab add per block, on one case's plan by
    ``ops/gram_assembly.gram_assembly`` from the starts on the device."""
    n_pad, h, jb = plan.n_pad, plan.h, plan.block_cols
    b = n_pad // jb
    win = _windows(plan)  # (..., B, H)
    d_win = d_isqrt.to(strips.dtype).gather(-1, win.flatten(-2)).reshape(
        win.shape)
    c_local = strips * d_win[..., :, None, :]
    col_ids = torch.arange(n_pad, device=strips.device).reshape(b, jb)
    n0 = _per_case(n0, 2)
    c_local = torch.where((col_ids < n0)[..., None], c_local, 0.0)
    c_local = torch.where((win < n0)[..., :, None, :], c_local, 0.0)

    g = torch.matmul(c_local.transpose(-1, -2), c_local)  # (..., B, H, H)
    if plan.lo_static is not None:
        m = strips.new_zeros(*strips.shape[:-3], n_pad, n_pad)
        for i, lo in enumerate(plan.lo_static):
            m[..., lo:lo + h, lo:lo + h] += g[..., i, :, :]
        return m
    if win.dim() != 2:
        raise ValueError("a group of plans without static starts has no "
                         "Gram assembly")
    return gram_assembly(g, plan.lo, n_pad)


def range_dense_factor_slabs(plan: RangeFSAIPlan,
                             c_vals: torch.Tensor) -> torch.Tensor:
    """Dense lower-triangular C (scaled space) from range-blocked column
    values: block b's (H, JB) strip slab lands at rows lo_b.., columns
    b JB..; column ranges are disjoint, so the slabs never collide.  One
    scatter, for static and per-case window starts alike; one case or a
    group (``c_vals`` (..., n_pad, w))."""
    n_pad, h, jb = plan.n_pad, plan.h, plan.block_cols
    strips = range_strips(plan, c_vals)  # (..., B, JB, H)
    rows = _windows(plan)[..., :, None, :]  # (..., B, 1, H)
    cols = torch.arange(n_pad, device=c_vals.device).reshape(-1, jb, 1)
    idx = (rows * n_pad + cols).expand(strips.shape)
    c = c_vals.new_zeros(*c_vals.shape[:-2], n_pad * n_pad)
    c = c.scatter(-1, idx.flatten(-3), strips.flatten(-3))
    return c.reshape(*c_vals.shape[:-2], n_pad, n_pad)


def fsai_dense_preconditioner_range(
    plan: RangeFSAIPlan,
    a_dense: torch.Tensor,
    d_isqrt: torch.Tensor,
    n0,
    dtype=torch.float32,
) -> torch.Tensor:
    """Range-blocked FSAI setup: dense M = C C^T on the raw system
    (Jacobi scaling folded, rows and columns >= n0 masked); a group plan
    takes stacked operands, scalings and n0."""
    a_dense = a_dense.to(dtype)
    c_vals = range_fsai_columns(plan, a_dense)
    strips = range_strips(plan, c_vals)
    return range_m_from_strips(plan, strips, d_isqrt, n0)


# -- device: strips and bands of static-start plans ---------------------------


def range_strips_uniform(plan: RangeFSAIPlan,
                         c_vals: torch.Tensor) -> torch.Tensor:
    """Strips (..., B, JB, H) re-based to the uniform window start JB b:
    the tail blocks, whose start the plan clamped to n_pad - H, shift
    left by their clamp (rows >= cols >= JB b, so nothing falls off the
    front).  Needs a static-start plan."""
    if plan.lo_static is None:
        raise ValueError("uniform strips need a static_lo plan")
    h, jb = plan.h, plan.block_cols
    strips = range_strips(plan, c_vals)
    out = strips.clone()
    for b, lo in enumerate(plan.lo_static):
        shift = b * jb - lo
        if shift:
            out[..., b, :, :h - shift] = strips[..., b, :, shift:]
            out[..., b, :, h - shift:] = 0.0
    return out


def window_vector(v: torch.Tensor, jb: int, h: int) -> torch.Tensor:
    """(..., n_pad) -> (..., B, H): w[..., b, h'] = v[..., jb b + h'] (0
    past the end): overlapping stride-JB windows, one strided view."""
    n_pad = v.shape[-1]
    vp = torch.nn.functional.pad(v, (0, h))
    return vp.unfold(-1, h, jb)[..., :n_pad // jb, :]


def strips_to_bands(strips_u: torch.Tensor, jb: int,
                    d_max: int) -> torch.Tensor:
    """Uniform strips (..., B, JB, H) -> diagonal-major bands
    (..., d_max, n_pad): bands[d, jb b + jj] = strips_u[b, jj, jj + d]."""
    *lead, b, jb_, _ = strips_u.shape
    if jb_ != jb:
        raise ValueError(f"strips of {jb_} columns per block, not {jb}")
    sp_ = torch.nn.functional.pad(strips_u, (0, d_max))
    x = torch.stack([sp_[..., jj, jj:jj + d_max] for jj in range(jb)],
                    dim=-2)  # (..., B, JB, D)
    return x.movedim(-1, -3).reshape(*lead, d_max, b * jb)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16, kept in x's dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


def _matmul(precision):
    """The reference's products at ``precision``: None, full precision in
    the operands' dtype (TF32 off on the card); ``"bf16"``, bf16 inputs
    with float32 accumulation.  ``torch.matmul`` on bf16 tensors would
    round its output to bf16, so each operand is rounded to bf16 and
    multiplied in its own dtype: a product of two bf16 values is exact in
    float32, and only the order of the sums differs from XLA's."""
    if precision is None:
        return torch.matmul
    if precision == "bf16":
        return lambda x, y: round_bf16(x) @ round_bf16(y)
    raise ValueError(f"precision {precision!r}: None or 'bf16'")


def poly_preconditioner_dense(
    c_dense: torch.Tensor,  # (..., n, n) scaled-space factor C~
    a_dense: torch.Tensor,  # (..., n, n) scaled symmetric A~
    q_coeffs: torch.Tensor,  # (..., d+1) coefficients of q
    d_isqrt: torch.Tensor | None = None,
    n0=None,
    precision=None,
) -> torch.Tensor:
    """Polynomial-wrapped FSAI, materialized dense:

        M~ = C q(B) q(B)^T C^T,   B = C^T A~ C

    (SPD for any q; q = I gives C C^T), q evaluated by Horner, then the
    Jacobi scaling folded (D^-1/2 M~ D^-1/2) and rows and columns >= n0
    masked.  One case or a batch (leading axes on every operand, ``n0``
    one per case).  Every product at ``precision`` (``_matmul``)."""
    dtype = c_dense.dtype
    n = c_dense.shape[-1]
    mm = _matmul(precision)
    q_coeffs = q_coeffs.to(dtype)[..., None, None]
    bmat = mm(c_dense.mT, mm(a_dense.to(dtype), c_dense))
    eye = torch.eye(n, dtype=dtype, device=c_dense.device)
    q = eye * q_coeffs[..., -1, :, :]
    for i in range(q_coeffs.shape[-3] - 2, -1, -1):
        q = mm(q, bmat) + q_coeffs[..., i, :, :] * eye
    cq = mm(c_dense, q)
    m = mm(cq, cq.mT)
    if d_isqrt is not None:
        d = d_isqrt.to(dtype)
        m = d[..., :, None] * m * d[..., None, :]
    if n0 is not None:
        mask = _live(n, n0, m.device)
        m = torch.where(mask[..., :, None] & mask[..., None, :], m, 0.0)
    return m


def poly_preconditioner_from_gram(
    s_eff: torch.Tensor,  # (..., n, n) effective Gram S = C_eff C_eff^T
    a_raw: torch.Tensor,  # (..., n, n) dense RAW symmetric A
    q_coeffs: torch.Tensor,  # (..., d+1) coefficients of q
    precision=None,
) -> torch.Tensor:
    """Polynomial-wrapped FSAI in Gram form:

        M = C q(B) q(B)^T C^T = sum_k r_k (S A)^k S,  r = q * q,

    with r the true convolution r_k = sum_i q_i q_{k-i} (per case), then
    Horner in T = S A with the S-folded accumulator, then symmetrized.
    One case or a group (leading axes, each case its own q).  With
    ``precision="bf16"`` the operands of each product are rounded as the
    reference rounds them (S and A for T, then T and the accumulator),
    while each ``r_k S`` term is added unrounded."""
    dtype = s_eff.dtype
    q = q_coeffs.to(dtype)
    d = q.shape[-1] - 1
    r = torch.stack([
        sum(q[..., i] * q[..., k - i]
            for i in range(max(0, k - d), min(k, d) + 1))
        for k in range(2 * d + 1)
    ], dim=-1)[..., None, None]
    mm = _matmul(precision)
    t = mm(s_eff, a_raw.to(dtype))
    p = s_eff * r[..., -1, :, :]
    for i in range(r.shape[-3] - 2, -1, -1):
        p = mm(t, p) + r[..., i, :, :] * s_eff
    return 0.5 * (p + p.mT)


# -- the reference's other forms (tests, one-off scripts) ---------------------


def fsai_values_range(plan: RangeFSAIPlan, a_dense: torch.Tensor
                      ) -> torch.Tensor:
    """Column values of C from the range-blocked plan: the reference's
    alias of ``range_fsai_columns``."""
    return range_fsai_columns(plan, a_dense)


def range_dense_factor(plan: RangeFSAIPlan, c_vals: torch.Tensor,
                       d_isqrt: torch.Tensor | None = None,
                       n0=None) -> torch.Tensor:
    """Dense lower-triangular C from range-blocked column values by the
    reference's one-hot placement: strips[j, h] = sum_k c[j, k] O[j, h, k]
    with O[j, h, k] = [local[j, k] == h], then block b's strip placed at
    rows lo_b.. by P[b, n, h] = [n == lo_b + h]; optionally the Jacobi
    scaling folded into the rows and rows and columns >= n0 masked.  One
    case; ``range_dense_factor_slabs`` is the scatter form the port
    runs."""
    n_pad, h, jb = plan.n_pad, plan.h, plan.block_cols
    b = n_pad // jb
    dtype, device = c_vals.dtype, c_vals.device
    one_hot = (plan.local[:, None, :] == torch.arange(
        h, device=device)[None, :, None]).to(dtype)  # (n_pad, H, w)
    strips = torch.einsum("jk,jhk->jh", c_vals, one_hot).reshape(b, jb, h)
    iota_n = torch.arange(n_pad, device=device)[None, :, None]
    iota_h = torch.arange(h, device=device)[None, None, :]
    p = (iota_n == plan.lo[:, None, None] + iota_h).to(dtype)
    c_cols = torch.einsum("bnh,bjh->bnj", p, strips)  # (B, n, JB)
    c = c_cols.movedim(0, 1).reshape(n_pad, n_pad)
    if d_isqrt is not None:
        c = d_isqrt[:, None] * c
    if n0 is not None:
        mask = torch.arange(n_pad, device=device) < n0
        c = torch.where(mask[:, None] & mask[None, :], c, 0.0)
    return c


def fsai_factor_scipy(a: sp.spmatrix, pat_rows: np.ndarray,
                      pat_cols: np.ndarray) -> sp.csc_matrix:
    """Host FSAI factor in float64, column by column: the dense local
    solve A[S_j, S_j] y = e_pos(j) with S_j = {i >= j in the pattern}
    plus j, then c_j = y / sqrt(max(y_pos, 1e-30)).  The oracle of
    ``scripts/residual_parity.py``."""
    n = a.shape[0]
    ad = sp.csr_matrix(a).toarray()
    pat = sp.csc_matrix(
        (np.ones(pat_rows.shape[0]), (pat_rows, pat_cols)), shape=(n, n))
    rows_o, cols_o, vals_o = [], [], []
    for j in range(n):
        s = pat.indices[pat.indptr[j]:pat.indptr[j + 1]]
        s = np.unique(np.append(s[s >= j], j))
        p = int(np.searchsorted(s, j))
        e = np.zeros(len(s))
        e[p] = 1.0
        y = np.linalg.solve(ad[np.ix_(s, s)], e)
        rows_o.append(s)
        cols_o.append(np.full(len(s), j))
        vals_o.append(y / np.sqrt(max(y[p], 1e-30)))
    return sp.csc_matrix(
        (np.concatenate(vals_o),
         (np.concatenate(rows_o), np.concatenate(cols_o))), shape=(n, n))
