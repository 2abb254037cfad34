"""Sparse triangular solves for factored preconditioners: z = L^-T L^-1 r.

Counterpart of ``deeppreconditioning_tpu/ops/trisolve.py``.

Level scheduling (host ``build_tri_schedule``): rows are grouped into
levels such that every row depends only on rows of earlier levels, and
each level is packed into a padded ELL block, with the reference's
shapes (levels rounded up to ``level_bucket``, rows per level to
``row_bucket``; sentinel row and column n_pad).  On the device
(``tri_solve_lower``) each level is one wave,
``x[rows] = (b[rows] - sum_k vals * x[cols]) / diag``: a gather, a
row-sum, a divide and an indexed write.  The reference runs the padded
levels in one ``lax.scan``; here a Python loop runs the levels with
their padding rows dropped (``TriSchedule.to`` builds those waves): a
padding row only writes the dropped slot n_pad and an all-padding level
writes nothing, so the result is the same.

Truncated Neumann apply (``build_tri_neumann`` / ``neumann_ic_apply``):
``sweeps`` Jacobi sweeps on L and on L^T, each one ELL matvec, so the
operator G^T G with G ~ L^-1 stays SPD.  The reference forms L^T's
matvec as a scatter-add of L's ELL entries; here L^T has its own ELL
arrays (``t_cols`` / ``t_vals``), a gather with the same sums.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import scipy.sparse as sp
import torch

from deeppreconditioning_tpu_torch import _backend, native
from deeppreconditioning_tpu_torch.sparse.ell import csr_to_ell_arrays


def _round_up(n: int, m: int) -> int:
    return ((max(n, 1) + m - 1) // m) * m


def compute_levels(l_csr: sp.csr_matrix) -> np.ndarray:
    """level[i] = longest dependency chain ending at row i (host:
    ``native.levels`` when the host runtime is available, else the numpy
    loop, counted as its fallback)."""
    n = l_csr.shape[0]
    indptr, indices = l_csr.indptr, l_csr.indices
    if native.available() and n:
        return native.levels(indptr, indices)
    if n:
        _backend.count_host_fallback("levels")
    levels = np.zeros(n, np.int32)
    for i in range(n):
        deps = indices[indptr[i]:indptr[i + 1]]
        deps = deps[deps < i]
        if deps.size:
            levels[i] = levels[deps].max() + 1
    return levels


@dataclass
class TriSchedule:
    """Level-scheduled lower-triangular matrix (L levels, R rows per
    level, K off-diagonal slots per row).

    rows: (L, R) row per slot, sentinel n_pad.
    cols: (L, R, K) strictly-lower columns, sentinel n_pad.
    vals: (L, R, K) their values.
    diag: (L, R) diagonal per row, 1 on padding.
    ``build_tri_schedule`` gives these as numpy arrays; ``to`` adds the
    per-level waves the solve runs, on the device.
    """

    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    diag: np.ndarray
    n: int
    n_pad: int
    waves: tuple = ()

    @property
    def n_levels(self) -> int:
        return self.rows.shape[0]

    def to(self, device, dtype=torch.float32) -> "TriSchedule":
        """The schedule with its waves on ``device`` (values in ``dtype``):
        per level that holds a live row, its live (rows, cols, vals,
        diag), all levels moved in one copy per array and split into
        views."""
        live = self.rows < self.n_pad
        sizes = live.sum(axis=1)
        sizes = sizes[sizes > 0].tolist()

        def t(x, float_=False):
            out = torch.as_tensor(x[live], device=device)
            return out.to(dtype) if float_ else out.long()

        parts = [torch.split(x, sizes) for x in (
            t(self.rows), t(self.cols), t(self.vals, True),
            t(self.diag, True))]
        return replace(self, waves=tuple(zip(*parts)))


def build_tri_schedule(l_factor: sp.spmatrix, n_pad: int | None = None,
                       level_bucket: int = 8,
                       row_bucket: int = 64) -> TriSchedule:
    """The padded level schedule of a lower-triangular factor (host,
    numpy arrays; the reference's shapes and packing)."""
    csr = sp.tril(l_factor.tocsr(), format="csr")
    n = csr.shape[0]
    if n_pad is None:
        n_pad = ((n + 7) // 8) * 8
    levels = compute_levels(csr)
    n_levels_true = int(levels.max()) + 1 if n else 1

    diag_all = csr.diagonal()
    if not (diag_all != 0).all():
        raise ValueError("singular triangular factor")

    level_sizes = np.bincount(levels, minlength=n_levels_true)
    rows_pad = _round_up(int(level_sizes.max()), row_bucket)
    n_levels = _round_up(n_levels_true, level_bucket)

    # sort rows by (level, row); slot = rank inside the level
    order = np.lexsort((np.arange(n), levels))
    level_of = levels[order]
    starts = np.zeros(n_levels_true + 1, np.int64)
    np.cumsum(level_sizes, out=starts[1:])
    slot_of = np.arange(n) - starts[level_of]

    strict = sp.tril(csr, k=-1).tocsr()
    ecols, evals = csr_to_ell_arrays(strict, n, sentinel=n_pad)
    k = ecols.shape[1]

    rows = np.full((n_levels, rows_pad), n_pad, np.int32)
    cols = np.full((n_levels, rows_pad, k), n_pad, np.int32)
    vals = np.zeros((n_levels, rows_pad, k), np.float64)
    diag = np.ones((n_levels, rows_pad), np.float64)
    rows[level_of, slot_of] = order
    diag[level_of, slot_of] = diag_all[order]
    cols[level_of, slot_of] = ecols[order]
    vals[level_of, slot_of] = evals[order]
    return TriSchedule(rows=rows, cols=cols, vals=vals, diag=diag, n=n,
                       n_pad=n_pad)


def tri_solve_lower(schedule: TriSchedule, b: torch.Tensor) -> torch.Tensor:
    """Solve L x = b; b (n_pad,) -> x (n_pad,).  ``schedule`` from
    ``TriSchedule.to``.  Each wave is a gather of x, a row-sum, the
    divide and an indexed copy into x."""
    x = b.new_zeros(schedule.n_pad + 1)  # slot n_pad reads as 0
    for rows, cols, vals, diag in schedule.waves:
        gathered = x.index_select(0, cols.reshape(-1)).view(cols.shape)
        acc = (vals * gathered).sum(dim=1)
        x.index_copy_(0, rows, (b.index_select(0, rows) - acc) / diag)
    return x[:-1]


def transpose_schedule(l_factor: sp.spmatrix,
                       n_pad: int | None = None) -> TriSchedule:
    """Schedule for L^T x = b as the lower-triangular schedule of the
    order-reversed problem (rows and columns flipped)."""
    csr = sp.tril(l_factor.tocsr(), format="csr")
    n = csr.shape[0]
    perm = np.arange(n)[::-1]
    flipped = csr.T.tocsr()[perm][:, perm].tocsr()
    return build_tri_schedule(flipped, n_pad=n_pad)


def _reverse_index(n: int, n_pad: int, device) -> torch.Tensor:
    idx = torch.arange(n_pad, device=device)
    return torch.where(idx < n, n - 1 - idx, idx)


def tri_solve_upper_from_flipped(schedule: TriSchedule,
                                 b: torch.Tensor) -> torch.Tensor:
    """Solve L^T x = b with the flipped schedule of
    ``transpose_schedule``."""
    rev = _reverse_index(schedule.n, schedule.n_pad, b.device)
    return tri_solve_lower(schedule, b.index_select(0, rev)).index_select(
        0, rev)


def ic_apply(lower: TriSchedule, upper_flipped: TriSchedule,
             r: torch.Tensor) -> torch.Tensor:
    """z = L^-T (L^-1 r)."""
    return tri_solve_upper_from_flipped(upper_flipped,
                                        tri_solve_lower(lower, r))


@dataclass
class TriNeumann:
    """Strictly-lower part of L in ELL form (cols sentinel n_pad), its
    transpose in ELL form, and the inverse diagonal (0 on padding)."""

    cols: object  # (n_pad, k)
    vals: object  # (n_pad, k)
    t_cols: object  # (n_pad, kt): L^T's strictly-upper part by rows
    t_vals: object
    inv_diag: object  # (n_pad,)
    sweeps: int
    n: int

    def to(self, device, dtype=torch.float32) -> "TriNeumann":
        def t(x, float_=False):
            out = torch.as_tensor(np.asarray(x), device=device)
            return out.to(dtype) if float_ else out.long()

        return TriNeumann(cols=t(self.cols), vals=t(self.vals, True),
                          t_cols=t(self.t_cols), t_vals=t(self.t_vals, True),
                          inv_diag=t(self.inv_diag, True),
                          sweeps=self.sweeps, n=self.n)


def build_tri_neumann(l_factor: sp.spmatrix, sweeps: int,
                      n_pad: int | None = None,
                      k_bucket: int = 4) -> TriNeumann:
    """The Neumann apply operator of a lower-triangular factor (host,
    numpy arrays); the ELL width of L's strict part is rounded up to
    ``k_bucket``, as in the reference."""
    csr = sp.tril(l_factor.tocsr(), format="csr")
    n = csr.shape[0]
    if n_pad is None:
        n_pad = ((n + 7) // 8) * 8
    diag = csr.diagonal()
    strict = sp.tril(csr, k=-1).tocsr()
    cols, vals = csr_to_ell_arrays(strict, n_pad)
    k = cols.shape[1]
    k_pad = _round_up(k, k_bucket)
    if k_pad != k:
        cols = np.concatenate(
            [cols, np.full((n_pad, k_pad - k), n_pad, cols.dtype)], axis=1)
        vals = np.concatenate(
            [vals, np.zeros((n_pad, k_pad - k), vals.dtype)], axis=1)
    t_cols, t_vals = csr_to_ell_arrays(strict.T.tocsr(), n_pad)
    inv_diag = np.zeros(n_pad)
    inv_diag[:n] = 1.0 / diag
    return TriNeumann(cols=cols, vals=vals, t_cols=t_cols, t_vals=t_vals,
                      inv_diag=inv_diag, sweeps=sweeps, n=n)


def _ell_matvec(cols, vals, y: torch.Tensor) -> torch.Tensor:
    """ELL matvec of y (..., n_pad): a batch of vectors applies at once."""
    y_ext = torch.cat([y, y.new_zeros(*y.shape[:-1], 1)], dim=-1)
    return (vals * y_ext[..., cols]).sum(dim=-1)


def neumann_lower_solve(op: TriNeumann, r: torch.Tensor) -> torch.Tensor:
    """y ~ L^-1 r by ``sweeps`` Jacobi sweeps (exact once sweeps >= the
    dependency depth)."""
    y = op.inv_diag * r
    for _ in range(op.sweeps):
        y = op.inv_diag * (r - _ell_matvec(op.cols, op.vals, y))
    return y


def neumann_ic_apply(op: TriNeumann, r: torch.Tensor) -> torch.Tensor:
    """z = G^T (G r) with G ~ L^-1: sweeps on L, then on L^T."""
    y = neumann_lower_solve(op, r)
    z = op.inv_diag * y
    for _ in range(op.sweeps):
        z = op.inv_diag * (y - _ell_matvec(op.t_cols, op.t_vals, z))
    return z
