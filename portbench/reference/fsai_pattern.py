"""FSAI patterns of a split of sludge cases, worked out from the raw
systems (numpy / scipy only).

Frozen copies of the pattern rules the per-case learned setup applies:
the Jacobi-scaled tril sites with identity padding to n_pad, the
structural pattern tril(|A|^power), its cap to ``width`` entries a column
by |A|^power magnitude where a column is wider, and the split-wide cap on
how far below its column an entry may lie: with JB = 8 columns a block,
each case's widest block row spread that is at most max(n_pad / 4, 128)
sets the window height H (a multiple of 128); where H > 128 and the rows
more than H - 136 below their column are at most 2% of the split's
pattern entries, those entries go and H drops by 128.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

JB = 8


def scaled_tril(case, n_pad: int):
    """(rows, cols, vals, diag): the tril of D^-1/2 A D^-1/2 with a unit
    diagonal on the padding rows n..n_pad-1, sorted by (row, col), and
    diag(A)."""
    keep = case.rows >= case.cols
    rows, cols, vals = case.rows[keep], case.cols[keep], case.vals[keep]
    n = case.n
    diag = np.ones(n)
    on_diag = rows == cols
    diag[rows[on_diag]] = vals[on_diag]
    d_isqrt = 1.0 / np.sqrt(diag)
    vals = vals * d_isqrt[rows] * d_isqrt[cols]
    extra = np.arange(n, n_pad)
    rows = np.concatenate([rows, extra]).astype(np.int64)
    cols = np.concatenate([cols, extra]).astype(np.int64)
    vals = np.concatenate([vals, np.ones(extra.shape[0])])
    order = np.argsort(rows * n_pad + cols, kind="stable")
    return rows[order], cols[order], vals[order], diag


def tril_power_pattern(rows, cols, n: int, power: int):
    ones = np.ones(rows.shape[0], np.int8)
    a = sp.csr_matrix((ones, (rows, cols)), shape=(n, n))
    a = ((a + a.T) > 0).astype(np.int8)
    p = a
    for _ in range(power - 1):
        p = ((p @ a) > 0).astype(np.int8)
    p = sp.tril(p).tocoo()
    order = np.argsort(p.col.astype(np.int64) * n + p.row, kind="stable")
    return p.row[order].astype(np.int64), p.col[order].astype(np.int64)


def tril_power_pattern_capped(rows, cols, vals, n: int, power: int,
                              width: int):
    a = sp.csr_matrix((np.abs(vals), (rows, cols)), shape=(n, n))
    a = a + sp.tril(a, -1).T
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
                sel = np.concatenate([order[:width - 1],
                                      np.flatnonzero(is_diag)])
            idx = idx[sel]
        keep_r.append(idx)
        keep_c.append(np.full(idx.shape[0], j, idx.dtype))
    pr = np.concatenate(keep_r).astype(np.int64)
    pc = np.concatenate(keep_c).astype(np.int64)
    order = np.argsort(pc * n + pr, kind="stable")
    return pr[order], pc[order]


def _col_width(pc) -> int:
    return int(np.bincount(pc).max(initial=1))


def split_patterns(cases, n_pad: int, power: int, width: int) -> list:
    """Per case, its pattern as (pattern rows, pattern cols), sorted by
    (col, row)."""
    sites = [scaled_tril(c, n_pad) for c in cases]
    pats = [tril_power_pattern(r, c, n_pad, power) for r, c, _, _ in sites]
    spread_cap = max(n_pad // 4, 128)
    spread = 1
    for pr, pc in pats:
        lo = np.full(n_pad // JB, n_pad, np.int64)
        hi = np.full(n_pad // JB, -1, np.int64)
        np.minimum.at(lo, pc // JB, pr)
        np.maximum.at(hi, pc // JB, pr)
        case_spread = int((hi - lo + 1)[hi >= 0].max(initial=1))
        if case_spread <= spread_cap:
            spread = max(spread, case_spread)
    range_h = int(np.ceil(spread / 128) * 128)
    cap = None
    if range_h > 128:
        cap_try = range_h - 128 - 8
        total = sum(pr.shape[0] for pr, _ in pats)
        beyond = sum(int(((pr - pc) > cap_try).sum()) for pr, pc in pats)
        if total and beyond <= 0.02 * total:
            cap = cap_try
    def capped(pr, pc):
        if cap is None:
            return pr, pc
        keep = (pr - pc) <= cap
        return pr[keep], pc[keep]

    out = []
    for (r0, c0, vals, _), (pr, pc) in zip(sites, pats):
        pr, pc = capped(pr, pc)
        if _col_width(pc) > width:
            pr, pc = capped(*tril_power_pattern_capped(
                r0, c0, vals, n_pad, power, width))
        out.append((pr, pc))
    return out


def column_rows(pr, pc, n: int, width: int) -> np.ndarray:
    """(n, width) rows of each live column's pattern in ascending order,
    -1 on the unused slots."""
    live = pc < n
    pr, pc = pr[live], pc[live]
    counts = np.bincount(pc, minlength=n)
    if counts.max(initial=0) > width:
        raise ValueError("pattern wider than the model")
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    slot = np.arange(pr.shape[0]) - starts[pc]
    s = np.full((n, width), -1, np.int64)
    s[pc, slot] = pr
    return s
