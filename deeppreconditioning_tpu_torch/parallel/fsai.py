"""Distributed FSAI apply for the sharded PCG: two halo exchanges.

Counterpart of ``deeppreconditioning_tpu/parallel/fsai.py``: the factor
apply z = C (C^T r) of an FSAI factor C over the contiguous row
partition, and the polynomial wrap z = C q(B) q(B)^T C^T r with
B = C^T A C.  C is lower triangular on the FSAI pattern, and for FVM /
Poisson orderings a column's rows lie within a bandwidth of it, like
A's, so both gathers need only a neighbour halo:

    t = C^T r   column j reads rows S_j within [j, j + band]: a RIGHT
                halo of r (the first ``halo`` entries of the right rank);
    z = C t     row i reads columns within [i - band, i]: a LEFT halo of
                t (the last ``halo`` entries of the left rank).

The index maps are built on the host for every shard
(``build_sharded_fsai``, the reference's arrays), so an apply is two
exchanges and two fixed-width gathers with row sums, numerically the
global FSAI apply (not block-truncated as block-Jacobi is).  The edge
ranks exchange only with the neighbour they have (their out-of-domain
slots are never read); at world size 1 nothing is exchanged and the apply
is ``fsai_apply``'s single-device gathers.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from deeppreconditioning_tpu_torch.parallel.multihost import SolverWorld
from deeppreconditioning_tpu_torch.parallel.partition import ELLShard
from deeppreconditioning_tpu_torch.parallel.pcg import (
    exchange_slabs,
    sharded_matvec,
    wait_all,
)


@dataclass
class ShardedFSAI:
    """FSAI factor C prepared for an S-way contiguous row partition
    (host, numpy; every leading axis n_total).

    u_pos: (n_total, w) positions into [r_local | right halo | 0] for
        t_j = sum_k C[S_j[k], j] r[S_j[k]]; sentinel R + halo.
    u_vals: (n_total, w) C[S_j[k], j].
    l_pos: (n_total, wl) positions into [left halo | t_local | 0] for
        z_i = sum over the slots (j, k) with S_j[k] == i; sentinel
        halo + R.
    l_vals: (n_total, wl) the matching C values.
    halo: the factor's column extent bound (at least 1); exact iff
        halo <= rows_per_shard (checked by ``build_sharded_fsai``).
    """

    u_pos: np.ndarray
    u_vals: np.ndarray
    l_pos: np.ndarray
    l_vals: np.ndarray
    halo: int
    n_shards: int

    @property
    def n_total(self) -> int:
        return self.u_pos.shape[0]

    @property
    def rows_per_shard(self) -> int:
        return self.n_total // self.n_shards

    def shard(self, rank: int, device, dtype=torch.float32) -> dict:
        """Rank ``rank``'s rows on ``device``: the apply's ``m_data``."""
        r = self.rows_per_shard
        sl = slice(rank * r, (rank + 1) * r)

        def t(x):
            return torch.as_tensor(x[sl], device=device)

        return {"u_pos": t(self.u_pos).long(),
                "u_vals": t(self.u_vals).to(dtype),
                "l_pos": t(self.l_pos).long(),
                "l_vals": t(self.l_vals).to(dtype), "halo": self.halo}


def build_sharded_fsai(out_rows: np.ndarray, c_vals: np.ndarray,
                       n_shards: int, n_total: int | None = None
                       ) -> ShardedFSAI:
    """Host build: the global FSAI columns (``out_rows`` (n_pad, w), S_j
    with sentinel >= n_pad; ``c_vals`` (n_pad, w), raw-space values, 0 on
    padding) -> each shard's halo gather plan (the reference's arrays).
    Raises ValueError if the factor's bandwidth exceeds a shard's rows."""
    out_rows = np.asarray(out_rows)
    c_vals = np.asarray(c_vals, np.float64)
    n_pad, w = out_rows.shape
    if n_total is None:
        n_total = n_pad
    rps = -(-n_total // n_shards)
    n_total = rps * n_shards

    jj = np.broadcast_to(np.arange(n_pad)[:, None], (n_pad, w))
    live = (out_rows < n_pad) & (c_vals != 0)
    ii = np.where(live, out_rows, jj)  # row of each slot
    halo = int(np.maximum(ii - jj, 0).max(initial=0))
    if halo > rps:
        raise ValueError(f"factor bandwidth {halo} exceeds shard rows {rps};"
                         f" use fewer shards or a single-device apply")
    halo = max(halo, 1)

    # upper pass t_j = sum_k C[i, j] r_i: row i relative to shard(j)'s
    # start, into [r_local (rps) | right halo (halo) | 0]
    shard_start = (np.arange(n_pad) // rps * rps)[:, None]
    u_pos_full = np.full((n_total, w), rps + halo, np.int64)
    u_vals_full = np.zeros((n_total, w), np.float64)
    u_pos_full[:n_pad] = np.where(live, ii - shard_start, rps + halo)
    u_vals_full[:n_pad] = np.where(live, c_vals, 0.0)

    # lower pass z_i = sum C[i, j] t_j: slots grouped by row i (stable),
    # column j relative to shard(i)'s start, into [left halo | t_local | 0]
    ri = ii[live].astype(np.int64)
    cj = jj[live].astype(np.int64)
    cv = c_vals[live]
    wl = int(np.bincount(ri, minlength=1).max(initial=1))
    order = np.argsort(ri, kind="stable")
    ri_s, cj_s, cv_s = ri[order], cj[order], cv[order]
    counts = np.bincount(ri_s, minlength=n_total)
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    slot = np.arange(ri_s.shape[0]) - starts[ri_s]
    l_pos_full = np.full((n_total, wl), halo + rps, np.int64)
    l_vals_full = np.zeros((n_total, wl), np.float64)
    l_pos_full[ri_s, slot] = cj_s - (ri_s // rps) * rps + halo
    l_vals_full[ri_s, slot] = cv_s
    return ShardedFSAI(u_pos=u_pos_full, u_vals=u_vals_full,
                       l_pos=l_pos_full, l_vals=l_vals_full, halo=halo,
                       n_shards=n_shards)


def _ct_gather(m: dict, r_local, from_right):
    r_ext = torch.cat([r_local, from_right, r_local.new_zeros(1)])
    return (m["u_vals"] * r_ext[m["u_pos"]]).sum(dim=1)


def _c_gather(m: dict, t_local, from_left):
    t_ext = torch.cat([from_left, t_local, t_local.new_zeros(1)])
    return (m["l_vals"] * t_ext[m["l_pos"]]).sum(dim=1)


def _ct_local(m: dict, r_local, world: SolverWorld):
    """Shard-local t = C^T r with a right halo of r."""
    h = m["halo"]
    _, from_right, works = exchange_slabs(world, r_local[:h], None, h)
    wait_all(works)
    return _ct_gather(m, r_local, from_right)


def _c_local(m: dict, t_local, world: SolverWorld):
    """Shard-local z = C t with a left halo of t."""
    h = m["halo"]
    from_left, _, works = exchange_slabs(world, None, t_local[-h:], h)
    wait_all(works)
    return _c_gather(m, t_local, from_left)


def fsai_apply(m: dict, r: torch.Tensor) -> torch.Tensor:
    """Single-device z = C (C^T r) on a 1-shard ``ShardedFSAI.shard(0)``:
    the same gathers with empty halos."""
    none = r.new_zeros(m["halo"])
    return _c_gather(m, _ct_gather(m, r, none), none)


def make_fsai_sharded_apply(world: SolverWorld):
    """apply_m for ``pcg_sharded``: z = C (C^T r), exact global FSAI;
    ``m_data`` is this rank's ``ShardedFSAI.shard``."""

    def apply_fn(m_local, r_local):
        return _c_local(m_local, _ct_local(m_local, r_local, world), world)

    return apply_fn


def make_fsai_poly_sharded_apply(world: SolverWorld, degree: int):
    """apply_m for the polynomial-wrapped factor in sharded form:

        z = C q(B) q(B)^T C^T r,   B = C^T A C

    ``m_data`` is this rank's ``ShardedFSAI.shard`` with ``"q"`` (the
    degree + 1 coefficients, on the device) and ``"a"`` (the rank's
    ``ELLShard`` of A) added.  Every B application is neighbour-only
    communication: the C apply (left halo), the halo SpMV, the C^T apply
    (right halo).  q = e_0 reduces to ``make_fsai_sharded_apply``."""

    def apply_fn(m_local, r_local):
        q = m_local["q"]
        a: ELLShard = m_local["a"]

        def b_(t):
            y = sharded_matvec(a, _c_local(m_local, t, world), world, "halo")
            return _ct_local(m_local, y, world)

        def q_(t):
            u = q[degree] * t
            for i in range(degree - 1, -1, -1):
                u = b_(u) + q[i] * t
            return u

        t = q_(q_(_ct_local(m_local, r_local, world)))
        return _c_local(m_local, t, world)

    return apply_fn
