"""Row partitioning of an ELL matrix over the ranks of a process group.

Counterpart of ``deeppreconditioning_tpu/parallel/partition.py``: a 1-D
partition of the rows into ``n_shards`` contiguous blocks of equal size
(rows padded past n).  Column indices stay global; the distributed
matvec either all-gathers x or exchanges fixed-width halos with the
neighbouring ranks, which is exact when the matrix's bandwidth
max |col - row| (the ``halo``) is at most the rows of one shard
(FVM / Poisson orderings).

``shard_ell_rows`` builds the global host arrays (numpy), as the
reference does on every host; ``ShardedELL.shard`` cuts out one rank's
rows onto its device, with the index maps of the halo matvec's interior
and boundary passes computed there once.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from deeppreconditioning_tpu_torch.sparse.ell import ELLMatrix


@dataclass
class ELLShard:
    """One rank's rows of a ``ShardedELL`` on its device.

    cols, vals: (rows_per_shard, k) global columns (sentinel n_total) and
        values.
    loc: (rows_per_shard, k) int64 column within the shard for the
        interior pass, rows_per_shard (a zero) elsewhere.
    hidx: (rows_per_shard, k) int64 position in [left halo | right halo |
        0] for the boundary pass, 2 * halo_w (the zero) elsewhere.
    """

    cols: torch.Tensor
    vals: torch.Tensor
    loc: torch.Tensor
    hidx: torch.Tensor
    n: int
    n_total: int
    n_shards: int
    halo: int
    rank: int

    @property
    def rows_per_shard(self) -> int:
        return self.n_total // self.n_shards

    @property
    def halo_w(self) -> int:
        """Width of the exchanged slabs (at least 1, as the reference's)."""
        return max(self.halo, 1)


@dataclass
class ShardedELL:
    """An ELL matrix prepared for an ``n_shards``-way row partition (host).

    cols: int64 (n_total, k) global column indices; sentinel n_total.
    vals: (n_total, k) float64 values.
    n: true dimension (n <= n_total; trailing rows empty).
    n_shards: shard count (n_total % n_shards == 0).
    halo: the bandwidth max |col - row| over the real entries: the halo
        matvec is exact iff halo <= rows_per_shard.
    """

    cols: np.ndarray
    vals: np.ndarray
    n: int
    n_shards: int
    halo: int

    @property
    def n_total(self) -> int:
        return self.cols.shape[0]

    @property
    def rows_per_shard(self) -> int:
        return self.n_total // self.n_shards

    def shard(self, rank: int, device, dtype=torch.float32) -> ELLShard:
        """Rank ``rank``'s rows on ``device`` in ``dtype``, with the halo
        matvec's index maps."""
        r = self.rows_per_shard
        lo = rank * r
        cols = self.cols[lo:lo + r].astype(np.int64)
        h = max(self.halo, 1)
        rel = cols - lo
        real = cols < self.n_total
        interior = real & (rel >= 0) & (rel < r)
        loc = np.where(interior, rel, r)
        hidx = np.where(real & (rel < 0), rel + h,
                        np.where(real & (rel >= r), rel - r + h, 2 * h))
        hidx = np.clip(hidx, 0, 2 * h)

        def t(x):
            return torch.as_tensor(x, device=device)

        return ELLShard(
            cols=t(cols), vals=t(self.vals[lo:lo + r]).to(dtype),
            loc=t(loc), hidx=t(hidx), n=self.n, n_total=self.n_total,
            n_shards=self.n_shards, halo=self.halo, rank=rank)


def shard_ell_rows(ell: ELLMatrix, n_shards: int) -> ShardedELL:
    """Prepare an ELLMatrix for an ``n_shards``-way row partition (host):
    pad the rows so the shards are equal, move the sentinel column from
    ell.n_pad to the padded size, measure the bandwidth."""
    cols = ell.cols.cpu().numpy()
    vals = ell.vals.cpu().double().numpy()
    n_pad, k = cols.shape
    rows_per_shard = -(-n_pad // n_shards)
    n_total = rows_per_shard * n_shards

    cols_full = np.full((n_total, k), n_total, np.int64)
    vals_full = np.zeros((n_total, k), np.float64)
    cols_full[:n_pad] = np.where(cols == ell.n_pad, n_total, cols)
    vals_full[:n_pad] = vals

    real = cols_full < n_total
    if real.any():
        rows_idx = np.broadcast_to(np.arange(n_total)[:, None],
                                   cols_full.shape)
        halo = int(np.abs(cols_full[real] - rows_idx[real]).max())
    else:
        halo = 0
    return ShardedELL(cols=cols_full, vals=vals_full, n=ell.n,
                      n_shards=n_shards, halo=halo)


def pad_vector(x: np.ndarray, n_total: int) -> np.ndarray:
    """Zero-pad a global vector to the sharded length."""
    out = np.zeros((n_total,), x.dtype)
    out[: x.shape[0]] = x
    return out
