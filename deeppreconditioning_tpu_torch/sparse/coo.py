"""Batched COO sparse tensor: the training batches' exchange format.

Counterpart of ``deeppreconditioning_tpu/sparse/coo.py``: a batch of
sparse matrices stored as one flat list of ``(batch, row, col)`` index
triplets with per-entry values, nnz padded to a bucket.  A ``valid`` mask
marks the real entries; padded entries carry index (0, 0, 0) and value 0,
and every op masks before it scatters, so padding is inert.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple

import numpy as np
import torch


def pad_to_bucket(n: int, bucket: int = 256) -> int:
    """Round up to a multiple of ``bucket`` (>= bucket)."""
    if n <= 0:
        return bucket
    return ((n + bucket - 1) // bucket) * bucket


@dataclass(frozen=True)
class BatchedCOO:
    """A batch of sparse matrices in padded COO format.

    Attributes:
        indices: int64 (nnz_pad, 3), columns (batch, row, col).
        values: float (nnz_pad,) or (nnz_pad, C).
        valid: bool (nnz_pad,), True for real entries.
        batch_size: number of matrices.
        spatial_shape: (H, W), the dense shape of each matrix.
    """

    indices: torch.Tensor
    values: torch.Tensor
    valid: torch.Tensor
    batch_size: int
    spatial_shape: Tuple[int, int]

    @property
    def nnz_pad(self) -> int:
        return self.indices.shape[0]

    @property
    def n(self) -> int:
        return self.spatial_shape[0]

    def replace_values(self, values: torch.Tensor) -> "BatchedCOO":
        """A copy with new values (masked by ``valid``)."""
        mask = self.valid if values.dim() == 1 else self.valid[:, None]
        return replace(self, values=torch.where(mask, values, 0.0))

    def masked_values(self) -> torch.Tensor:
        mask = self.valid if self.values.dim() == 1 else self.valid[:, None]
        return torch.where(mask, self.values, 0.0)

    def to_dense(self) -> torch.Tensor:
        """Scatter to a dense (B, H, W) tensor (scalar values only)."""
        vals = self.masked_values()
        if vals.dim() > 1:
            vals = vals[..., 0]
        h, w = self.spatial_shape
        lin = (self.indices[:, 0] * h + self.indices[:, 1]) * w \
            + self.indices[:, 2]
        out = vals.new_zeros(self.batch_size * h * w)
        return out.index_add(0, lin, vals).reshape(self.batch_size, h, w)

    @staticmethod
    def from_numpy(
        indices: np.ndarray,
        values: np.ndarray,
        batch_size: int,
        spatial_shape: Tuple[int, int],
        bucket: int = 256,
        dtype=torch.float32,
        device="cpu",
    ) -> "BatchedCOO":
        """Build from host arrays, padding nnz to a bucket."""
        nnz = indices.shape[0]
        nnz_pad = pad_to_bucket(nnz, bucket)
        idx = np.zeros((nnz_pad, 3), np.int64)
        idx[:nnz] = indices
        val = np.zeros((nnz_pad,) + values.shape[1:], np.float64)
        val[:nnz] = values
        valid = np.zeros((nnz_pad,), bool)
        valid[:nnz] = True
        return BatchedCOO(
            indices=torch.as_tensor(idx, device=device),
            values=torch.as_tensor(val, dtype=dtype, device=device),
            valid=torch.as_tensor(valid, device=device),
            batch_size=batch_size,
            spatial_shape=tuple(spatial_shape),
        )


def batched_coo_matvec(
    coo: BatchedCOO, vectors: torch.Tensor, transpose: bool = False
) -> torch.Tensor:
    """out[b] = A_b @ vectors[b] (A_b^T with ``transpose``): gather the
    vector entries by column, multiply by the values, scatter-add into
    rows, over the whole batch at once.  vectors: (B, n)."""
    vals = coo.masked_values()
    if vals.dim() > 1:
        vals = vals[..., 0]
    b = coo.indices[:, 0]
    r = coo.indices[:, 2 if transpose else 1]
    c = coo.indices[:, 1 if transpose else 2]
    prods = vals * vectors[b, c]
    n = vectors.shape[1]
    out = vectors.new_zeros(vectors.numel())
    return out.index_add(0, b * n + r, prods).reshape(vectors.shape)
