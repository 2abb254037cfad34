"""ELLPACK sparse matrix: the PCG operator of the main path.

Empty slots store column ``n_pad`` (one past the end) with value 0, and
``matvec`` zero-extends ``x`` by one entry so the gather needs no mask.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp
import torch

from deeppreconditioning_tpu_torch.utils.graphs import UNKEYED


def csr_to_ell_arrays(csr, n_pad: int, sentinel: int | None = None):
    """Vectorized CSR -> padded ELL (cols, vals) host arrays with the
    slot count of the longest row; empty slots get column ``sentinel``
    (default n_pad) and value 0."""
    n = csr.shape[0]
    counts = np.diff(csr.indptr)
    k = max(int(counts.max()) if n and csr.nnz else 0, 1)
    cols = np.full((n_pad, k), n_pad if sentinel is None else sentinel,
                   np.int32)
    vals = np.zeros((n_pad, k), np.float64)
    if csr.nnz:
        row_of = np.repeat(np.arange(n), counts)
        slot = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], counts)
        cols[row_of, slot] = csr.indices
        vals[row_of, slot] = csr.data
    return cols, vals


@dataclass
class ELLMatrix:
    """Square sparse matrix in padded ELLPACK format.

    cols: int64 (n_pad, k) column per slot, sentinel n_pad.
    vals: (n_pad, k) entry values, 0 in empty slots.
    n: true dimension (rows beyond n are all-sentinel); no product reads
        it, so a CUDA graph's key leaves it out (``utils/graphs.py``).
    """

    cols: torch.Tensor
    vals: torch.Tensor
    n: int = field(metadata=UNKEYED)

    @property
    def n_pad(self) -> int:
        return self.cols.shape[0]

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x via gather + row-sum; x has shape (n_pad,)."""
        x_ext = torch.cat([x, x.new_zeros(1)])
        return (self.vals * x_ext[self.cols]).sum(dim=1)

    @staticmethod
    def from_scipy(mat, n_pad: int | None = None, dtype=torch.float32,
                   device=None) -> "ELLMatrix":
        """Build from a square scipy sparse matrix (duplicates summed);
        ``n_pad`` defaults to n rounded up to a multiple of 8."""
        n = mat.shape[0]
        csr = sp.coo_matrix(mat).tocsr()  # canonical: sorted, summed
        if n_pad is None:
            n_pad = ((n + 7) // 8) * 8
        if n_pad < n:
            raise ValueError(f"n_pad={n_pad} < n={n}")
        ell_cols, ell_vals = csr_to_ell_arrays(csr, n_pad)
        return ELLMatrix(
            cols=torch.as_tensor(ell_cols.astype(np.int64), device=device),
            vals=torch.as_tensor(ell_vals, device=device).to(dtype),
            n=n,
        )
