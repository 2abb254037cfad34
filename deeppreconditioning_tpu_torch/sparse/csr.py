"""CSR sparse matrix: the host-side exchange format, as tensors.

Counterpart of ``deeppreconditioning_tpu/sparse/csr.py::CSRMatrix``: the
same fields (``indptr``, ``indices`` with sentinel n on padding, ``data``
with 0 on padding, the precomputed entry-to-row map ``row_ids``, the true
dimension ``n``), ``from_scipy`` / ``to_scipy``, ``to_dense`` and a
matvec.  The matvec is plain PyTorch (a gather and an ``index_add_``
over rows), as the reference computes it outside Pallas: there is no
kernel here.  The SpMV of the solvers runs on ELL (``sparse/ell.py``),
DIA (``sparse/dia.py``) or BSR (``sparse/bsr.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch


@dataclass
class CSRMatrix:
    """Square sparse matrix in padded CSR format.

    indptr: int64 (n + 1,) row pointers (into the padded data arrays).
    indices: int64 (nnz_pad,) column indices; sentinel n for padding.
    data: (nnz_pad,) values; 0 in padding.
    row_ids: int64 (nnz_pad,) row of each entry (padding: its clamped
        row, with value 0).
    n: true dimension.
    """

    indptr: torch.Tensor
    indices: torch.Tensor
    data: torch.Tensor
    row_ids: torch.Tensor
    n: int

    @property
    def nnz_pad(self) -> int:
        return self.indices.shape[0]

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x via a gather and a sum of the products per row."""
        return csr_matvec(self, x)

    def to_dense(self) -> torch.Tensor:
        out = self.data.new_zeros(self.n, self.n + 1)
        out.index_put_((self.row_ids, self.indices.clamp(0, self.n)),
                       self.data, accumulate=True)
        return out[:, :self.n]

    def to(self, device) -> "CSRMatrix":
        return CSRMatrix(*(t.to(device) for t in (
            self.indptr, self.indices, self.data, self.row_ids)), n=self.n)

    @staticmethod
    def from_scipy(mat, nnz_pad: int | None = None, dtype=torch.float32,
                   device=None) -> "CSRMatrix":
        """Build from a square scipy matrix (duplicates summed); the
        entry arrays are padded to ``nnz_pad`` (default nnz).  ``device``
        defaults to the CPU (this is a host container)."""
        csr = mat.tocsr()
        csr.sum_duplicates()
        n = csr.shape[0]
        nnz = csr.nnz
        if nnz_pad is None:
            nnz_pad = nnz
        if nnz_pad < nnz:
            raise ValueError(f"nnz_pad {nnz_pad} < nnz {nnz}")
        indices = np.full((nnz_pad,), n, np.int64)
        data = np.zeros((nnz_pad,), np.float64)
        indices[:nnz] = csr.indices
        data[:nnz] = csr.data
        indptr = csr.indptr.astype(np.int64)
        row_ids = np.clip(
            np.searchsorted(indptr, np.arange(nnz_pad), side="right") - 1,
            0, n - 1,
        )

        def t(x):
            return torch.as_tensor(x, device=device)

        return CSRMatrix(indptr=t(indptr), indices=t(indices),
                         data=t(data).to(dtype), row_ids=t(row_ids), n=n)

    def to_scipy(self) -> sp.csr_matrix:
        indptr = self.indptr.cpu().numpy()
        end = int(indptr[-1])
        return sp.csr_matrix(
            (self.data[:end].cpu().numpy(),
             self.indices[:end].cpu().numpy(), indptr),
            shape=(self.n, self.n))


def csr_matvec(a: CSRMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x, x (n,): the products of the entries with x gathered at
    their columns (padding reads the appended 0), summed per row."""
    x_ext = torch.cat([x, x.new_zeros(1)])
    prods = a.data * x_ext[a.indices]
    return prods.new_zeros(a.n).index_add_(0, a.row_ids, prods)
