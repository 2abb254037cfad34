"""DIA (diagonal) sparse format: the structured-grid SpMV layout.

Counterpart of ``deeppreconditioning_tpu/sparse/dia.py``.  A banded matrix
keeps one value array per diagonal offset, and

    y[i] = sum_d  vals[d][i] * x[i + off_d]

reads x at static shifts, with no gather.  ``DIAMatrix.matvec`` is the
plain PyTorch version of kernel B2 (``ops/dia_spmv.py``), which every
caller reaches through ``ops.dia_spmv.dia_matvec``.  The values may carry
a leading batch axis, (S, n_diag, n_pad) with x (S, n_pad): S operators
of one band layout (the structured trainer's samples).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from deeppreconditioning_tpu_torch import _backend
from deeppreconditioning_tpu_torch.utils.graphs import UNKEYED


def pad_rows(n: int, mult: int = 1024) -> int:
    """``n`` rounded up to a multiple of ``mult`` (the DIA row padding)."""
    return ((n + mult - 1) // mult) * mult


@dataclass
class DIAMatrix:
    """Square banded matrix as per-offset diagonal value arrays.

    vals: (n_diag, n_pad), or (S, n_diag, n_pad) for S operators;
        vals[..., d, i] multiplies x[..., i + offsets[d]] and is zero
        where i + offset leaves the matrix.
    offsets: static tuple of diagonal offsets (may be negative).
    n: true dimension (rows n..n_pad-1 are zero); no product reads it, so
        a CUDA graph's key leaves it out (``utils/graphs.py``).
    launch_plan: kernel B2's launch plan (``ops.dia_spmv.launch_plan``),
        built on the first CUDA product and kept while ``vals`` keeps its
        address, shape, dtype and device.
    """

    vals: torch.Tensor
    offsets: Tuple[int, ...]
    n: int = field(metadata=UNKEYED)
    launch_plan: object = field(default=None, init=False, repr=False,
                                compare=False)

    @property
    def n_pad(self) -> int:
        return self.vals.shape[-1]

    @property
    def halo(self) -> int:
        return max(abs(o) for o in self.offsets) if self.offsets else 0

    def to_scipy(self):
        """Exact scipy CSR of the true n x n matrix (vals is indexed by
        ROW, scipy's DIA data by column)."""
        v = self.vals.double().cpu().numpy()
        rows, cols, data = [], [], []
        for d, off in enumerate(self.offsets):
            i0, i1 = max(0, -off), min(self.n, self.n - off)
            if i1 <= i0:
                continue
            i = np.arange(i0, i1)
            rows.append(i)
            cols.append(i + off)
            data.append(v[d, i0:i1])
        m = sp.csr_matrix(
            (np.concatenate(data),
             (np.concatenate(rows), np.concatenate(cols))),
            shape=(self.n, self.n),
        )
        m.eliminate_zeros()
        return m

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x: shifted reads of a zero-extended x, accumulated in
        band order (the plain version of kernel B2); batched values take a
        batched x."""
        _backend.count_plain("dia_spmv", x)
        h = self.halo
        x_ext = F.pad(x, (h, h))
        y = torch.zeros_like(x)
        for d, off in enumerate(self.offsets):
            y = y + self.vals[..., d, :] * x_ext[..., h + off:h + off
                                                 + self.n_pad]
        return y

    def transpose(self) -> "DIAMatrix":
        """A^T of the n_pad x n_pad operator ``matvec`` applies, in DIA
        form: offsets negated, band d re-based as
        vals_t[..., d, i] = vals[..., d, i - off_d] (zero where
        i - off_d leaves [0, n_pad)), so entries that ``matvec`` never
        reads stay out."""
        n_pad = self.n_pad
        rows = []
        for d, off in enumerate(self.offsets):
            band = self.vals[..., d, :]
            if off >= 0:
                rows.append(F.pad(band[..., :n_pad - off], (off, 0)))
            else:
                rows.append(F.pad(band[..., -off:], (0, -off)))
        return DIAMatrix(vals=torch.stack(rows, dim=-2),
                         offsets=tuple(-o for o in self.offsets), n=self.n)

    def to_dense(self) -> torch.Tensor:
        n = self.n
        out = torch.zeros((n, n), dtype=self.vals.dtype,
                          device=self.vals.device)
        idx = torch.arange(n, device=self.vals.device)
        for d, off in enumerate(self.offsets):
            cols = idx + off
            ok = (cols >= 0) & (cols < n)
            out.index_put_((idx[ok], cols[ok]), self.vals[d, :n][ok],
                           accumulate=True)
        return out

    @staticmethod
    def from_scipy(mat, dtype=torch.float32, device=None) -> "DIAMatrix":
        dia = mat.todia()
        n = mat.shape[0]
        n_pad = pad_rows(n)
        offsets = tuple(int(o) for o in dia.offsets)
        vals = np.zeros((len(offsets), n_pad), np.float64)
        # scipy DIA: data[d, j] sits at column j, row j - offset, so
        # vals[d, i] = A[i, i + off] = dia.data[d, i + off]
        for d, off in enumerate(offsets):
            col = np.arange(n) + off
            ok = (col >= 0) & (col < n)
            vals[d, np.arange(n)[ok]] = dia.data[d][col[ok]]
        return DIAMatrix(
            vals=torch.tensor(vals, dtype=dtype, device=device),
            offsets=offsets, n=n,
        )


def poisson_dia(shape: Tuple[int, ...], dtype=torch.float32,
                device=None) -> DIAMatrix:
    """Standard 5/7-point Poisson operator on a 2-D/3-D grid as DIA:
    Dirichlet boundaries drop the links that cross a grid face, the
    diagonal stays 2*ndim."""
    ndim = len(shape)
    n = int(np.prod(shape))
    n_pad = pad_rows(n)
    strides = [int(np.prod(shape[i + 1:])) for i in range(ndim)]
    offsets = []
    for s in strides:
        offsets += [-s, s]
    offsets = tuple(sorted(set(offsets) | {0}))

    vals = np.zeros((len(offsets), n_pad), np.float64)
    idx = np.arange(n)
    coords = np.unravel_index(idx, shape)
    for d, off in enumerate(offsets):
        if off == 0:
            vals[d, :n] = 2.0 * ndim
            continue
        axis = strides.index(abs(off))
        if off < 0:
            ok = coords[axis] > 0
        else:
            ok = coords[axis] < shape[axis] - 1
        vals[d, idx[ok]] = -1.0
    return DIAMatrix(
        vals=torch.tensor(vals, dtype=dtype, device=device),
        offsets=offsets, n=n,
    )
