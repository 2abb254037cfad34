"""Classical host preconditioners: the Jacobi diagonal and IC(0).

Counterpart of ``deeppreconditioning_tpu/ops/ic0.py``'s numpy path.  The
factorization is a sequential sparse host step; the device applies the
factor through the level-scheduled or Neumann triangular solves of
``ops/trisolve.py``.  The reference's C++ ``native`` library belongs to
the JAX package and is not used here: this is its numpy fallback, the
reference semantics.  Not here: ``ict_factor`` and ``materialize_normal``
(only the ILU baseline uses them).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def jacobi_preconditioner(a: sp.spmatrix) -> np.ndarray:
    """Inverse-diagonal vector."""
    d = a.tocsr().diagonal()
    return 1.0 / d


def ic0_factor(a: sp.spmatrix) -> sp.csr_matrix:
    """IC(0): lower-triangular L with the sparsity of tril(A), L L^T ~ A.

    Up-looking, row by row; a non-positive pivot restarts with the
    diagonal shifted by alpha * max|diag| (alpha 1e-8, doubling, at most
    40 attempts), so the factorization succeeds for SPD patterns.
    """
    csr = sp.tril(a.tocsr(), format="csr")
    n = csr.shape[0]
    indptr, indices, data = csr.indptr, csr.indices, csr.data
    alpha = 0.0
    diag = csr.diagonal()
    base = np.abs(diag).max() if n else 1.0
    for _attempt in range(40):
        ldata = data.astype(np.float64).copy()
        if alpha:
            # the diagonal entry is the last of each tril CSR row
            ldata[indptr[1:] - 1] += alpha * base
        if _ic0_inplace(n, indptr, indices, ldata):
            return sp.csr_matrix((ldata, indices, indptr), shape=(n, n))
        alpha = max(2 * alpha, 1e-8)
    raise RuntimeError("IC(0) failed even with diagonal shift")


def _ic0_inplace(n, indptr, indices, data) -> bool:
    """Row-wise IC(0) on tril CSR (diagonal last per row); False on a
    non-positive pivot."""
    row_maps = [
        dict(zip(indices[indptr[i]:indptr[i + 1]].tolist(),
                 range(indptr[i], indptr[i + 1])))
        for i in range(n)
    ]
    for i in range(n):
        mi = row_maps[i]
        for idx in range(indptr[i], indptr[i + 1]):
            j = indices[idx]
            s = data[idx]
            # s -= sum_k L[i,k] L[j,k] over k < j in both patterns
            for k, pos_jk in row_maps[j].items():
                if k >= j:
                    continue
                pos_ik = mi.get(k)
                if pos_ik is not None:
                    s -= data[pos_ik] * data[pos_jk]
            if j < i:
                data[idx] = s / data[indptr[j + 1] - 1]
            else:
                if s <= 0:
                    return False
                data[idx] = np.sqrt(s)
    return True
