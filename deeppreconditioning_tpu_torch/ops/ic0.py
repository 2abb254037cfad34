"""Classical host preconditioners: the Jacobi diagonal, IC(0) and ICT.

Counterpart of ``deeppreconditioning_tpu/ops/ic0.py``.  The factorizations
are sequential sparse host steps; the device applies the factor through
the level-scheduled or Neumann triangular solves of ``ops/trisolve.py``.
They run in the port's host runtime (``native``: ``csrc/host_runtime.cpp``)
whenever it is available, as the reference runs its ``native`` library;
the numpy versions here (``_ic0_inplace``, ``_ict_dense``) are the
fallback, counted as such, and the oracle of the tests.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from deeppreconditioning_tpu_torch import _backend, native


def jacobi_preconditioner(a: sp.spmatrix) -> np.ndarray:
    """Inverse-diagonal vector."""
    d = a.tocsr().diagonal()
    return 1.0 / d


def ic0_factor(a: sp.spmatrix) -> sp.csr_matrix:
    """IC(0): lower-triangular L with the sparsity of tril(A), L L^T ~ A.

    Up-looking, row by row (``native.ic0``, else ``_ic0_inplace``); a
    non-positive pivot restarts with the diagonal shifted by alpha *
    max|diag| (alpha 1e-8, doubling, at most 40 attempts), so the
    factorization succeeds for SPD patterns.
    """
    csr = sp.tril(a.tocsr(), format="csr")
    n = csr.shape[0]
    indptr, indices, data = csr.indptr, csr.indices, csr.data
    use_native = native.available()
    if not use_native:
        _backend.count_host_fallback("ic0")
    alpha = 0.0
    diag = csr.diagonal()
    base = np.abs(diag).max() if n else 1.0
    for _attempt in range(40):
        ldata = data.astype(np.float64).copy()
        if alpha:
            # the diagonal entry is the last of each tril CSR row
            ldata[indptr[1:] - 1] += alpha * base
        if use_native:
            ok = native.ic0(indptr, indices, ldata) == 0
        else:
            ok = _ic0_inplace(n, indptr, indices, ldata)
        if ok:
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


def ict_factor(a: sp.spmatrix, add_fill_in: int = 1,
               threshold: float = 0.1) -> sp.csr_matrix:
    """ICT: incomplete Cholesky with threshold dropping and limited fill.

    Per row, entries with |l_ij| below ``threshold`` times the row's norm
    are dropped and at most nnz_row(A) + ``add_fill_in`` survive (the
    knobs of ilupp's ``icholt``).  The sparse left-looking ``native.ict``
    when the host runtime is available, else ``_ict_dense``.  The two are
    different algorithms with their own drop rules, as in the reference.
    """
    if native.available():
        full = a.tocsr()
        full.sum_duplicates()
        full.sort_indices()
        l_indptr, l_indices, l_data = native.ict(
            full.indptr, full.indices, full.data, add_fill_in, threshold)
        return sp.csr_matrix((l_data, l_indices, l_indptr),
                             shape=full.shape)
    _backend.count_host_fallback("ict")
    return _ict_dense(a, add_fill_in, threshold)


def _ict_dense(a: sp.spmatrix, add_fill_in: int,
               threshold: float) -> sp.csr_matrix:
    """Dense left-looking ICT on tril(A) (O(n^2) work per row)."""
    csr = sp.tril(a.tocsr(), format="csr")
    n = csr.shape[0]
    nnz_row = np.diff(csr.indptr)
    dense = csr.toarray()
    dense = dense + np.tril(dense, -1).T  # full symmetric A
    l_out = np.zeros((n, n))
    for i in range(n):
        for j in range(i):
            if l_out[j, j] == 0:
                continue
            lij = dense[i, j] - l_out[i, :j] @ l_out[j, :j]
            l_out[i, j] = lij / l_out[j, j]
        # threshold dropping and the fill cap on the strictly-lower part
        row = l_out[i, :i]
        norm = np.linalg.norm(row)
        if norm > 0:
            row[np.abs(row) < threshold * norm] = 0.0
            budget = int(nnz_row[i]) + add_fill_in
            nz = np.nonzero(row)[0]
            if nz.size > budget:
                keep = nz[np.argsort(-np.abs(row[nz]))[:budget]]
                mask = np.ones(i, bool)
                mask[keep] = False
                row[mask] = 0.0
        pivot = dense[i, i] - row @ row
        l_out[i, i] = np.sqrt(max(pivot, 1e-12))
    return sp.csr_matrix(np.tril(l_out))


def materialize_normal(l_factor: sp.spmatrix) -> sp.csr_matrix:
    """M = L L^T as CSR: the reference's IC apply convention, z = M r."""
    lf = l_factor.tocsr()
    return (lf @ lf.T).tocsr()
