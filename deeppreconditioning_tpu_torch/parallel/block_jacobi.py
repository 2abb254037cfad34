"""Block-Jacobi incomplete Cholesky for the distributed PCG.

Counterpart of ``deeppreconditioning_tpu/parallel/block_jacobi.py``:
each rank factors its own diagonal block A_ss with IC(0) (the host
runtime's ``ic0``, as ``ops/ic0.ic0_factor`` does it) and applies
z_s = G_s^T G_s r_s with G_s ~ L_s^-1 by ``sweeps`` Jacobi sweeps on L_s
and on L_s^T (``ops/trisolve``'s Neumann operator).  The apply needs no
communication: the coupling between the blocks is dropped, trading
iterations for applies that run on every rank at once.  Exact triangular
solves once ``sweeps`` reaches the block's level count
(``ops/trisolve.compute_levels``).

The reference builds every shard's operator on every host and stacks
them; here a rank builds only its own (``build_block_jacobi_ic(...,
rank)``), which holds the same numbers as the reference's slice.
"""

from __future__ import annotations

import scipy.sparse as sp
import torch

from deeppreconditioning_tpu_torch.ops.ic0 import ic0_factor
from deeppreconditioning_tpu_torch.ops.trisolve import (
    TriNeumann,
    build_tri_neumann,
    neumann_ic_apply,
)


def build_block_jacobi_ic(a: sp.spmatrix, n_shards: int, n_total: int,
                          rank: int, sweeps: int = 8) -> TriNeumann:
    """Rank ``rank``'s Neumann IC(0) operator (host, numpy arrays): the
    factor of its diagonal block of the ``n_shards``-way row partition
    of ``a`` (n_total % n_shards == 0, as ``partition.shard_ell_rows``
    pads), indices local to the shard, sentinel rows_per_shard; rows past
    n (and a shard wholly past n) apply as 0."""
    if n_total % n_shards:
        raise ValueError(f"{n_total} rows in {n_shards} equal shards")
    r = n_total // n_shards
    n = a.shape[0]
    lo, hi = rank * r, min((rank + 1) * r, n)
    if lo >= n:
        block = sp.csr_matrix((0, 0))
        return build_tri_neumann(block, sweeps, n_pad=r)
    block = a.tocsr()[lo:hi, lo:hi]
    return build_tri_neumann(ic0_factor(block), sweeps, n_pad=r)


def block_jacobi_apply(m_local: TriNeumann, r_local: torch.Tensor):
    """Shard-local z = G^T G r (``m_local``: the rank's operator moved to
    its device by ``TriNeumann.to``)."""
    return neumann_ic_apply(m_local, r_local)
