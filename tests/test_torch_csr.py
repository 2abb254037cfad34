"""The port's CSRMatrix against the JAX package's (float64): the same
padded arrays from ``from_scipy``, the same matvec, dense form and scipy
round trip."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from deeppreconditioning_tpu.sparse.csr import CSRMatrix as JaxCSR
from deeppreconditioning_tpu_torch.data.fvm import (
    generate_sludge_case,
    numpy_assembly,
)
from deeppreconditioning_tpu_torch.sparse.csr import CSRMatrix


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _matrices():
    with numpy_assembly():
        case = generate_sludge_case(np.random.default_rng(0), mesh_cells=1)
    rng = np.random.default_rng(1)
    rand = sp.random(50, 50, density=0.1, random_state=rng, format="coo")
    # duplicates, summed by from_scipy
    dup = sp.coo_matrix(([1.0, 2.0, 3.0], ([0, 0, 2], [1, 1, 0])),
                        shape=(4, 4))
    return {"fvm": case.matrix, "random": rand, "duplicates": dup}


MATRICES = _matrices()


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("extra", [0, 17])
def test_csr_matches_jax(name, extra):
    a = MATRICES[name]
    nnz = a.tocsr().nnz if name != "duplicates" else 2
    ours = CSRMatrix.from_scipy(a, nnz_pad=nnz + extra, dtype=torch.float64)
    ref = JaxCSR.from_scipy(a, nnz_pad=nnz + extra, dtype=jnp.float64)
    assert ours.n == ref.n and ours.nnz_pad == ref.nnz_pad
    for field in ("indptr", "indices", "row_ids"):
        np.testing.assert_array_equal(getattr(ours, field).numpy(),
                                      np.asarray(getattr(ref, field)))
    np.testing.assert_array_equal(ours.data.numpy(), np.asarray(ref.data))
    x = np.random.default_rng(2).standard_normal(ours.n)
    np.testing.assert_allclose(
        ours.matvec(torch.as_tensor(x)).numpy(),
        np.asarray(ref.matvec(jnp.asarray(x))), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(ours.to_dense().numpy(),
                               np.asarray(ref.to_dense()), rtol=0, atol=0)
    np.testing.assert_allclose(ours.to_scipy().toarray(),
                               ref.to_scipy().toarray(), rtol=0, atol=0)
    np.testing.assert_allclose(ours.to_dense().numpy(), a.toarray(),
                               rtol=1e-15, atol=0)


def test_csr_rejects_short_padding():
    with pytest.raises(ValueError):
        CSRMatrix.from_scipy(MATRICES["fvm"], nnz_pad=3)
