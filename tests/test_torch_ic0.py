"""The port's IC(0) factorization against the JAX package's numpy path on
the same matrices (f64): equal patterns, values to rtol 1e-12, including
a matrix whose factorization breaks down and restarts with the diagonal
shift."""

import numpy as np
import pytest
import scipy.sparse as sp

from deeppreconditioning_tpu import native as jax_native
from deeppreconditioning_tpu.ops import ic0 as jax_ic0
from deeppreconditioning_tpu_torch.data.fvm import generate_sludge_case
from deeppreconditioning_tpu_torch.ops import ic0
from deeppreconditioning_tpu_torch.data.fvm import numpy_assembly


@pytest.fixture(autouse=True, scope="module")
def _numpy_fvm_assembly():
    """The port's numpy FVM assembly: the route the reference's counts
    and arrays held here were made on."""
    with numpy_assembly():
        yield


# An SPD matrix (smallest eigenvalue 0.05) on which unshifted IC(0) meets
# a non-positive pivot.
SHIFT_CASE = np.array([
    [1.6407, 0.0, -0.6237, 0.0, 0.0, 0.6506, -0.5274, 0.0],
    [0.0, 1.6407, -0.3333, 0.0, -0.4075, 0.0, 0.0, 0.7039],
    [-0.6237, -0.3333, 1.6407, 0.0, 0.0, 0.0, 0.865, 0.0],
    [0.0, 0.0, 0.0, 1.6407, 0.0, 0.8839, 0.0, 0.7331],
    [0.0, -0.4075, 0.0, 0.0, 1.6407, 0.5384, 0.0, 0.0],
    [0.6506, 0.0, 0.0, 0.8839, 0.5384, 1.6407, 0.7165, 0.0],
    [-0.5274, 0.0, 0.865, 0.0, 0.0, 0.7165, 1.6407, -0.5691],
    [0.0, 0.7039, 0.0, 0.7331, 0.0, 0.0, -0.5691, 1.6407],
])


@pytest.fixture
def numpy_ic0(monkeypatch):
    """Pin the reference to its numpy factorization, the path the port
    copies."""
    monkeypatch.setattr(jax_native, "available", lambda: False)


def _matrices():
    out = {"shift": sp.csr_matrix(SHIFT_CASE)}
    for seed in (0, 5):
        case = generate_sludge_case(np.random.default_rng(seed),
                                    mesh_cells=1)
        out[f"sludge_{seed}"] = case.matrix.tocsr()
    rng = np.random.default_rng(3)
    b = sp.random(60, 60, density=0.08, random_state=rng)
    out["random_spd"] = sp.csr_matrix(b @ b.T + 2 * sp.eye(60))
    return out


with numpy_assembly():
    MATRICES = _matrices()


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_ic0_factor_matches_jax(name, numpy_ic0):
    a = MATRICES[name]
    ours = ic0.ic0_factor(a)
    ref = jax_ic0.ic0_factor(a)
    np.testing.assert_array_equal(ours.indptr, ref.indptr)
    np.testing.assert_array_equal(ours.indices, ref.indices)
    np.testing.assert_allclose(ours.data, ref.data, rtol=1e-12, atol=0)
    # L has tril(A)'s pattern
    np.testing.assert_array_equal(
        ours.indices, sp.tril(a, format="csr").indices)


def test_shift_case_needs_the_shift():
    tril = sp.tril(MATRICES["shift"], format="csr")
    data = tril.data.astype(np.float64).copy()
    assert np.linalg.eigvalsh(SHIFT_CASE).min() > 0
    assert not ic0._ic0_inplace(8, tril.indptr, tril.indices, data)
    lf = ic0.ic0_factor(MATRICES["shift"])
    # IC(0) keeps diag(L L^T) = diag(A + shift): one positive shift
    shift = np.diag((lf @ lf.T - MATRICES["shift"]).toarray())
    assert shift[0] > 0
    np.testing.assert_allclose(shift, shift[0], rtol=1e-9)


def test_jacobi_preconditioner_matches_jax():
    a = MATRICES["sludge_0"]
    np.testing.assert_array_equal(ic0.jacobi_preconditioner(a),
                                  jax_ic0.jacobi_preconditioner(a))


with numpy_assembly():
    ICT_CASES = {f"sludge_{seed}": generate_sludge_case(
        np.random.default_rng(seed), mesh_cells=1).matrix.tocsr()
        for seed in (0, 5)}
ICT_CASES["random_spd"] = MATRICES["random_spd"]


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("name", sorted(ICT_CASES))
@pytest.mark.parametrize("fill,threshold", [(1, 0.1), (3, 0.01)])
def test_ict_factor_matches_jax_on_the_same_route(name, route, fill,
                                                  threshold, monkeypatch):
    """ICT's two routes are different algorithms (sparse left-looking in
    the host runtime, dense left-looking in numpy), each held to the
    reference's same route."""
    from deeppreconditioning_tpu_torch import native

    if route == "native" and not jax_native.available():
        pytest.skip("the reference's native/libdptpu.so does not load")
    if route == "numpy":
        monkeypatch.setattr(jax_native, "available", lambda: False)
        monkeypatch.setattr(native, "available", lambda: False)
    a = ICT_CASES[name]
    ours = ic0.ict_factor(a.copy(), add_fill_in=fill, threshold=threshold)
    ref = jax_ic0.ict_factor(a.copy(), add_fill_in=fill,
                             threshold=threshold)
    ours.sort_indices()
    ref.sort_indices()
    np.testing.assert_array_equal(ours.indptr, ref.indptr)
    np.testing.assert_array_equal(ours.indices, ref.indices)
    np.testing.assert_allclose(ours.data, ref.data, rtol=1e-12, atol=0)
    # a valid factor: lower triangular with a positive diagonal
    assert sp.triu(ours, 1).nnz == 0
    assert (ours.diagonal() > 0).all()


def test_materialize_normal_matches_jax():
    lf = ic0.ic0_factor(MATRICES["sludge_0"])
    ours = ic0.materialize_normal(lf)
    ref = jax_ic0.materialize_normal(lf)
    np.testing.assert_allclose(ours.toarray(), ref.toarray(), rtol=1e-14)
    np.testing.assert_allclose(ours.toarray(), (lf @ lf.T).toarray(),
                               rtol=1e-14)
