"""The port's triangular solves against the JAX package's on IC(0)
factors of FVM systems (f64): the level schedules and Neumann operators
hold the same arrays, and ``tri_solve_lower``, ``ic_apply`` and
``neumann_ic_apply`` agree to rtol 1e-10."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg  # noqa: F401
import torch

from deeppreconditioning_tpu import native as jax_native
from deeppreconditioning_tpu.ops import trisolve as jax_tri
from deeppreconditioning_tpu_torch.data.fvm import (
    generate_sludge_case,
    generate_sludge_case_3d,
)
from deeppreconditioning_tpu_torch.ops import trisolve
from deeppreconditioning_tpu_torch.ops.ic0 import ic0_factor
from deeppreconditioning_tpu_torch.data.fvm import numpy_assembly


@pytest.fixture(autouse=True, scope="module")
def _numpy_fvm_assembly():
    """The port's numpy FVM assembly: the route the reference's counts
    and arrays held here were made on."""
    with numpy_assembly():
        yield


@pytest.fixture(autouse=True)
def numpy_levels(monkeypatch):
    """Pin the reference to its numpy level computation."""
    monkeypatch.setattr(jax_native, "available", lambda: False)


def _factors():
    out = {}
    case = generate_sludge_case(np.random.default_rng(2), mesh_cells=1)
    out["sludge"] = (ic0_factor(case.matrix.tocsr()), 256)
    case = generate_sludge_case_3d(np.random.default_rng(4), mesh_cells=1,
                                   permute=True)
    n = case.matrix.shape[0]
    out["permuted_3d"] = (ic0_factor(case.matrix.tocsr()),
                          ((n + 127) // 128) * 128)
    return out


with numpy_assembly():
    FACTORS = _factors()


def _rhs(n_pad, n, seed=0):
    r = np.zeros(n_pad)
    r[:n] = np.random.default_rng(seed).standard_normal(n)
    return r


@pytest.mark.parametrize("name", sorted(FACTORS))
def test_levels_and_schedules_match_jax(name):
    lf, n_pad = FACTORS[name]
    np.testing.assert_array_equal(trisolve.compute_levels(lf),
                                  jax_tri.compute_levels(lf))
    for build in ("build_tri_schedule", "transpose_schedule"):
        ours = getattr(trisolve, build)(lf, n_pad=n_pad)
        ref = getattr(jax_tri, build)(lf, n_pad=n_pad)
        assert (ours.n, ours.n_pad, ours.n_levels) == (
            ref.n, ref.n_pad, ref.n_levels)
        for f in ("rows", "cols", "vals", "diag"):
            np.testing.assert_array_equal(getattr(ours, f),
                                          np.asarray(getattr(ref, f)), f)


@pytest.mark.parametrize("name", sorted(FACTORS))
def test_tri_solves_match_jax(name):
    lf, n_pad = FACTORS[name]
    n = lf.shape[0]
    r = _rhs(n_pad, n)
    lower = trisolve.build_tri_schedule(lf, n_pad=n_pad)
    upper = trisolve.transpose_schedule(lf, n_pad=n_pad)
    lower_d = lower.to("cpu", torch.float64)
    upper_d = upper.to("cpu", torch.float64)
    # every wave keeps live rows only; the padded levels carry the rest
    assert len(lower_d.waves) <= lower.n_levels
    assert sum(w[0].shape[0] for w in lower_d.waves) == n
    rt = torch.tensor(r)

    x = trisolve.tri_solve_lower(lower_d, rt).numpy()
    x_ref = np.asarray(jax_tri.tri_solve_lower(
        jax_tri.build_tri_schedule(lf, n_pad=n_pad), jnp.asarray(r)))
    np.testing.assert_allclose(x, x_ref, rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(
        x[:n], sp.linalg.spsolve_triangular(lf.tocsr(), r[:n], lower=True),
        rtol=1e-10)

    z = trisolve.ic_apply(lower_d, upper_d, rt).numpy()
    z_ref = np.asarray(jax_tri.ic_apply(
        jax_tri.build_tri_schedule(lf, n_pad=n_pad),
        jax_tri.transpose_schedule(lf, n_pad=n_pad), jnp.asarray(r)))
    np.testing.assert_allclose(z, z_ref, rtol=1e-10, atol=1e-14)
    assert not z[n:].any()


@pytest.mark.parametrize("name", sorted(FACTORS))
@pytest.mark.parametrize("sweeps", [1, 8])
def test_neumann_ic_apply_matches_jax(name, sweeps):
    lf, n_pad = FACTORS[name]
    n = lf.shape[0]
    ours = trisolve.build_tri_neumann(lf, sweeps=sweeps, n_pad=n_pad)
    ref = jax_tri.build_tri_neumann(lf, sweeps=sweeps, n_pad=n_pad)
    for f in ("cols", "vals", "inv_diag"):
        np.testing.assert_array_equal(getattr(ours, f),
                                      np.asarray(getattr(ref, f)), f)
    op = ours.to("cpu", torch.float64)
    r = _rhs(n_pad, n, seed=1)
    z = trisolve.neumann_ic_apply(op, torch.tensor(r)).numpy()
    z_ref = np.asarray(jax_tri.neumann_ic_apply(ref, jnp.asarray(r)))
    np.testing.assert_allclose(z, z_ref, rtol=1e-10, atol=1e-14)
    # a batch of vectors applies at once, row by row
    rows = torch.tensor(np.stack([r, _rhs(n_pad, n, seed=2)]))
    np.testing.assert_allclose(trisolve.neumann_ic_apply(op, rows)[0].numpy(),
                               z, rtol=1e-12)


def test_neumann_converges_to_the_exact_solves():
    """Enough sweeps reach the level-scheduled solves exactly."""
    lf, n_pad = FACTORS["sludge"]
    n = lf.shape[0]
    depth = int(trisolve.compute_levels(lf).max()) + 1
    op = trisolve.build_tri_neumann(lf, sweeps=depth, n_pad=n_pad).to(
        "cpu", torch.float64)
    lower = trisolve.build_tri_schedule(lf, n_pad=n_pad).to(
        "cpu", torch.float64)
    upper = trisolve.transpose_schedule(lf, n_pad=n_pad).to(
        "cpu", torch.float64)
    r = torch.tensor(_rhs(n_pad, n, seed=3))
    np.testing.assert_allclose(trisolve.neumann_ic_apply(op, r).numpy(),
                               trisolve.ic_apply(lower, upper, r).numpy(),
                               rtol=1e-9, atol=1e-12)
