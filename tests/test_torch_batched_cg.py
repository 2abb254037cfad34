"""The port's batched PCG (chunked and fixed-trip) against the JAX
package's on a stack of systems (f64): equal per-case iterations, x to
rtol 1e-10; a case that is done early stays frozen, a zero rhs needs no
iteration, and too few trips leave the slow cases unconverged."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from deeppreconditioning_tpu.solvers import cg as jax_cg
from deeppreconditioning_tpu_torch.solvers import cg


def _stack():
    """Four SPD systems of one size: two 1-D Poisson with diagonal
    shifts, one well conditioned, one with a zero rhs; Jacobi diagonals."""
    rng = np.random.default_rng(7)
    n = 48
    lap = sp.diags([-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)],
                   [-1, 0, 1]).toarray()
    mats = [lap + np.diag(10.0 ** rng.uniform(-2, 1, n)),
            lap + 1e-3 * np.eye(n),
            np.eye(n) * 4 + 0.1 * lap,
            lap + np.eye(n)]
    b = rng.standard_normal((4, n))
    b[3] = 0.0
    a = np.stack(mats)
    d = 1.0 / np.einsum("bii->bi", a)
    return a, b, d


A, B, D = _stack()


def _torch_matvec(a, x):
    return torch.bmm(a, x[..., None])[..., 0]


def _jax_matvec(a, x):
    return jnp.einsum("bij,bj->bi", a, x)


def _diag(d, r):
    return d * r


@pytest.mark.parametrize("check_every", [1, 4, 32])
def test_batched_pcg_matches_jax(check_every):
    ours = cg.batched_preconditioned_conjugate_gradient(
        _torch_matvec, torch.tensor(A), torch.tensor(B), _diag,
        torch.tensor(D), check_every=check_every)
    ref = jax_cg.batched_preconditioned_conjugate_gradient(
        _jax_matvec, jnp.asarray(A), jnp.asarray(B), _diag, jnp.asarray(D),
        check_every=check_every)
    np.testing.assert_array_equal(ours.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_allclose(ours.x.numpy(), np.asarray(ref.x),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ours.residual.numpy(),
                               np.asarray(ref.residual), rtol=1e-6,
                               atol=1e-20)
    iters = ours.iterations.numpy()
    assert iters[3] == 0 and (iters[:3] > 0).all()
    assert len(set(iters[:3].tolist())) > 1  # cases freeze at their own k
    assert (ours.residual.numpy() < 1e-8).all()


@pytest.mark.parametrize("extra", [0, 5])
def test_fixed_trips_match_jax_and_the_chunked_solve(extra):
    chunked = cg.batched_preconditioned_conjugate_gradient(
        _torch_matvec, torch.tensor(A), torch.tensor(B), _diag,
        torch.tensor(D), check_every=8)
    trips = int(chunked.iterations.max()) + extra
    ours = cg.batched_pcg_fixed_trips(
        _torch_matvec, torch.tensor(A), torch.tensor(B), _diag,
        torch.tensor(D), trips=trips)
    ref = jax_cg.batched_pcg_fixed_trips(
        _jax_matvec, jnp.asarray(A), jnp.asarray(B), _diag, jnp.asarray(D),
        trips=trips)
    np.testing.assert_array_equal(ours.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_array_equal(ours.iterations.numpy(),
                                  chunked.iterations.numpy())
    np.testing.assert_allclose(ours.x.numpy(), np.asarray(ref.x),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ours.x.numpy(), chunked.x.numpy(),
                               rtol=1e-12, atol=1e-14)


def test_too_few_trips_leave_cases_unconverged():
    short = cg.batched_pcg_fixed_trips(
        _torch_matvec, torch.tensor(A), torch.tensor(B), _diag,
        torch.tensor(D), trips=3)
    ref = jax_cg.batched_pcg_fixed_trips(
        _jax_matvec, jnp.asarray(A), jnp.asarray(B), _diag, jnp.asarray(D),
        trips=3)
    np.testing.assert_array_equal(short.iterations.numpy(),
                                  np.asarray(ref.iterations))
    assert (short.iterations.numpy()[:2] == 3).all()
    assert (short.residual.numpy()[:2] >= 1e-8).all()


def test_max_iter_freezes_every_case():
    res = cg.batched_preconditioned_conjugate_gradient(
        _torch_matvec, torch.tensor(A), torch.tensor(B), _diag,
        torch.tensor(D), max_iter=5, check_every=4)
    ref = jax_cg.batched_preconditioned_conjugate_gradient(
        _jax_matvec, jnp.asarray(A), jnp.asarray(B), _diag, jnp.asarray(D),
        max_iter=5, check_every=4)
    np.testing.assert_array_equal(res.iterations.numpy(),
                                  np.asarray(ref.iterations))
    assert res.iterations.numpy().max() == 5
