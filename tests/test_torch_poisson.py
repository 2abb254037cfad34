"""The port's numpy copy of ``poisson_coeff_dia`` against the JAX
package's (f64), including the (8, 1) grid whose two axes share a band,
and its sigma = 0 member against ``poisson_dia``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppreconditioning_tpu.data.poisson import (
    poisson_coeff_dia as jax_poisson_coeff_dia,
)
from deeppreconditioning_tpu_torch.data.poisson import poisson_coeff_dia
from deeppreconditioning_tpu_torch.sparse.dia import poisson_dia


@pytest.mark.parametrize("shape,sigma", [
    ((5, 6, 4), 1.0),
    ((5, 6, 4), 2.0),
    ((8, 1), 1.0),
    ((16, 12), 0.5),
])
def test_poisson_coeff_dia_matches_jax(shape, sigma):
    ref = jax_poisson_coeff_dia(shape, rng=np.random.default_rng(7),
                                sigma=sigma, dtype=jnp.float64)
    got = poisson_coeff_dia(shape, rng=np.random.default_rng(7),
                            sigma=sigma, dtype=torch.float64)
    assert got.offsets == ref.offsets
    assert (got.n, got.n_pad) == (ref.n, ref.n_pad)
    np.testing.assert_allclose(got.vals.numpy(), np.asarray(ref.vals),
                               rtol=1e-12, atol=0.0)


def test_shared_band_keeps_both_axes():
    """(8, 1): both axes' couplings land in the +-1 bands."""
    got = poisson_coeff_dia((8, 1), rng=np.random.default_rng(0),
                            dtype=torch.float64)
    m = got.to_scipy().toarray()
    np.testing.assert_allclose(m, m.T, atol=1e-12)
    assert (np.abs(np.diag(m, 1)) > 0).all()


def test_unit_coefficients_give_poisson_dia():
    """sigma = 0: kappa = 1 everywhere, the 7-point Poisson operator."""
    got = poisson_coeff_dia((5, 4, 3), rng=np.random.default_rng(8),
                            sigma=0.0, dtype=torch.float64)
    want = poisson_dia((5, 4, 3), dtype=torch.float64)
    assert got.offsets == want.offsets
    np.testing.assert_array_equal(got.vals.numpy(), want.vals.numpy())
