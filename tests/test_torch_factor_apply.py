"""The port's factor apply z = L (L^T r) against the JAX package's and
against the dense (L L^T) r, float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppreconditioning_tpu.ops import factor_apply as jfa
from deeppreconditioning_tpu_torch.ops import factor_apply as fa


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small CPU tensors: a pool of eight
    costs more than the work, most of all in a loaded test run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pattern(rng, n, nnz, pad):
    """Random lower-triangular sites with the diagonal, a padded tail
    (valid False) and values zero there."""
    lin = rng.choice(n * n, size=nnz, replace=False)
    r, c = lin // n, lin % n
    keep = r > c
    r = np.concatenate([np.arange(n), r[keep]])
    c = np.concatenate([np.arange(n), c[keep]])
    rows = np.zeros(r.size + pad, np.int32)
    cols = np.zeros(r.size + pad, np.int32)
    rows[:r.size], cols[:r.size] = r, c
    valid = np.arange(r.size + pad) < r.size
    vals = np.where(valid, rng.standard_normal(valid.size), 0.0)
    return rows, cols, valid, vals


@pytest.mark.parametrize("widths", [None, (12, 14)])
def test_factor_apply_matches_jax_and_dense(widths):
    rng = np.random.default_rng(11)
    n_pad = 48
    rows, cols, valid, vals = _pattern(rng, 40, 300, 17)
    assert fa.pattern_widths(rows, cols, valid) == jfa.pattern_widths(
        rows, cols, valid)
    plan = fa.build_factor_apply_plan(rows, cols, valid, n_pad,
                                      widths=widths)
    ref = jfa.build_factor_apply_plan(rows, cols, valid, n_pad,
                                      widths=widths)
    for name in ("l_src", "l_col", "u_src", "u_row"):
        np.testing.assert_array_equal(getattr(plan, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    assert plan.n_pad == n_pad
    r = rng.standard_normal(n_pad)
    z = fa.factor_normal_apply((plan, torch.from_numpy(vals)),
                               torch.from_numpy(r)).numpy()
    want = np.asarray(jfa.factor_apply(ref, jnp.asarray(vals),
                                       jnp.asarray(r)))
    np.testing.assert_allclose(z, want, rtol=1e-10, atol=1e-12)
    l_dense = np.zeros((n_pad, n_pad))
    l_dense[rows[valid], cols[valid]] = vals[valid]
    np.testing.assert_allclose(z, l_dense @ (l_dense.T @ r), rtol=1e-10,
                               atol=1e-12)


def test_width_overflow_raises():
    rng = np.random.default_rng(12)
    rows, cols, valid, _ = _pattern(rng, 30, 200, 0)
    w_l, w_u = fa.pattern_widths(rows, cols, valid)
    for widths in ((w_l - 1, w_u), (w_l, w_u - 1)):
        with pytest.raises(ValueError, match="exceeds static width"):
            fa.build_factor_apply_plan(rows, cols, valid, 32, widths=widths)
