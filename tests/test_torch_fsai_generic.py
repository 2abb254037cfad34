"""The port's generic FSAIPlan path against the JAX package's, in float64
on a frame-structure case whose power-2 pattern does not fit a range plan
(block row spread 311 > H = 256): plan arrays equal, column values,
dense factor, M and the polynomial wrap to rtol 1e-10."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppreconditioning_tpu.ops import fsai as jax_fsai
from deeppreconditioning_tpu_torch.data.datasets import _prepare_sample
from deeppreconditioning_tpu_torch.data.frames import generate_frame_case
from deeppreconditioning_tpu_torch.ops import fsai

N_PAD = 640
WIDTH = 41  # the frame-structure checkpoint's static width
RTOL = 1e-10


def _case(sentinel=None):
    """Scaled tril values, scales, n0 and the generic plans (port, JAX)."""
    case = generate_frame_case(np.random.default_rng(3), solve=False)
    m = case.matrix
    h = _prepare_sample(m.row, m.col, m.data, case.solution, case.rhs,
                        N_PAD)
    pr, pc = fsai.tril_power_pattern(h.rows, h.cols, N_PAD, power=2)
    with pytest.raises(ValueError, match="spread"):
        fsai.build_range_fsai_plan(pr, pc, N_PAD, width=WIDTH, range_h=256)
    args = (h.rows, h.cols, pr, pc, N_PAD)
    plan = fsai.build_fsai_plan(*args, width=WIDTH, sentinel=sentinel)
    ref = jax_fsai.build_fsai_plan(*args, width=WIDTH, sentinel=sentinel)
    vals = h.vals
    if sentinel is not None:
        vals = np.concatenate([vals, np.zeros(sentinel - vals.shape[0])])
    return vals, h.scale, h.original_size, plan, ref


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("pad", [0, 37])
def test_build_fsai_plan_matches_jax(pad):
    vals, _, _, plan, ref = _case()
    if pad:
        vals, _, _, plan, ref = _case(sentinel=vals.shape[0] + pad)
    assert plan.n_pad == N_PAD and plan.width == WIDTH
    for name in ("sub_idx", "pos", "out_rows", "diag_pad", "l0_rows",
                 "l0_cols"):
        got, want = getattr(plan, name), np.asarray(getattr(ref, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("lookup", [False, True])
def test_fsai_values_match_jax(lookup):
    """The port's one generic form (the value-vector lookup) against both
    of the reference's: the dense-matrix gather and the lookup."""
    vals, _, _, plan, ref = _case(sentinel=None)
    plan = plan.to("cpu")
    theirs = jax_fsai.fsai_values_lookup if lookup else jax_fsai.fsai_values
    c, a_col = fsai.fsai_values_lookup(plan, torch.tensor(vals),
                                       with_aux=True)
    c_ref, a_col_ref = theirs(ref, jnp.asarray(vals), with_aux=True)
    _close(c, c_ref)
    _close(a_col, a_col_ref)
    assert c.shape == (N_PAD, WIDTH)


def test_dense_factor_and_preconditioner_match_jax():
    vals, scale, n0, plan, ref = _case()
    plan = plan.to("cpu")
    d_isqrt = 1.0 / np.sqrt(scale)
    c_ref = jax_fsai.fsai_values(ref, jnp.asarray(vals))
    _close(fsai.fsai_dense_from_l0(plan, torch.tensor(vals)),
           jax_fsai.fsai_dense_from_l0(ref, jnp.asarray(vals)))
    _close(fsai.fsai_dense_factor(plan, torch.tensor(np.asarray(c_ref)),
                                  torch.tensor(d_isqrt), n0),
           jax_fsai.fsai_dense_factor(ref, c_ref, jnp.asarray(d_isqrt),
                                      jnp.int32(n0)))
    m = fsai.fsai_dense_preconditioner(plan, torch.tensor(vals),
                                       d_isqrt=torch.tensor(d_isqrt), n0=n0,
                                       dtype=torch.float64)
    m_ref = jax_fsai.fsai_dense_preconditioner(
        ref, jnp.asarray(vals), d_isqrt=jnp.asarray(d_isqrt),
        n0=jnp.int32(n0), dtype=jnp.float64)
    _close(m, m_ref)
    assert not m[n0:].any() and not m[:, n0:].any()


def test_poly_preconditioner_dense_matches_jax():
    vals, scale, n0, plan, ref = _case()
    plan = plan.to("cpu")
    c_ref = jax_fsai.fsai_values(ref, jnp.asarray(vals))
    c_dense = jax_fsai.fsai_dense_factor(ref, c_ref)
    a_dense = jax_fsai.fsai_dense_from_l0(ref, jnp.asarray(vals))
    q = np.array([1.3, -0.4, 0.05])
    d_isqrt = 1.0 / np.sqrt(scale)
    want = jax_fsai.poly_preconditioner_dense(
        c_dense, a_dense, jnp.asarray(q), d_isqrt=jnp.asarray(d_isqrt),
        n0=jnp.int32(n0))
    got = fsai.poly_preconditioner_dense(
        torch.tensor(np.asarray(c_dense)), torch.tensor(np.asarray(a_dense)),
        torch.tensor(q), d_isqrt=torch.tensor(d_isqrt), n0=n0)
    _close(got, want)


@pytest.mark.parametrize("case, match", [
    ("unsorted", "sorted"),
    ("narrow", "exceeds static width"),
    ("no_diagonal", "diagonal"),
])
def test_build_fsai_plan_refuses(case, match):
    rows = np.array([0, 1, 1, 2, 2], np.int32)
    cols = np.array([0, 0, 1, 1, 2], np.int32)
    pr, pc = rows.copy(), cols.copy()
    width = 2
    if case == "unsorted":
        rows, cols = rows[::-1].copy(), cols[::-1].copy()
    elif case == "narrow":
        width = 1
    else:
        keep = pr != pc
        keep[0] = True
        pr, pc = pr[keep], pc[keep]
    with pytest.raises(ValueError, match=match):
        fsai.build_fsai_plan(rows, cols, pr, pc, 3, width=width)
