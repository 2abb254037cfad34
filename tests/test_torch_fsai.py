"""The port's range-blocked FSAI device path against the JAX package's, in
float64 on mesh_cells=1 sludge-pattern cases (rtol 1e-10)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppreconditioning_tpu.ops import fsai as jax_fsai
from deeppreconditioning_tpu_torch.data.datasets import _prepare_sample
from deeppreconditioning_tpu_torch.data.fvm import generate_sludge_case
from deeppreconditioning_tpu_torch.ops import fsai
from deeppreconditioning_tpu_torch.data.fvm import numpy_assembly


@pytest.fixture(autouse=True, scope="module")
def _numpy_fvm_assembly():
    """The port's numpy FVM assembly: the route the reference's counts
    and arrays held here were made on."""
    with numpy_assembly():
        yield


N_PAD = 256
RTOL = 1e-10


def _case(seed):
    """Dense scaled A~, scales, n0 and the range plans (port, JAX)."""
    case = generate_sludge_case(np.random.default_rng(seed), mesh_cells=1)
    m = case.matrix
    h = _prepare_sample(m.row, m.col, m.data, case.solution, case.rhs,
                        N_PAD)
    a = np.zeros((N_PAD, N_PAD))
    a[h.rows, h.cols] = h.vals
    a = a + np.tril(a, -1).T
    pr, pc = fsai.tril_power_pattern(h.rows, h.cols, N_PAD, power=4)
    plan = fsai.build_range_fsai_plan(pr, pc, N_PAD, width=24, range_h=128)
    ref = jax_fsai.build_range_fsai_plan(pr, pc, N_PAD, width=24,
                                         range_h=128)
    return a, h.scale, h.original_size, plan.to("cpu"), ref


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=rtol * np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_range_fsai_columns_matches_jax(seed):
    a, _, _, plan, ref = _case(seed)
    c, a_col = fsai.range_fsai_columns(plan, torch.tensor(a), with_aux=True)
    c_ref, a_col_ref = jax_fsai.range_fsai_columns(ref, jnp.asarray(a),
                                                   with_aux=True)
    _close(c, c_ref)
    _close(a_col, a_col_ref)
    c_only = fsai.range_fsai_columns(plan, torch.tensor(a))
    np.testing.assert_array_equal(c_only.numpy(), c.numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_strips_and_gram_match_jax(seed):
    a, scale, n0, plan, ref = _case(seed)
    c_ref = jax_fsai.range_fsai_columns(ref, jnp.asarray(a))
    c = torch.tensor(np.asarray(c_ref))
    strips = fsai.range_strips(plan, c)
    strips_ref = jax_fsai.range_strips(ref, c_ref)
    np.testing.assert_array_equal(strips.numpy(), np.asarray(strips_ref))

    d_isqrt = 1.0 / np.sqrt(scale)
    m = fsai.range_m_from_strips(plan, strips, torch.tensor(d_isqrt), n0)
    m_ref = jax_fsai.range_m_from_strips(ref, strips_ref,
                                         jnp.asarray(d_isqrt), n0)
    _close(m, m_ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_dense_preconditioner_range_matches_jax(seed):
    a, scale, n0, plan, ref = _case(seed)
    d_isqrt = 1.0 / np.sqrt(scale)
    m = fsai.fsai_dense_preconditioner_range(
        plan, torch.tensor(a), d_isqrt=torch.tensor(d_isqrt), n0=n0,
        dtype=torch.float64,
    )
    m_ref = jax_fsai.fsai_dense_preconditioner_range(
        ref, jnp.asarray(a), d_isqrt=jnp.asarray(d_isqrt), n0=n0,
        dtype=jnp.float64,
    )
    _close(m, m_ref)
    assert not m[n0:].any() and not m[:, n0:].any()


@pytest.mark.parametrize("seed", [0, 1])
def test_poly_preconditioner_from_gram_matches_jax(seed):
    a, scale, n0, plan, ref = _case(seed)
    d_isqrt = 1.0 / np.sqrt(scale)
    s = jax_fsai.fsai_dense_preconditioner_range(
        ref, jnp.asarray(a), d_isqrt=jnp.asarray(d_isqrt), n0=n0,
        dtype=jnp.float64,
    )
    d_sqrt = np.sqrt(scale)
    a_raw = d_sqrt[:, None] * a * d_sqrt[None, :]
    q = np.random.default_rng(seed).uniform(-0.5, 1.5, 3)  # degree 2
    m = fsai.poly_preconditioner_from_gram(
        torch.tensor(np.asarray(s)), torch.tensor(a_raw), torch.tensor(q)
    )
    m_ref = jax_fsai.poly_preconditioner_from_gram(
        s, jnp.asarray(a_raw), jnp.asarray(q)
    )
    _close(m, m_ref)
    # q = e0 reduces to M = S (symmetrized) exactly
    eye_q = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64)
    s_t = torch.tensor(np.asarray(s))
    m_id = fsai.poly_preconditioner_from_gram(s_t, torch.tensor(a_raw), eye_q)
    np.testing.assert_array_equal(m_id.numpy(), (0.5 * (s_t + s_t.T)).numpy())
