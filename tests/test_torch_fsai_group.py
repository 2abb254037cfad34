"""Static-start range plans, the uniform strips and bands, and the group
forms of the FSAI local solves against the JAX package (f64): plan arrays
equal, strips / windows / bands equal, and a group of plans gives on the
CPU bit-for-bit what the per-case calls give (one B1 launch for the
group on the card)."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppreconditioning_tpu.ops import fsai as jax_fsai
from deeppreconditioning_tpu_torch.data.datasets import SludgePatternDataSet
from deeppreconditioning_tpu_torch.data.fvm import generate_sludge_case
from deeppreconditioning_tpu_torch.models.neural_fsai import (
    neural_fsai_from_checkpoint,
)
from deeppreconditioning_tpu_torch.ops import fsai
from deeppreconditioning_tpu_torch.train.checkpoint import load_checkpoint

CKPT = (Path(__file__).resolve().parents[1] / "assets" / "checkpoints_fsai"
        / "best.msgpack")
H = 128


def _split():
    rng = np.random.default_rng(23)
    cases = [generate_sludge_case(rng, mesh_cells=1) for _ in range(15)]
    ds = SludgePatternDataSet(stage="test", cases=cases)
    out = []
    for i in range(len(ds)):
        h = ds.host_sample(i)
        r0, c0 = h.rows.astype(np.int32), h.cols.astype(np.int32)
        pr, pc = fsai.tril_power_pattern(r0, c0, ds.dof_pad, power=2)
        a = np.zeros((ds.dof_pad, ds.dof_pad))
        a[r0, c0] = h.vals
        out.append((r0, c0, pr, pc, a + np.tril(a, -1).T, h.vals))
    return ds.dof_pad, out


N_PAD, CASES = _split()
WIDTH = max(fsai.pattern_col_width(c[2], c[3]) for c in CASES)


def _plans(static_lo=True):
    return [fsai.build_range_fsai_plan(c[2], c[3], N_PAD, width=WIDTH,
                                       range_h=H, static_lo=static_lo)
            for c in CASES]


@pytest.mark.parametrize("index", [0, 2])
def test_static_lo_plan_matches_jax(index):
    _, _, pr, pc, _, _ = CASES[index]
    ours = fsai.build_range_fsai_plan(pr, pc, N_PAD, width=WIDTH, range_h=H,
                                      static_lo=True)
    ref = jax_fsai.build_range_fsai_plan(pr, pc, N_PAD, width=WIDTH,
                                         range_h=H, static_lo=True)
    assert ours.h == ref.h and ours.lo_static == ref.lo_static
    assert ours.lo_static == tuple(
        min(8 * b, N_PAD - H) for b in range(N_PAD // 8))
    for f in ("lo", "local", "pos", "diag_pad", "out_rows"):
        np.testing.assert_array_equal(getattr(ours, f),
                                      np.asarray(getattr(ref, f)), f)
    # without static starts the plan keeps its own window starts
    free = fsai.build_range_fsai_plan(pr, pc, N_PAD, width=WIDTH,
                                      range_h=H)
    assert free.lo_static is None
    # too low a window for the static starts is refused, as in JAX
    with pytest.raises(ValueError):
        fsai.build_range_fsai_plan(pr, pc, N_PAD, width=WIDTH, range_h=8,
                                   static_lo=True)


def test_uniform_strips_windows_and_bands_match_jax():
    _, _, pr, pc, a, _ = CASES[1]
    plan = fsai.build_range_fsai_plan(pr, pc, N_PAD, width=WIDTH, range_h=H,
                                      static_lo=True)
    ref_plan = jax_fsai.build_range_fsai_plan(pr, pc, N_PAD, width=WIDTH,
                                              range_h=H, static_lo=True)
    rng = np.random.default_rng(0)
    c_vals = np.where(np.asarray(ref_plan.out_rows) < N_PAD,
                      rng.standard_normal((N_PAD, WIDTH)), 0.0)
    ours = fsai.range_strips_uniform(plan.to("cpu"), torch.tensor(c_vals))
    ref = jax_fsai.range_strips_uniform(ref_plan, jnp.asarray(c_vals))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    v = rng.standard_normal((2, N_PAD))
    np.testing.assert_array_equal(
        fsai.window_vector(torch.tensor(v), 8, H).numpy(),
        np.asarray(jax_fsai.window_vector(jnp.asarray(v), 8, H)))
    for d_max in (9, 40):
        np.testing.assert_array_equal(
            fsai.strips_to_bands(ours, 8, d_max).numpy(),
            np.asarray(jax_fsai.strips_to_bands(ref, 8, d_max)))


def test_group_range_columns_equal_the_per_case_calls():
    plans = _plans()
    group = fsai.stack_plans(plans).to("cpu")
    a = torch.tensor(np.stack([c[4] for c in CASES]))
    c_grp, aux_grp = fsai.range_fsai_columns(group, a, with_aux=True)
    assert c_grp.shape == (len(CASES), N_PAD, WIDTH)
    for i, plan in enumerate(plans):
        c_one, aux_one = fsai.range_fsai_columns(plan.to("cpu"), a[i],
                                                 with_aux=True)
        assert torch.equal(c_grp[i], c_one)
        assert torch.equal(aux_grp[i], aux_one)
        # and the per-case call equals the JAX range path
        ref = jax_fsai.range_fsai_columns(
            jax_fsai.build_range_fsai_plan(CASES[i][2], CASES[i][3], N_PAD,
                                           width=WIDTH, range_h=H),
            jnp.asarray(CASES[i][4]))
        np.testing.assert_allclose(c_one.numpy(), np.asarray(ref),
                                   rtol=1e-10, atol=1e-13)
    # a slice of the group is the same group over fewer cases
    part = fsai.take_cases(group, slice(1, 3))
    assert torch.equal(fsai.range_fsai_columns(part, a[1:3]), c_grp[1:3])


def test_group_m_from_strips_equals_the_per_case_calls():
    plans = _plans()
    group = fsai.stack_plans(plans).to("cpu")
    a = torch.tensor(np.stack([c[4] for c in CASES]))
    rng = np.random.default_rng(5)
    d_isqrt = torch.tensor(rng.uniform(0.5, 2.0, (len(CASES), N_PAD)))
    n0 = torch.tensor([N_PAD - 40 * (i % 3) for i in range(len(CASES))])
    m_grp = fsai.fsai_dense_preconditioner_range(group, a, d_isqrt, n0,
                                                 dtype=torch.float64)
    for i, plan in enumerate(plans):
        m_one = fsai.fsai_dense_preconditioner_range(
            plan.to("cpu"), a[i], d_isqrt[i], int(n0[i]),
            dtype=torch.float64)
        np.testing.assert_allclose(m_grp[i].numpy(), m_one.numpy(),
                                   rtol=1e-12, atol=1e-14)


def test_group_lookup_equals_the_per_case_calls():
    sentinel = max(c[5].shape[0] for c in CASES)
    plans = [fsai.build_fsai_plan(c[0], c[1], c[2], c[3], N_PAD,
                                  width=WIDTH, sentinel=sentinel)
             for c in CASES[:3]]
    vals = np.zeros((3, sentinel))
    for i, c in enumerate(CASES[:3]):
        vals[i, :c[5].shape[0]] = c[5]
    group = fsai.stack_plans(plans).to("cpu")
    c_grp = fsai.fsai_values_lookup(group, torch.tensor(vals))
    m_grp = fsai.fsai_dense_preconditioner(
        group, torch.tensor(vals), n0=torch.tensor([N_PAD, 150, 100]),
        dtype=torch.float64)
    for i, plan in enumerate(plans):
        one = plan.to("cpu")
        assert torch.equal(c_grp[i],
                           fsai.fsai_values_lookup(one, torch.tensor(vals[i])))
        np.testing.assert_allclose(
            m_grp[i].numpy(),
            fsai.fsai_dense_preconditioner(
                one, torch.tensor(vals[i]), n0=[N_PAD, 150, 100][i],
                dtype=torch.float64).numpy(), rtol=1e-12, atol=1e-14)


def test_stack_plans_refuses_mixed_windows():
    plans = _plans()
    with pytest.raises(ValueError):
        fsai.stack_plans(_plans(static_lo=False))
    free = fsai.build_range_fsai_plan(CASES[0][2], CASES[0][3], N_PAD,
                                      width=WIDTH, range_h=H)
    with pytest.raises(ValueError):
        fsai.stack_plans([plans[0], free])


def test_group_model_forward_matches_the_per_case_forward():
    payload = load_checkpoint(CKPT)
    model = neural_fsai_from_checkpoint(payload).double()
    width = model.width
    plans = [fsai.build_range_fsai_plan(c[2], c[3], N_PAD, width=width,
                                        range_h=H, static_lo=True)
             for c in CASES[:3]
             if fsai.pattern_col_width(c[2], c[3]) <= width]
    assert plans
    group = fsai.stack_plans(plans).to("cpu")
    a = torch.tensor(np.stack([c[4] for c in CASES[:len(plans)]]))
    with torch.no_grad():
        out = model(group, a)
        for i, plan in enumerate(plans):
            one = model(plan.to("cpu"), a[i])
            np.testing.assert_allclose(out.c_vals[i].numpy(),
                                       one.c_vals.numpy(), rtol=1e-12,
                                       atol=1e-14)
            np.testing.assert_array_equal(out.q_coeffs[i].numpy(),
                                          one.q_coeffs.numpy())
