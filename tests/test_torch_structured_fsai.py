"""The port's structured FSAI against the JAX package's (f64): the plan,
``slot_valid``, the local solves (kernel B1's plain version against the
reference's guarded lane-major Gauss–Jordan: the guard never fires since
every pivot is positive), ``structured_a_col``, ``structured_refine``
with the committed structured checkpoints, ``poly_safeguard``, the setup
and the DIA apply."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from deeppreconditioning_tpu.data.poisson import (
    poisson_coeff_dia as jax_poisson_coeff_dia,
)
from deeppreconditioning_tpu.ops import structured_fsai as jsf
from deeppreconditioning_tpu.sparse.dia import DIAMatrix as JaxDIA
from deeppreconditioning_tpu_torch.models.neural_fsai import (
    neural_fsai_from_checkpoint,
)
from deeppreconditioning_tpu_torch.ops import structured_fsai as sf
from deeppreconditioning_tpu_torch.sparse.dia import DIAMatrix
from deeppreconditioning_tpu_torch.train.checkpoint import load_checkpoint

CKPT_DIR = (Path(__file__).resolve().parents[1] / "assets"
            / "checkpoints_structured")
# (shape, power, checkpoint): w 13 and w 4
CASES = [((8, 8, 8), 2, "deg1_random.msgpack"),
         ((6, 5, 4), 1, "deg0_p1.msgpack")]


def _pair(shape, seed=1, sigma=1.0):
    """The same sorted operator in both packages, f64."""
    ref = jsf.dia_sorted_by_offset(jax_poisson_coeff_dia(
        shape, rng=np.random.default_rng(seed), sigma=sigma,
        dtype=jnp.float64))
    got = DIAMatrix(vals=torch.tensor(np.asarray(ref.vals)),
                    offsets=ref.offsets, n=ref.n)
    return ref, got


def _models(name):
    """(the reference's params, the port's model), both float64 on the
    checkpoint's float32 values: the reference would otherwise form
    q = e0 + q_coeffs in float32."""
    payload = serialization.msgpack_restore((CKPT_DIR / name).read_bytes())
    params = jax.tree.map(lambda v: jnp.asarray(v, jnp.float64),
                          payload["params"])
    model = neural_fsai_from_checkpoint(load_checkpoint(CKPT_DIR / name))
    return params, model.double().eval()


@pytest.mark.parametrize("shape,power", [((8, 8, 8), 2), ((6, 5, 4), 1),
                                         ((3, 4, 5), 2), ((8, 8), 2)])
def test_plan_matches_jax(shape, power):
    ref = jsf.build_structured_plan(shape, power=power)
    got = sf.build_structured_plan(shape, power=power)
    assert got.offsets == ref.offsets and got.a_offsets == ref.a_offsets
    np.testing.assert_array_equal(got.delta_idx, ref.delta_idx)
    assert len(got.disp_classes) == len(ref.disp_classes)
    for g, r in zip(got.disp_classes, ref.disp_classes):
        np.testing.assert_array_equal(g, r)
    assert sf.build_structured_plan(shape, power=power) is got  # cached
    valid = sf.slot_valid(got, 1024, dtype=torch.float64)
    np.testing.assert_array_equal(valid.numpy(),
                                  np.asarray(jsf.slot_valid(ref, 1024)))


@pytest.mark.parametrize("shape,power,ckpt", CASES)
def test_columns_a_col_and_refine_match_jax(shape, power, ckpt):
    ref_a, a = _pair(shape)
    ref_sc, ref_dsqrt = jsf.jacobi_scale_dia(ref_a)
    a_sc, d_sqrt = sf.jacobi_scale_dia(a)
    np.testing.assert_allclose(a_sc.vals.numpy(), np.asarray(ref_sc.vals),
                               rtol=1e-12)
    np.testing.assert_allclose(d_sqrt.numpy(), np.asarray(ref_dsqrt),
                               rtol=1e-12)
    plan = sf.build_structured_plan(shape, power=power)
    ref_plan = jsf.build_structured_plan(shape, power=power)

    # every pivot of every local system is positive (SPD systems), so the
    # reference's |p| < 1e-30 guard, which B1 does not have, never fires
    valid = sf.slot_valid(plan, a.n_pad, dtype=torch.float64)
    sub, e = sf._local_systems(sf._band_reads(a_sc, plan), plan, valid, 0,
                               a.n_pad)
    chol = np.linalg.cholesky(sub.numpy())
    assert (np.einsum("nii->ni", chol) ** 2).min() > 0

    ref_cols = np.asarray(jsf.structured_fsai_columns(ref_sc, ref_plan))
    cols = sf.structured_fsai_columns(a_sc, plan)
    np.testing.assert_allclose(cols.numpy(), ref_cols, rtol=1e-10,
                               atol=1e-12)
    ref_acol = np.asarray(jsf.structured_a_col(ref_sc, ref_plan))
    a_col = sf.structured_a_col(a_sc, plan)
    np.testing.assert_allclose(a_col.numpy(), ref_acol, rtol=1e-12)

    params, model = _models(ckpt)
    ref_ref, ref_q = jsf.structured_refine(
        params, jnp.asarray(ref_cols), jnp.asarray(ref_acol),
        jsf.slot_valid(ref_plan, a.n_pad).astype(jnp.float64))
    with torch.no_grad():
        refined, q = sf.structured_refine(model, cols, a_col, valid)
    np.testing.assert_allclose(refined.numpy(), np.asarray(ref_ref),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(q.numpy(), np.asarray(ref_q), rtol=1e-12)


def test_chunked_columns_equal_one_chunk():
    """The card solves 128^3 in 8 chunks of 2^18 columns; chunks of any
    size give the single-chunk result exactly."""
    _, a = _pair((8, 8, 8))
    a_sc, _ = sf.jacobi_scale_dia(a)
    plan = sf.build_structured_plan((8, 8, 8), power=2)
    whole = sf.structured_fsai_columns(a_sc, plan)
    for chunk in (128, 256):
        torch.testing.assert_close(
            sf.structured_fsai_columns(a_sc, plan, chunk=chunk), whole,
            rtol=0.0, atol=0.0)


def test_poly_safeguard_matches_jax():
    """Same flag, q and lambda_max; a root inside B's spectrum clamps to
    q = I, a root far outside passes (tests/test_structured_fsai.py's
    clamped case)."""
    shape = (8, 8, 8)
    ref_a, a = _pair(shape)
    ref_sc, _ = jsf.jacobi_scale_dia(ref_a)
    a_sc, _ = sf.jacobi_scale_dia(a)
    plan = sf.build_structured_plan(shape, power=2)
    bands = sf.structured_fsai_columns(a_sc, plan)
    for q_in, safe_want in (([1.0, -2.0], False), ([1.0, -0.02], True),
                            ([0.8436, -0.1514], True)):
        ref_q, ref_safe, ref_lam = jsf.poly_safeguard(
            jnp.asarray(bands.numpy()), jnp.asarray(q_in), ref_sc,
            plan.offsets)
        q, safe, lam = sf.poly_safeguard(
            bands, torch.tensor(q_in, dtype=torch.float64), a_sc,
            plan.offsets)
        assert bool(safe) == bool(ref_safe) == safe_want
        np.testing.assert_allclose(q.numpy(), np.asarray(ref_q), rtol=1e-12)
        np.testing.assert_allclose(float(lam), float(ref_lam), rtol=1e-9)
    assert 0.1 < float(lam) < 10.0


@pytest.mark.parametrize("shape,power,ckpt", CASES + [((8, 8, 8), 2, None)])
def test_setup_and_dia_apply_match_jax(shape, power, ckpt):
    ref_a, a = _pair(shape, seed=5)
    plan = sf.build_structured_plan(shape, power=power)
    ref_plan = jsf.build_structured_plan(shape, power=power)
    if ckpt is None:
        params, model = None, None
    else:
        params, model = _models(ckpt)
    ref_bands, ref_q = jsf.structured_setup(ref_a, ref_plan, params)
    with torch.no_grad():
        bands, q = sf.structured_setup(a, plan, model)
    np.testing.assert_allclose(bands.numpy(), np.asarray(ref_bands),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(q.numpy(), np.asarray(ref_q), rtol=1e-9)

    degree = q.shape[0] - 1
    r = np.random.default_rng(6).standard_normal(a.n_pad)
    c_up, c_low = sf.bands_to_dia(bands, plan.offsets, a.n)
    ref_up, ref_low = jsf.bands_to_dia(ref_bands, ref_plan.offsets, a.n)
    assert c_low.offsets == ref_low.offsets
    np.testing.assert_allclose(c_low.vals.numpy(), np.asarray(ref_low.vals),
                               rtol=1e-9, atol=1e-12)
    want = jsf.make_structured_poly_apply_dia(degree)(
        (ref_up, ref_low, ref_q, ref_a), jnp.asarray(r))
    got = sf.make_structured_poly_apply_dia(degree)(
        (c_up, c_low, q, a), torch.tensor(r))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9,
                               atol=1e-9 * np.abs(np.asarray(want)).max())


def test_fold_scaling_and_sorting_match_jax():
    ref_a = jax_poisson_coeff_dia((6, 5, 4), rng=np.random.default_rng(2),
                                  dtype=jnp.float64)
    perm = [3, 0, 6, 1, 5, 2, 4]
    shuffled_ref = JaxDIA(vals=ref_a.vals[jnp.asarray(perm)],
                          offsets=tuple(ref_a.offsets[i] for i in perm),
                          n=ref_a.n)
    shuffled = DIAMatrix(vals=torch.tensor(np.asarray(shuffled_ref.vals)),
                         offsets=shuffled_ref.offsets, n=ref_a.n)
    got = sf.dia_sorted_by_offset(shuffled)
    want = jsf.dia_sorted_by_offset(shuffled_ref)
    assert got.offsets == want.offsets
    np.testing.assert_array_equal(got.vals.numpy(), np.asarray(want.vals))

    plan = sf.build_structured_plan((6, 5, 4), power=2)
    rng = np.random.default_rng(3)
    bands = rng.standard_normal((plan.width, got.n_pad))
    d_isqrt = rng.uniform(0.5, 2.0, got.n_pad)
    np.testing.assert_allclose(
        sf.fold_scaling(torch.tensor(bands), torch.tensor(d_isqrt),
                        plan.offsets).numpy(),
        np.asarray(jsf.fold_scaling(jnp.asarray(bands), jnp.asarray(d_isqrt),
                                    plan.offsets)), rtol=1e-12)
