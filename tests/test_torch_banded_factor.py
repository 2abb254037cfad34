"""The port's band-form factor apply against the JAX package's (f64):
band extraction, the two banded matvecs and the polynomial apply; and on
a sludge case the banded learned apply of the batched protocol equals the
per-case dense learned M times r."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppreconditioning_tpu.ops import banded_factor as jax_bf
from deeppreconditioning_tpu.ops.fsai import (
    build_range_fsai_plan as jax_build_range,
)
from deeppreconditioning_tpu_torch.bench.suite import (
    BenchmarkSuite,
    _learned_banded_setup_group,
    _scaled_dense_matvec,
)
from deeppreconditioning_tpu_torch.data.datasets import SludgePatternDataSet
from deeppreconditioning_tpu_torch.data.fvm import generate_sludge_case
from deeppreconditioning_tpu_torch.models.neural_fsai import (
    neural_fsai_dense_preconditioner,
    neural_fsai_from_checkpoint,
)
from deeppreconditioning_tpu_torch.ops import banded_factor as bf
from deeppreconditioning_tpu_torch.ops.fsai import (
    tril_power_pattern,
)
from deeppreconditioning_tpu_torch.train.checkpoint import load_checkpoint

CKPT = (Path(__file__).resolve().parents[1] / "assets" / "checkpoints_fsai"
        / "best.msgpack")


def _plan_rows():
    """out_rows of a real FSAI range plan (power 2 on an FVM case) and a
    random value array of its shape."""
    case = generate_sludge_case(np.random.default_rng(4), mesh_cells=1)
    coo = case.matrix.tocoo()
    keep = coo.row >= coo.col
    n_pad = 256
    pad = np.arange(case.matrix.shape[0], n_pad)  # identity padding
    pr, pc = tril_power_pattern(
        np.concatenate([coo.row[keep], pad]).astype(np.int32),
        np.concatenate([coo.col[keep], pad]).astype(np.int32), n_pad,
        power=2)
    plan = jax_build_range(pr, pc, n_pad, range_h=128)
    out_rows = np.asarray(plan.out_rows)
    vals = np.random.default_rng(0).standard_normal(out_rows.shape)
    return out_rows, np.where(out_rows < n_pad, vals, 0.0), n_pad


OUT_ROWS, C_VALS, N_PAD = _plan_rows()


def test_band_spread_and_extract_bands_match_jax():
    d_max = bf.band_spread(OUT_ROWS, N_PAD)
    assert d_max == jax_bf.band_spread(OUT_ROWS, N_PAD) > 1
    d_isqrt = np.random.default_rng(1).uniform(0.5, 2.0, N_PAD)
    for kw in ({}, {"d_isqrt": d_isqrt, "n0": 200}):
        ours = bf.extract_bands(
            torch.tensor(OUT_ROWS).long(), torch.tensor(C_VALS), d_max,
            **{k: torch.tensor(v) if k == "d_isqrt" else v
               for k, v in kw.items()})
        ref = jax_bf.extract_bands(
            jnp.asarray(OUT_ROWS), jnp.asarray(C_VALS), d_max,
            **{k: jnp.asarray(v) if k == "d_isqrt" else v
               for k, v in kw.items()})
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                   rtol=1e-14, atol=0)
    # a group extracts per case; an offset past d_max is dropped
    two = bf.extract_bands(torch.tensor(np.stack([OUT_ROWS] * 2)).long(),
                           torch.tensor(np.stack([C_VALS, 2 * C_VALS])),
                           d_max - 1, n0=torch.tensor([N_PAD, 100]))
    ref = np.asarray(jax_bf.extract_bands(
        jnp.asarray(OUT_ROWS), jnp.asarray(2 * C_VALS), d_max - 1, n0=100))
    np.testing.assert_allclose(two[1].numpy(), ref, rtol=1e-14, atol=0)


@pytest.mark.parametrize("d_n", [1, 5, 37])
def test_banded_matvecs_match_jax(d_n):
    rng = np.random.default_rng(d_n)
    bands = rng.standard_normal((3, d_n, 64))
    x = rng.standard_normal((3, 64))
    for name in ("banded_upper_matvec", "banded_lower_matvec"):
        ours = getattr(bf, name)(torch.tensor(bands), torch.tensor(x))
        ref = getattr(jax_bf, name)(jnp.asarray(bands), jnp.asarray(x))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                   rtol=1e-12, atol=1e-13)
    # against the dense lower-triangular C of the bands
    c = np.zeros((64, 64))
    for d in range(d_n):
        j = np.arange(64 - d)
        c[j + d, j] = bands[0, d, :64 - d]
    np.testing.assert_allclose(
        bf.banded_lower_matvec(torch.tensor(bands[0]),
                               torch.tensor(x[0])).numpy(),
        c @ x[0], rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("degree", [0, 2])
def test_poly_apply_matches_jax(degree):
    rng = np.random.default_rng(degree)
    n, d_n = 48, 6
    bands = rng.standard_normal((2, d_n, n)) * 0.3
    q = rng.standard_normal((2, degree + 1))
    a = rng.standard_normal((2, n, n))
    a = a @ a.transpose(0, 2, 1)
    d = rng.uniform(0.5, 2.0, (2, n))
    r = rng.standard_normal((2, n))

    def jax_matvec(a_data, x):
        at, ds = a_data
        return ds * jnp.einsum("bij,bj->bi", at, ds * x)

    ours = bf.make_banded_poly_apply(_scaled_dense_matvec, degree)(
        (torch.tensor(bands), torch.tensor(q),
         (torch.tensor(a), torch.tensor(d))), torch.tensor(r))
    ref = jax_bf.make_banded_poly_apply(jax_matvec, degree)(
        (jnp.asarray(bands), jnp.asarray(q),
         (jnp.asarray(a), jnp.asarray(d))), jnp.asarray(r))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-11,
                               atol=1e-12)


def test_banded_learned_apply_equals_dense_learned_m():
    """On the sludge split: the batched protocol's banded learned apply
    (static-start range group, bands, polynomial apply) equals the
    per-case dense learned M r of the same case."""
    rng = np.random.default_rng(17)
    cases = [generate_sludge_case(rng, mesh_cells=1) for _ in range(10)]
    ds = SludgePatternDataSet(stage="test", cases=cases)
    payload = load_checkpoint(CKPT)
    power = int(payload["power"])
    suite = BenchmarkSuite(ds, neural_fsai_from_checkpoint(payload),
                           techniques=("learned",), device="cpu",
                           dtype=torch.float64, learned_power=power)
    common = suite._batched_common()
    groups = suite._batched_fsai_inputs(power, suite.model.width)
    idx, plans, _, kind = groups[0]
    assert kind == "range" and plans.lo_static is not None
    d_max = max(bf.band_spread(p.out_rows.numpy(), ds.dof_pad)
                for _, p, _, _ in groups)
    with torch.no_grad():
        bands, q = _learned_banded_setup_group(
            suite.model, plans, common["a_tilde"][idx],
            common["d_sqrt"][idx] ** 2, common["n0"][idx], d_max,
            torch.float64)
        apply = bf.make_banded_poly_apply(_scaled_dense_matvec,
                                          suite.model.poly_degree)
        r = torch.tensor(np.random.default_rng(0).standard_normal(
            (idx.shape[0], ds.dof_pad)))
        r = r * (torch.arange(ds.dof_pad) < common["n0"][idx][:, None])
        z = apply((bands, q, (common["a_tilde"][idx],
                               common["d_sqrt"][idx])), r)
        for i, case in enumerate(idx.tolist()):
            _, ell, _ = suite._system(case)
            _, plan, _, _ = suite._fsai_plan(
                case, ell, width=suite.model.width, power=power)
            # the per-case setup on the batched protocol's operands
            m = neural_fsai_dense_preconditioner(
                suite.model, plan, common["a_tilde"][case],
                common["d_sqrt"][case] ** 2,
                ds.host_sample(case).original_size, dtype=torch.float64)
            np.testing.assert_allclose(z[i].numpy(), (m @ r[i]).numpy(),
                                       rtol=1e-9, atol=1e-11)
