"""The port's geometric multigrid against the JAX package's (f64): the
Galerkin coarse operator, the transfers, ``build_gmg`` with the Jacobi
and the learned smoother (level operators, smoother factors, root
inverse) and one V-cycle at 16^3."""

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
from deeppreconditioning_tpu.ops import gmg as jgmg
from deeppreconditioning_tpu.ops.structured_fsai import dia_sorted_by_offset
from deeppreconditioning_tpu_torch.models.neural_fsai import (
    neural_fsai_from_checkpoint,
)
from deeppreconditioning_tpu_torch.ops import gmg
from deeppreconditioning_tpu_torch.sparse.dia import DIAMatrix
from deeppreconditioning_tpu_torch.train.checkpoint import load_checkpoint

SMOOTHER = (Path(__file__).resolve().parents[1] / "assets"
            / "checkpoints_structured" / "deg0_p1.msgpack")


def _pair(shape, seed):
    ref = dia_sorted_by_offset(jax_poisson_coeff_dia(
        shape, rng=np.random.default_rng(seed), sigma=1.0,
        dtype=jnp.float64))
    got = DIAMatrix(vals=torch.tensor(np.asarray(ref.vals)),
                    offsets=ref.offsets, n=ref.n)
    return ref, got


def _close(got, want, rtol=1e-9):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("shape", [(8, 6, 4), (16, 16, 16), (12, 8)])
def test_galerkin_and_transfers_match_jax(shape):
    ref, a = _pair(shape, seed=0)
    want = jgmg.galerkin_coarse_dia(ref, shape)
    got = gmg.galerkin_coarse_dia(a, shape)
    assert got.offsets == want.offsets and got.n == want.n
    _close(got.vals, want.vals)

    rng = np.random.default_rng(1)
    r = rng.standard_normal(a.n_pad)
    _close(gmg.restrict_pc(torch.tensor(r), shape),
           jgmg.restrict_pc(jnp.asarray(r), shape))
    xc = rng.standard_normal(got.n_pad)
    _close(gmg.prolong_pc(torch.tensor(xc), shape),
           jgmg.prolong_pc(jnp.asarray(xc), shape))


def _smoothers():
    payload = serialization.msgpack_restore(SMOOTHER.read_bytes())
    params = jax.tree.map(lambda v: jnp.asarray(v, jnp.float64),
                          payload["params"])
    model = neural_fsai_from_checkpoint(load_checkpoint(SMOOTHER))
    return params, model.double().eval(), int(payload["power"])


@pytest.mark.parametrize("smoother", ["jacobi", "learned"])
def test_build_gmg_and_apply_match_jax(smoother):
    shape = (16, 16, 16)
    ref, a = _pair(shape, seed=3)
    if smoother == "jacobi":
        want = jgmg.build_gmg(ref, shape)
        with torch.no_grad():
            got = gmg.build_gmg(a, shape)
    else:
        params, model, power = _smoothers()
        want = jgmg.build_gmg(ref, shape, params=params, plan_power=power,
                              fsai_smoother=True, fsai_levels=1)
        with torch.no_grad():
            got = gmg.build_gmg(a, shape, model=model, plan_power=power,
                                fsai_levels=1)
    assert len(got.levels) == len(want.levels) == 1
    assert got.coarse_shape == want.coarse_shape == (8, 8, 8)
    for lev, ref_lev in zip(got.levels, want.levels):
        assert lev.shape == ref_lev.shape and lev.omega == ref_lev.omega
        _close(lev.a.vals, ref_lev.a.vals)
        _close(lev.inv_diag, ref_lev.inv_diag)
        assert (lev.c_up is None) == (ref_lev.c_up is None)
        if lev.c_up is not None:
            assert lev.c_up.offsets == ref_lev.c_up.offsets
            assert lev.c_low.offsets == ref_lev.c_low.offsets
            _close(lev.c_up.vals, ref_lev.c_up.vals)
            _close(lev.c_low.vals, ref_lev.c_low.vals)
    _close(got.coarse_inv, want.coarse_inv)

    r = np.random.default_rng(4).standard_normal(a.n_pad)
    r[a.n:] = 0.0
    _close(gmg.gmg_apply(got, torch.tensor(r)),
           jgmg.gmg_apply(want, jnp.asarray(r)))
