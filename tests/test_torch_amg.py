"""The port's aggregation AMG against the JAX package's (f64): the same
hierarchy (aggregates, transfers, level operators, root inverse) and the
same V(1,1)-cycle; and the batched protocol's dense composition
``_amg_dense_compose`` equals the cycle on identity columns, the
reference's own check (``tests/test_bench_suite.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from deeppreconditioning_tpu.ops import amg as jax_amg
from deeppreconditioning_tpu_torch.bench.suite import _amg_dense_compose
from deeppreconditioning_tpu_torch.data.fvm import (
    generate_sludge_case,
    generate_sludge_case_3d,
)
from deeppreconditioning_tpu_torch.ops import amg
from deeppreconditioning_tpu_torch.data.fvm import numpy_assembly


@pytest.fixture(autouse=True, scope="module")
def _numpy_fvm_assembly():
    """The port's numpy FVM assembly: the route the reference's counts
    and arrays held here were made on."""
    with numpy_assembly():
        yield


def _systems():
    out = {}
    case = generate_sludge_case(np.random.default_rng(1), mesh_cells=1)
    out["sludge"] = (case.matrix.tocsr(), 256, {})
    case = generate_sludge_case_3d(np.random.default_rng(3), mesh_cells=1)
    n = case.matrix.shape[0]
    out["3d"] = (case.matrix.tocsr(), ((n + 7) // 8) * 8, {})
    # a 2-D Poisson system deep enough for two levels
    k = 48
    t = sp.diags([-np.ones(k - 1), 2 * np.ones(k), -np.ones(k - 1)],
                 [-1, 0, 1])
    lap = sp.kronsum(t, t).tocsr()
    out["poisson_two_level"] = (lap, k * k, {"coarse_target": 64})
    out["piecewise_constant"] = (lap, k * k,
                                 {"smooth_prolongation": False,
                                  "coarse_target": 64})
    return out


with numpy_assembly():
    SYSTEMS = _systems()


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_hierarchy_and_cycle_match_jax(name):
    a, n_pad, kw = SYSTEMS[name]
    ours = amg.build_amg(a, n_pad=n_pad, dtype=torch.float64, **kw)
    ref = jax_amg.build_amg(a, n_pad=n_pad, dtype=jnp.float64, **kw)
    assert len(ours.levels) == len(ref.levels) >= 1
    if name != "sludge" and name != "3d":
        assert len(ours.levels) >= 2
    for lo, lr in zip(ours.levels, ref.levels):
        assert (lo.nc_pad, lo.omega) == (lr.nc_pad, lr.omega)
        np.testing.assert_array_equal(_np(lo.agg), _np(lr.agg))
        np.testing.assert_array_equal(_np(lo.ell.cols), _np(lr.ell.cols))
        np.testing.assert_allclose(_np(lo.ell.vals), _np(lr.ell.vals),
                                   rtol=1e-13)
        np.testing.assert_allclose(_np(lo.inv_diag), _np(lr.inv_diag),
                                   rtol=1e-13)
        for t in ("p_ell", "pt_ell"):
            to, tr = getattr(lo, t), getattr(lr, t)
            assert (to is None) == (tr is None)
            if to is not None:
                np.testing.assert_array_equal(_np(to.cols), _np(tr.cols))
                np.testing.assert_allclose(_np(to.vals), _np(tr.vals),
                                           rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(_np(ours.coarse_inv), _np(ref.coarse_inv),
                               rtol=1e-9, atol=1e-12)

    r = np.zeros(n_pad)
    r[:a.shape[0]] = np.random.default_rng(0).standard_normal(a.shape[0])
    z = amg.amg_apply(ours, torch.tensor(r)).numpy()
    z_ref = np.asarray(jax_amg.amg_apply(ref, jnp.asarray(r)))
    np.testing.assert_allclose(z, z_ref, rtol=1e-10, atol=1e-13)


def test_dense_compose_matches_the_cycle():
    """The batched dense V-cycle reproduces amg_apply's one-level cycle
    (no coarse filter) on every identity column."""
    cases = [generate_sludge_case(np.random.default_rng(s), mesh_cells=1)
             for s in (6, 7)]
    n_pad = 256
    a_tildes, d_sqrts, ps, mcs, n0s, pres = [], [], [], [], [], []
    for case in cases:
        a = case.matrix.tocsr()
        n = a.shape[0]
        d = np.sqrt(a.diagonal())
        a_t = np.zeros((n_pad, n_pad))
        a_t[:n, :n] = (sp.diags(1 / d) @ a @ sp.diags(1 / d)).toarray()
        d_p = np.ones(n_pad)
        d_p[:n] = d
        agg, nc = amg._aggregate(a, 0.08)
        p = amg._prolongation(a, agg, nc, 0.67)
        inv = np.linalg.inv((p.T @ a @ p).toarray())
        p_pad = np.zeros((n_pad, 64))
        p_pad[:n, :nc] = p.toarray()
        mc = np.zeros((64, 64))
        mc[:nc, :nc] = 0.5 * (inv + inv.T)
        a_tildes.append(a_t)
        d_sqrts.append(d_p)
        ps.append(p_pad)
        mcs.append(mc)
        n0s.append(n)
        pres.append(amg.build_amg(a, n_pad=n_pad, dtype=torch.float64,
                                  filter_eps=0.0))
    m = _amg_dense_compose(
        torch.tensor(np.stack(a_tildes)), torch.tensor(np.stack(d_sqrts)),
        torch.tensor(n0s), torch.tensor(np.stack(ps)),
        torch.tensor(np.stack(mcs)))
    for i, pre in enumerate(pres):
        assert len(pre.levels) == 1
        eye = torch.eye(n_pad, dtype=torch.float64)
        cols = torch.stack([amg.amg_apply(pre, eye[j])
                            for j in range(n0s[i])], dim=1)
        np.testing.assert_allclose(m[i, :n0s[i], :n0s[i]].numpy(),
                                   cols[:n0s[i]].numpy(),
                                   rtol=1e-9, atol=1e-12)
