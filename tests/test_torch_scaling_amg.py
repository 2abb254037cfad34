"""The scaling path's amg technique (``run_scaling(..., with_amg=True)``)
at 12^3 and 16^3, float64: the port's hierarchy, built from the operator
jittered as the reference jitters it, has the JAX ``build_amg``'s level
sizes on the same jittered operator, and PCG with the DIA matvec and the
V-cycle takes the reference's iterations; amg sits out the sequences and
is built once; the committed fixture describes the run ``chip_smoke.py``
makes."""

import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppreconditioning_tpu.ops.amg import amg_apply as jax_amg_apply
from deeppreconditioning_tpu.ops.amg import build_amg as jax_build_amg
from deeppreconditioning_tpu.ops.pallas_spmv import (
    dia_matvec as jax_dia_matvec,
)
from deeppreconditioning_tpu.solvers.cg import (
    preconditioned_conjugate_gradient as jax_pcg,
)
from deeppreconditioning_tpu_torch.bench import scaling

REPO = Path(__file__).resolve().parents[1]
FIXTURE = (REPO / "tests" / "fixtures" / "torch_port"
           / "scaling_amg_iterations.json")
UNIQUE = 3  # the jitter's counter value, fixed on both sides


def _reference_script():
    spec = importlib.util.spec_from_file_location(
        "torch_port_scaling_reference",
        REPO / "scripts" / "torch_port_scaling_reference.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_amg(side):
    """The reference's hierarchy on the port's jittered operator and its
    PCG iterations on the reference's own operator and rhs."""
    a, _ = scaling.scaling_operator(side, torch.float64)
    jittered = a.vals * (1.0 + UNIQUE * 1.2e-7)
    csr = scaling.replace(a, vals=jittered).to_scipy()
    m = jax_build_amg(csr, n_pad=a.n_pad, dtype=jnp.float64)
    a_ref, b_ref, _ = _reference_script().reference_problem(
        side, jnp.float64)
    res = jax_pcg(jax_dia_matvec, a_ref, b_ref, rtol=scaling.RTOL,
                  apply_m=lambda md, r: jax_amg_apply(md, r), m_data=m)
    return m, int(res.iterations), float(res.residual)


@pytest.mark.parametrize("side", [12, 16])
def test_amg_row_matches_jax(side, monkeypatch):
    monkeypatch.setattr(scaling, "next_unique", lambda: UNIQUE)
    run = scaling.run_scaling("cpu", shapes=(side,), dtype=torch.float64,
                              reps=1, out=None, techniques=(),
                              k_solves=(2,), with_amg=True)
    a, _ = scaling.scaling_operator(side, torch.float64)
    ours = scaling.amg_setup(a)
    ref, ref_iters, ref_res = _jax_amg(side)

    assert len(ours.levels) == len(ref.levels)
    for lo, lr in zip(ours.levels, ref.levels):
        assert (lo.ell.n, lo.ell.n_pad, lo.nc_pad) == (
            lr.ell.n, lr.ell.n_pad, lr.nc_pad)
        assert lo.p_ell.cols.shape == lr.p_ell.cols.shape
        assert lo.pt_ell.cols.shape == lr.pt_ell.cols.shape
    assert ours.coarse_inv.shape == ref.coarse_inv.shape
    np.testing.assert_allclose(ours.coarse_inv.numpy(),
                               np.asarray(ref.coarse_inv), rtol=1e-9,
                               atol=1e-12)

    [row] = run.rows
    assert row["technique"] == "amg"
    assert row["iterations"] == ref_iters
    assert row["converged"] is (ref_res < scaling.RTOL) is True
    assert run.setup_calls[(side, "amg")] == 1
    assert run.seq_rows == []  # amg sits out the sequences
    parts = run.amg_builds[side]
    assert {"to_scipy", "aggregate", "galerkin", "transfer",
            "coarse"} <= set(parts)
    assert parts["level_rows"] == [lev.ell.n for lev in ref.levels] + [
        ref.coarse_inv.shape[0]]


def test_amg_is_off_unless_asked():
    assert "amg" not in scaling.TECHNIQUES
    assert "--with-amg" in scaling.__doc__


def test_fixture_describes_the_scaling_run():
    fixture = json.loads(FIXTURE.read_text())
    assert tuple(fixture["shapes"]) == scaling.SHAPES
    assert (fixture["sigma"], fixture["coeff_seed"], fixture["rhs_seed"],
            fixture["rtol"]) == (scaling.SIGMA, scaling.COEFF_SEED,
                                 scaling.RHS_SEED, scaling.RTOL)
    for side in scaling.SHAPES:
        ref = fixture["results"][str(side)]
        assert ref["n"] == side ** 3 and ref["converged"]
        # the jitter of a fresh process's run_scaling(with_amg=True)
        assert ref["next_unique"] == scaling.SHAPES.index(side) + 1
