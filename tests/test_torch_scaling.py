"""The whole structured-grid scaling slice at 16^3, f64: the port's
``run_scaling`` on the CPU against the JAX reference's technique block
(``scripts/torch_port_scaling_reference.py``, which also writes the
card's fixture) gives the same iteration counts and convergence for all
six techniques, the same learned q, and the reference's CSV header;
``pcg_fixed_trips`` counts equal the chunked solver's; the committed
fixture describes the run ``bench/scaling.py`` makes."""

import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppreconditioning_tpu_torch.bench import scaling
from deeppreconditioning_tpu_torch.ops.dia_spmv import dia_matvec
from deeppreconditioning_tpu_torch.solvers.cg import (
    pcg_fixed_trips,
    preconditioned_conjugate_gradient,
)
from deeppreconditioning_tpu_torch.train.checkpoint import load_checkpoint

REPO = Path(__file__).resolve().parents[1]
FIXTURE = (REPO / "tests" / "fixtures" / "torch_port"
           / "scaling_iterations.json")
REFERENCE_HEADER = ("shape,technique,n,sigma,iterations,setup_s,solve_s,"
                    "total_s,converged,x_rel_err,safeguard_fallback")


def _reference_script():
    spec = importlib.util.spec_from_file_location(
        "torch_port_scaling_reference",
        REPO / "scripts" / "torch_port_scaling_reference.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("scaling") / "scaling_learned.csv"
    return scaling.run_scaling("cpu", shapes=(16,), dtype=torch.float64,
                               reps=1, out=out), out


def test_slice_matches_jax_at_16(port_run):
    run, _ = port_run
    ref = _reference_script().reference_scaling(16, jnp.float64)
    rows = {r["technique"]: r for r in run.rows}
    assert list(rows) == list(scaling.TECHNIQUES)
    for name in scaling.TECHNIQUES:
        assert rows[name]["iterations"] == ref["iterations"][name], name
        assert rows[name]["converged"] == ref["converged"][name] is True
        assert rows[name]["n"] == ref["n"] == 4096
    np.testing.assert_allclose(run.learned_q[16], ref["learned_q"],
                               rtol=1e-9)
    assert rows["learned"]["safeguard_fallback"] is False
    assert ref["safeguard_fallback"] is False
    for key, calls in run.setup_calls.items():
        assert calls == (0 if key[1] == "vanilla" else 3), key


def test_csv_header_is_the_reference_schema(port_run):
    run, out = port_run
    lines = out.read_text().splitlines()
    assert lines[0] == REFERENCE_HEADER
    assert len(lines) == 1 + len(run.rows)
    learned = next(line for line in lines if ",learned," in line)
    assert learned.endswith(",False")


@pytest.mark.parametrize("technique", ["vanilla", "fsai", "gmg_learned"])
def test_fixed_trips_match_chunked_solver(technique):
    models = scaling.load_models(torch.float64)
    a, b = scaling.scaling_operator(16, torch.float64)
    apply_m, build = scaling._setups(a, (16, 16, 16), models)[technique]
    m_data = None if build is None else build()
    chunked = preconditioned_conjugate_gradient(dia_matvec, a, b, apply_m,
                                                m_data)
    iters = int(chunked.iterations)
    fixed = pcg_fixed_trips(dia_matvec, a, b, apply_m, m_data,
                            trips=min(iters + 2, 1024))
    assert int(fixed.iterations) == iters
    torch.testing.assert_close(fixed.x, chunked.x, rtol=0.0, atol=0.0)
    short = pcg_fixed_trips(dia_matvec, a, b, apply_m, m_data,
                            trips=iters - 1)
    assert int(short.iterations) == iters - 1


def test_fixture_describes_the_port_run():
    fixture = json.loads(FIXTURE.read_text())
    assert tuple(fixture["shapes"]) == scaling.SHAPES
    assert fixture["sigma"] == scaling.SIGMA
    assert fixture["coeff_seed"] == scaling.COEFF_SEED
    assert fixture["rhs_seed"] == scaling.RHS_SEED
    assert fixture["rtol"] == scaling.RTOL
    assert fixture["max_iter"] == scaling.MAX_ITER
    assert fixture["checkpoint"] == scaling.CHECKPOINT
    assert fixture["smoother_checkpoint"] == scaling.SMOOTHER_CHECKPOINT
    assert tuple(fixture["techniques"]) == scaling.TECHNIQUES
    payload = load_checkpoint(scaling.CHECKPOINT_DIR / scaling.CHECKPOINT)
    for side in scaling.SHAPES:
        res = fixture["results"][str(side)]
        assert res["n"] == side ** 3
        assert all(res["converged"].values())
        assert res["safeguard_fallback"] is False
        assert len(res["learned_q"]) == int(payload["poly_degree"]) + 1
