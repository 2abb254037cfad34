"""The rest of the scaling protocol against the JAX package, f64 on the
CPU: ``poisson_rhs_sequence`` and ``poisson_family``; the solvers
``pcg_sequence_fixed_trips``, ``pcg_with_history``,
``conjugate_gradient`` and ``benchmark_cg``; the stencil operators
against ``poisson_dia`` and the reference's; ``run_scaling`` at 16^3 with
the known-solution rhs, sigma 0 and sequences of 2 and 4 against the
reference's technique block (``scripts/torch_port_scaling_reference.py``),
with the ``multi_rhs.csv`` schema and the crossover; ``large_solve``'s
count against the reference's CG; and the committed fixture's protocol
part describes the run ``bench/scaling.py`` makes."""

import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from deeppreconditioning_tpu.data import poisson as jpoisson
from deeppreconditioning_tpu.ops import pallas_stencil as jstencil
from deeppreconditioning_tpu.solvers import cg as jcg
from deeppreconditioning_tpu.sparse.dia import poisson_dia as jax_poisson_dia
from deeppreconditioning_tpu_torch.bench import scaling
from deeppreconditioning_tpu_torch.bench.large_solve import large_solve
from deeppreconditioning_tpu_torch.data import poisson
from deeppreconditioning_tpu_torch.ops import stencil
from deeppreconditioning_tpu_torch.ops.dia_spmv import dia_matvec
from deeppreconditioning_tpu_torch.solvers import cg
from deeppreconditioning_tpu_torch.sparse.dia import DIAMatrix, poisson_dia

REPO = Path(__file__).resolve().parents[1]
FIXTURE = (REPO / "tests" / "fixtures" / "torch_port"
           / "scaling_iterations.json")
SEQ_HEADER = ("shape,technique,n,sigma,k_solves,iterations_mean,setup_s,"
              "solves_s,total_s,converged")
PROTOCOL_TECHNIQUES = ("vanilla", "learned")


def _reference_script():
    spec = importlib.util.spec_from_file_location(
        "torch_port_scaling_reference",
        REPO / "scripts" / "torch_port_scaling_reference.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_dia_matvec(a, x):
    return a.matvec(x)


def _diag(d, r):
    return d * r


def _operator_pair(shape=(8, 8, 8), seed=3):
    ref = jpoisson.poisson_coeff_dia(shape, rng=np.random.default_rng(seed),
                                     dtype=jnp.float64)
    got = DIAMatrix(vals=torch.tensor(np.asarray(ref.vals)),
                    offsets=tuple(ref.offsets), n=ref.n)
    return ref, got


def test_rhs_sequence_and_family_match_jax():
    ref_a, a = _operator_pair()
    want_b, want_x = jpoisson.poisson_rhs_sequence(
        ref_a, 3, np.random.default_rng(9))
    got_b, got_x = poisson.poisson_rhs_sequence(a, 3,
                                                np.random.default_rng(9))
    np.testing.assert_array_equal(got_x, want_x)
    np.testing.assert_allclose(got_b, want_b, rtol=1e-12, atol=1e-12)
    want_m, want_r = jpoisson.poisson_family(2, (6, 5, 4), seed=4,
                                             sigma=0.7, dtype=jnp.float64)
    got_m, got_r = poisson.poisson_family(2, (6, 5, 4), seed=4, sigma=0.7,
                                          dtype=torch.float64)
    for wm, wr, gm, gr in zip(want_m, want_r, got_m, got_r):
        assert gm.offsets == tuple(wm.offsets)
        np.testing.assert_array_equal(gm.vals.numpy(), np.asarray(wm.vals))
        np.testing.assert_allclose(gr, wr, rtol=1e-12, atol=1e-12)


def test_sequence_and_history_solvers_match_jax():
    ref_a, a = _operator_pair()
    rng = np.random.default_rng(5)
    b_seq = rng.standard_normal((3, a.n_pad))
    b_seq[:, a.n:] = 0.0
    d = a.vals[a.offsets.index(0)]
    inv = torch.where(d == 0, torch.zeros_like(d), 1.0 / d)
    want_x, want_it, want_res = jcg.pcg_sequence_fixed_trips(
        _jax_dia_matvec, ref_a, jnp.asarray(b_seq), _diag,
        jnp.asarray(inv.numpy()), trips=40)
    got_x, got_it, got_res = cg.pcg_sequence_fixed_trips(
        dia_matvec, a, torch.tensor(b_seq), _diag, inv, trips=40)
    np.testing.assert_array_equal(got_it.numpy(), np.asarray(want_it))
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(got_res.numpy(), np.asarray(want_res),
                               rtol=1e-6)
    want, want_hist = jcg.pcg_with_history(
        _jax_dia_matvec, ref_a, jnp.asarray(b_seq[0]), _diag,
        jnp.asarray(inv.numpy()), max_iter=48)
    got, got_hist = cg.pcg_with_history(dia_matvec, a,
                                        torch.tensor(b_seq[0]), _diag, inv,
                                        max_iter=48)
    assert int(got.iterations) == int(want.iterations) < 48
    np.testing.assert_allclose(got_hist.numpy(), np.asarray(want_hist),
                               rtol=1e-6, atol=1e-30)
    assert float(got_hist[-1]) < 1e-8
    plain = cg.conjugate_gradient(dia_matvec, a, torch.tensor(b_seq[1]))
    ref = jcg.conjugate_gradient(_jax_dia_matvec, ref_a,
                                 jnp.asarray(b_seq[1]))
    # unpreconditioned CG amplifies the two summation orders' rounding:
    # the iterates agree to ~1e-7 of max|x|, well inside the solve's own
    # error at ||r||^2 / ||b||^2 < 1e-8
    assert int(plain.iterations) == int(ref.iterations)
    np.testing.assert_allclose(plain.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=1e-6 * np.abs(np.asarray(ref.x)).max())


def test_benchmark_cg_matches_jax():
    mat = _operator_pair((6, 5, 4))[1].to_scipy()
    rhs = np.random.default_rng(6).standard_normal(mat.shape[0])
    jacobi = sp.diags(1.0 / mat.diagonal())
    for m in (None, jacobi):
        _, got_it, got_info = cg.benchmark_cg(mat, rhs, m)
        _, want_it, want_info = jcg.benchmark_cg(mat, rhs, m)
        assert (got_it, got_info) == (want_it, want_info)
        assert 0 < got_it < 512 and got_info == 0


@pytest.mark.parametrize("shape", [(8, 6, 5), (4, 4, 4)])
def test_stencils_match_poisson_dia_and_jax(shape):
    a = poisson_dia(shape, dtype=torch.float64)
    rng = np.random.default_rng(7)
    x = torch.tensor(rng.standard_normal(a.n_pad))
    x[a.n:] = 0.0
    want = a.matvec(x)
    op = stencil.StencilOperator3D(shape=shape)
    ref_op = jstencil.StencilOperator3D(shape=shape)
    for got in (stencil.poisson3d_stencil_matvec(x, shape),
                stencil.stencil_matvec_flat(op, x)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-14,
                                   atol=1e-14)
    xp = op.embed(x)
    assert xp.shape == (op.size,)
    np.testing.assert_array_equal(
        xp.numpy(), np.asarray(ref_op.embed(jnp.asarray(x.numpy()))))
    yp = stencil.stencil_matvec_padded(op, xp)
    np.testing.assert_allclose(
        yp.numpy(), np.asarray(jstencil.stencil_matvec_padded(
            ref_op, jnp.asarray(xp.numpy()))), rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(op.extract(yp).numpy(), want[:a.n].numpy(),
                               rtol=1e-14, atol=1e-14)
    shape2 = shape[1:]
    a2 = poisson_dia(shape2, dtype=torch.float64)
    x2 = torch.tensor(rng.standard_normal(a2.n_pad))
    x2[a2.n:] = 0.0
    got2 = stencil.poisson2d_stencil_matvec(x2, shape2)
    np.testing.assert_allclose(got2.numpy(), a2.matvec(x2).numpy(),
                               rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(
        got2.numpy(), np.asarray(jstencil.poisson2d_stencil_matvec(
            jnp.asarray(x2.numpy()), shape2)), rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(
        a.to_dense().numpy(),
        np.asarray(jax_poisson_dia(shape, dtype=jnp.float64).to_scipy()
                   .toarray()), rtol=0, atol=0)


@pytest.mark.parametrize("rhs", ["random", "ax"])
def test_rhs_sequences_match_reference(rhs):
    """Both sequence sources (the random walk of b, and drifting known
    solutions) against the reference script's, on the default operator."""
    ref_script = _reference_script()
    ref_a, ref_b, ref_x = ref_script.reference_problem(16, jnp.float64,
                                                       rhs=rhs)
    a, b, x_star = scaling.scaling_problem(16, torch.float64, rhs=rhs)
    np.testing.assert_array_equal(b.numpy(), np.asarray(ref_b))
    for k in (2, 3):
        want = ref_script.rhs_sequence(ref_a, ref_b, ref_x, k, jnp.float64)
        got = scaling.rhs_sequence(a, b, x_star, k)
        assert got.shape == (k, a.n_pad)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-12, atol=1e-12)


@pytest.fixture(scope="module")
def protocol_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("protocol")
    run = scaling.run_scaling(
        "cpu", shapes=(16,), dtype=torch.float64, reps=1,
        out=out / "scaling_learned.csv", techniques=PROTOCOL_TECHNIQUES,
        sigma=0.0, rhs="ax", k_solves=(2, 4), seq_out=out / "multi_rhs.csv")
    return run, out


def test_protocol_matches_jax_at_16(protocol_run):
    run, _ = protocol_run
    ref = _reference_script().reference_scaling(
        16, jnp.float64, sigma=0.0, rhs="ax", k_solves=(2, 4),
        techniques=PROTOCOL_TECHNIQUES)
    rows = {r["technique"]: r for r in run.rows}
    assert list(rows) == list(PROTOCOL_TECHNIQUES)
    for name in PROTOCOL_TECHNIQUES:
        row = rows[name]
        assert row["sigma"] == 0.0 and row["n"] == 4096
        assert row["iterations"] == ref["iterations"][name], name
        assert row["converged"] is ref["converged"][name] is True
        np.testing.assert_allclose(row["x_rel_err"], ref["x_rel_err"][name],
                                   rtol=1e-6)
        assert row["x_rel_err"] < 1e-2
        for k in (2, 4):
            seq = next(r for r in run.seq_rows
                       if r["technique"] == name and r["k_solves"] == k)
            want = ref["sequences"][name][str(k)]
            assert seq["iterations_mean"] == want["iterations_mean"], (name, k)
            assert seq["converged"] is want["converged"] is True
    np.testing.assert_allclose(run.learned_q[16], ref["learned_q"],
                               rtol=1e-9)
    assert run.details["16_learned"]["it"] == ref["iterations"]["learned"]


def test_multi_rhs_csv_and_crossover(protocol_run):
    run, out = protocol_run
    lines = (out / "multi_rhs.csv").read_text().splitlines()
    assert lines[0] == SEQ_HEADER
    assert len(lines) == 1 + len(run.seq_rows) == 1 + 2 * 2
    rows = [{"shape": "16^3", "technique": t, "k_solves": k, "total_s": v}
            for k, totals in ((2, (1.0, 3.0, 2.0)), (4, (4.0, 3.0, 5.0)))
            for t, v in zip(("vanilla", "learned", "fsai"), totals)]
    assert scaling.crossover_k(rows, 16, (2, 4)) == 4
    assert scaling.crossover_k(rows, 16, (2,)) is None
    crossover = scaling.crossover_k(run.seq_rows, 16, (2, 4))
    assert run.details.get("16_crossover_k") == crossover


def test_large_solve_count_matches_jax():
    got = large_solve(16, device="cpu", dtype=torch.float64)
    op = jstencil.StencilOperator3D(shape=(16, 16, 16))
    b = np.random.default_rng(0).standard_normal(16 ** 3).astype(np.float32)
    want = jcg.conjugate_gradient(jstencil.stencil_matvec_flat, op,
                                  jnp.asarray(b, jnp.float64))
    assert got.iterations == int(want.iterations) > 0
    assert got.residual < 1e-8
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-8,
                               atol=1e-10)
    assert got.line().startswith(f"grid 16^3: n=4,096 dof, {got.iterations} "
                                 "iterations in ")


def test_fixture_describes_the_protocols():
    fixture = json.loads(FIXTURE.read_text())
    assert fixture["k_solves"] == [2, 4, 8]
    assert (fixture["seq_seed"], fixture["seq_step"]) == (
        scaling.SEQ_SEED, scaling.SEQ_STEP)
    for side in map(str, scaling.SHAPES):
        for name in scaling.TECHNIQUES:
            for k in fixture["k_solves"]:
                seq = fixture["sequences"][side][name][str(k)]
                assert len(seq["iterations"]) == k and seq["converged"]
                assert seq["iterations_mean"] == np.mean(seq["iterations"])
                single = fixture["results"][side]["iterations"][name]
                assert seq["trips"] == min(int(single * 1.3) + 4, 1024)
    side = "64"
    ax, flat = fixture["ax"][side], fixture["sigma0"][side]
    assert ax["vanilla_f64"] > 0 and flat["vanilla_f64"] > 0
    assert (ax["rhs"], ax["sigma"], flat["rhs"], flat["sigma"]) == (
        "ax", scaling.SIGMA, "random", 0.0)
    assert set(ax["x_rel_err"]) == set(scaling.TECHNIQUES)
    assert all(ax["converged"].values()) and all(flat["converged"].values())
