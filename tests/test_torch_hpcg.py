"""HPCG's problem on the port's structured path (``data/poisson.
hpcg_operator`` / ``hpcg_rhs``, the box plan of ``ops/structured_fsai``)
against a dense assembly and against the benchmark's plain float64
reference (``portbench/reference/hpcg.py``), on the CPU; and the 7-point
plan and setup, which reading the stencil from the operator must leave
bit for bit as they were.
"""

import hashlib
import itertools

import numpy as np
import pytest
import torch

from deeppreconditioning_tpu_torch.bench import scaling
from deeppreconditioning_tpu_torch.data.poisson import (
    hpcg_operator,
    hpcg_rhs,
    poisson_coeff_dia,
)
from deeppreconditioning_tpu_torch.models.neural_fsai import (
    NeuralFSAI,
    params_from_jax,
)
from deeppreconditioning_tpu_torch.ops.dia_spmv import dia_matvec
from deeppreconditioning_tpu_torch.ops import structured_fsai as sf
from deeppreconditioning_tpu_torch.solvers.cg import (
    preconditioned_conjugate_gradient,
)
from deeppreconditioning_tpu_torch.utils import tracing
from portbench.reference import hpcg as ref
from portbench.reference.msgpack import mlp_weights
from portbench.reference.pcg import pcg
from portbench.reference.structured import Bands, poly_apply
from scripts.make_structured_head import head_payload


def _dense_hpcg(shape) -> np.ndarray:
    """HPCG's matrix assembled cell by cell, as ``GenerateProblem_ref``
    does: 26 on the diagonal, -1 for every neighbour inside the box."""
    n = int(np.prod(shape))
    a = np.zeros((n, n))
    cells = list(itertools.product(*(range(s) for s in shape)))
    index = {c: i for i, c in enumerate(cells)}
    for c in cells:
        for d in itertools.product((-1, 0, 1), repeat=3):
            nb = tuple(ci + di for ci, di in zip(c, d))
            if nb in index:
                a[index[c], index[nb]] = 26.0 if nb == c else -1.0
    return a


@pytest.mark.parametrize("side", [6, 8])
def test_operator_against_dense_assembly(side):
    shape = (side, side, side)
    a = hpcg_operator(shape, dtype=torch.float64)
    assert len(a.offsets) == 27 and list(a.offsets) == sorted(a.offsets)
    assert a.vals.dtype == torch.float64
    assert hpcg_operator(shape).vals.dtype == torch.float32
    dense = a.to_dense().numpy()
    want = _dense_hpcg(shape)
    n = a.n
    np.testing.assert_array_equal(dense[:n, :n], want)
    assert not dense[n:].any() and not dense[:, n:].any()
    # rows of boundary cells: a corner has 7 neighbours and itself, a
    # face cell 17; b = A 1 is 26 less the neighbours, 0 inside
    b = hpcg_rhs(a).numpy()
    np.testing.assert_array_equal(b[:n], want.sum(axis=1))
    assert b[0] == 26 - 7 and b[n:].sum() == 0
    face = (side // 2) * side + side // 2  # (0, mid, mid)
    assert b[face] == 26 - 17
    inner = (side * side + side + 1) * (side // 2)
    assert b[inner] == 0


def test_reference_operator_is_the_same():
    shape = (7, 6, 5)
    vals, offsets = ref.hpcg_bands(shape, "cpu")
    a = hpcg_operator(shape, dtype=torch.float64)
    assert offsets == a.offsets
    assert torch.equal(vals, a.vals)


def _box_offsets(shape, power):
    strides = np.array([shape[1] * shape[2], shape[2], 1])
    return sorted({int(np.dot(d, strides)) for d in itertools.product(
        range(-power, power + 1), repeat=3) if np.dot(d, strides) >= 0})


@pytest.mark.parametrize("shape,power,width", [
    ((8, 8, 8), 1, 14), ((12, 10, 9), 1, 14), ((12, 12, 12), 2, 63)])
def test_box_plan(shape, power, width):
    """The plan reads the 3^3 box from the operator's 27 offsets: w is 14
    at power 1 (tril(A)), its offsets are the box's nonnegative ones and
    its operator offsets the 27 bands, each slot class the box vectors of
    its offset; the reference's slots agree."""
    a = hpcg_operator(shape)
    steps = sf.stencil_displacements(3, a.offsets, shape)
    assert len(steps) == 27
    assert {tuple(s) for s in steps} == set(
        itertools.product((-1, 0, 1), repeat=3))
    plan = sf.build_structured_plan(shape, power, a_offsets=a.offsets)
    assert plan.width == width
    assert list(plan.offsets) == _box_offsets(shape, power)
    assert plan.a_offsets == a.offsets
    ref_offsets, ref_classes = ref.box_slots(shape, power)
    assert list(plan.offsets) == ref_offsets
    for got, want in zip(plan.disp_classes, ref_classes):
        assert {tuple(v) for v in got} == {tuple(v) for v in want}
    # every slot pair one box step apart reads a band
    for p, q in itertools.product(range(width), repeat=2):
        delta = plan.offsets[q] - plan.offsets[p]
        assert (plan.delta_idx[p, q] >= 0) == (delta in a.offsets)
    assert sf.build_structured_plan(shape, power, a_offsets=a.offsets) is plan


def test_stencil_offsets_that_are_no_step():
    with pytest.raises(ValueError, match="no stencil step"):
        sf.stencil_displacements(3, (0, 2), (8, 8, 8))
    with pytest.raises(ValueError, match="2 stencil steps"):
        # strides (2, 1, 1): offset 3 is (1, 1, 0) and (1, 0, 1)
        sf.stencil_displacements(3, (0, 3), (4, 2, 1))


# -- the port against the float64 reference, 12^3 ------------------------

SHAPE = (12, 12, 12)


def _head(seed: int, dtype=torch.float64):
    payload = head_payload(14, 64, 1, 1, seed)
    model = NeuralFSAI(14, 64, 1)
    model.load_state_dict(params_from_jax(payload["params"]))
    return model.to(dtype).eval(), mlp_weights(payload)


def _port_setup(dtype, seed):
    a = hpcg_operator(SHAPE, dtype=dtype)
    model, weights = _head(seed, dtype)
    plan = sf.build_structured_plan(SHAPE, 1, a_offsets=a.offsets)
    with torch.no_grad():
        bands, q = sf.structured_setup(a, plan, model)
    return a, plan, bands, q, weights


def _reference(weights, precision=None):
    vals, offsets = ref.hpcg_bands(SHAPE, "cpu")
    return ref.learned_setup(vals, offsets, SHAPE, ref.box_slots(SHAPE, 1),
                             weights, "cpu", precision)


def _gap(got, want):
    return float((got.double() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("seed", [3, 14])
def test_setup_against_reference(seed):
    """Bands and q of the port's setup against the reference's.  Float64:
    the two differ only in the order of their operations (B1's
    Gauss-Jordan against an LU solve, the MLP's sums), so 1e-12 of the
    largest entry.  Float32: each stage rounds at 6e-8 relative, and the
    w-14 local solves of the box stencil (well conditioned, diagonal 26
    against 26 entries of -1) and the refinement keep that near 1.5e-7:
    2e-6 leaves a factor of ten; the reference in bfloat16 (8 bits of
    mantissa, 4e-3 relative) reads ~6e-3 on the bands."""
    bands_ref, q_ref = _reference(_head(seed)[1])
    a, plan, bands, q, _ = _port_setup(torch.float64, seed)
    assert plan.width == bands.shape[0] == 14
    assert _gap(bands, bands_ref) < 1e-12
    assert _gap(q, q_ref) < 1e-12
    _, _, bands32, q32, weights = _port_setup(torch.float32, seed)
    assert bands32.dtype == torch.float32
    assert _gap(bands32, bands_ref) < 2e-6
    assert _gap(q32, q_ref) < 2e-6
    bands_bf16, _ = _reference(weights, "bf16")
    assert _gap(bands_bf16, bands_ref) > 2e-6


def test_pcg_against_reference():
    """The port's PCG with the B2 form of the wrap (``bands_to_dia``,
    ``make_structured_poly_apply_dia``) on b = A 1 against the plain PCG
    with the reference's factor and apply, float64: the same iterations,
    both within the tolerance, x within 1e-9 of the reference's (the two
    orders of summation differ at 1e-16 an operation; the solve is well
    conditioned), and x near the exact solution 1."""
    a, plan, bands, q, weights = _port_setup(torch.float64, 7)
    b = hpcg_rhs(a)
    c_up, c_low = sf.bands_to_dia(bands, plan.offsets, a.n)
    apply = sf.make_structured_poly_apply_dia(1)
    with torch.no_grad():
        res = preconditioned_conjugate_gradient(
            dia_matvec, a, b, apply, (c_up, c_low, q, a), rtol=1e-8,
            max_iter=1024, check_every=8)
    bands_ref, q_ref = _reference(weights)
    vals, offsets = ref.hpcg_bands(SHAPE, "cpu")
    op = Bands(vals, offsets)
    slots = ref.box_slots(SHAPE, 1)[0]
    x_ref = pcg(op.matvec, lambda r: poly_apply(bands_ref, slots, q_ref,
                                                op.matvec, r), b, 1e-8, 1024)
    assert float(res.residual) < 1e-8
    r = b - op.matvec(x_ref)
    assert float(torch.dot(r, r) / torch.dot(b, b)) < 1e-8
    assert 0 < int(res.iterations) < 64
    assert float((res.x - x_ref).abs().max()) < 1e-9
    assert float((res.x[:a.n] - 1.0).abs().max()) < 1e-3


def test_scaling_bench_runs_hpcg(tmp_path):
    """``bench.scaling`` takes HPCG as a problem of its own: the same
    calls, four techniques, b = A 1 so x* = 1."""
    ckpt = tmp_path / "w14.msgpack"
    from deeppreconditioning_tpu_torch.train.checkpoint import save_checkpoint

    save_checkpoint(ckpt, head_payload(14, 64, 1, 1, 3))
    run = scaling.run_scaling("cpu", shapes=(8,), reps=1, out=None,
                              problem="hpcg", ckpt=ckpt)
    rows = {r["technique"]: r for r in run.rows}
    assert set(rows) == {"vanilla", "jacobi", "fsai", "learned"}
    for row in rows.values():
        assert row["converged"] and row["x_rel_err"] < 1e-3
    assert rows["learned"]["safeguard_fallback"] is False
    assert run.setup_calls[(8, "learned")] >= 2
    with pytest.raises(ValueError):
        scaling.scaling_problem(8, problem="heat")


# -- the 7-point plan and setup, bit for bit as before -------------------

def _plan_digest(plan) -> str:
    h = hashlib.sha256()
    h.update(repr((plan.shape, plan.offsets, plan.a_offsets)).encode())
    h.update(np.ascontiguousarray(plan.delta_idx, np.int64).tobytes())
    for c in plan.disp_classes:
        h.update(np.ascontiguousarray(c, np.int64).tobytes())
    return h.hexdigest()[:16]


# digests of the plans and classical setups the port built before its
# plans followed the operator's stencil (the 7-point star only)
PLAN_DIGESTS = [
    ((6, 5, 4), 2, "6bf5e6719445ceaf"), ((8, 8, 8), 2, "56cf2a82650ef5bf"),
    ((12, 12, 12), 1, "54e59aa192b56398"),
    ((12, 12, 12), 2, "31e549ec318385a6"),
    ((128, 128, 128), 2, "df576ffaca2e3c3e"), ((16, 16), 3, "7088d9e62ec73355"),
    ((5, 6, 7), 2, "cf286e9f9aa4cba0")]
SETUP_DIGESTS = [((6, 5, 4), 2, "9f62df7262836e5b"),
                 ((8, 8, 8), 2, "3bf2d923f0ea74e3"),
                 ((12, 12, 12), 1, "0e56c756f5bc00c1")]


@pytest.mark.parametrize("shape,power,digest", PLAN_DIGESTS)
def test_star_plan_is_unchanged(shape, power, digest):
    plan = sf.build_structured_plan(shape, power)
    assert _plan_digest(plan) == digest
    if len(shape) == 3:
        a = poisson_coeff_dia(shape, rng=np.random.default_rng(0))
        assert sf.build_structured_plan(shape, power,
                                        a_offsets=a.offsets) is plan


@pytest.mark.parametrize("shape,power,digest", SETUP_DIGESTS)
def test_star_setup_is_unchanged(shape, power, digest):
    """Classical FSAI (elementwise arithmetic only, so the same bits on
    any CPU) on a seeded 7-point operator, float64, through the plan
    read from the operator's offsets."""
    a = poisson_coeff_dia(shape, rng=np.random.default_rng(3),
                          dtype=torch.float64)
    plan = sf.build_structured_plan(shape, power, a_offsets=a.offsets)
    bands, q = sf.structured_setup(a, plan)
    assert hashlib.sha256(bands.numpy().tobytes()).hexdigest()[:16] == digest
    assert q.tolist() == [1.0]


def test_plan_span_is_recorded():
    tracing.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        sf.build_structured_plan((9, 9, 9), 1,
                                 a_offsets=hpcg_operator((9, 9, 9)).offsets)
    snap = tracing.snapshot()
    tracing.reset()
    assert snap["spans"]["structured.plan"]["calls"] == 1
