"""The polynomial wraps at both precisions, their group form, the deployed
NeuralFSAI setup at both precisions and the reference's other FSAI forms
(``fsai_values_range``, the one-hot ``range_dense_factor``, the float64
host ``fsai_factor_scipy``) against the JAX package's, in float64 on the
same numpy inputs.  Under x64 the ``"bf16"`` branch is bf16 inputs with
exact float64 products on both sides, so M agrees to 1e-12 of max |M|;
the model forward (local solves on either side) to 1e-9."""

from pathlib import Path

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from deeppreconditioning_tpu.models.neural_fsai import (
    NeuralFSAI as JaxNeuralFSAI,
    neural_fsai_dense_preconditioner as jax_dense_m,
)
from deeppreconditioning_tpu.ops import fsai as jax_fsai
from deeppreconditioning_tpu_torch.data.datasets import _prepare_sample
from deeppreconditioning_tpu_torch.data.fvm import generate_sludge_case
from deeppreconditioning_tpu_torch.models.neural_fsai import (
    neural_fsai_dense_preconditioner,
    neural_fsai_from_checkpoint,
)
from deeppreconditioning_tpu_torch.ops import fsai
from deeppreconditioning_tpu_torch.train.checkpoint import load_checkpoint
from deeppreconditioning_tpu_torch.data.fvm import numpy_assembly


@pytest.fixture(autouse=True, scope="module")
def _numpy_fvm_assembly():
    """The port's numpy FVM assembly: the route the reference's counts
    and arrays held here were made on."""
    with numpy_assembly():
        yield


ASSETS = Path(__file__).resolve().parents[1] / "assets"
N_PAD = 256
RTOL = 1e-12
PRECISIONS = [None, "bf16"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the parallel test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(seed):
    """Dense scaled A~, scales, n0, the range plans (port, JAX) and the
    case's sparse raw system."""
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
    return a, h.scale, h.original_size, plan.to("cpu"), ref, (pr, pc)


def _generic_case(seed=0):
    """The sludge case on the generic plan (power 4, w 24; any pattern
    takes it): scaled tril values, scales, n0 and the plans (port on the
    CPU, JAX)."""
    case = generate_sludge_case(np.random.default_rng(seed), mesh_cells=1)
    m = case.matrix
    h = _prepare_sample(m.row, m.col, m.data, case.solution, case.rhs,
                        N_PAD)
    pr, pc = fsai.tril_power_pattern(h.rows, h.cols, N_PAD, power=4)
    args = (h.rows, h.cols, pr, pc, N_PAD)
    return (h.vals, h.scale, h.original_size,
            fsai.build_fsai_plan(*args, width=24).to("cpu"),
            jax_fsai.build_fsai_plan(*args, width=24))


def _models(checkpoint):
    """The JAX model and parameters and the port's model (float64)."""
    payload = flax.serialization.msgpack_restore(checkpoint.read_bytes())
    jax_model = JaxNeuralFSAI(width=int(payload["width"]),
                              hidden=int(payload["hidden"]),
                              poly_degree=int(payload["poly_degree"]))
    model = neural_fsai_from_checkpoint(load_checkpoint(checkpoint))
    return jax_model, payload["params"], model.double()


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _dense_inputs(seed):
    """C~ (the JAX dense factor), A~, q of degree 2, D^-1/2, n0."""
    a, scale, n0, _, ref, _ = _case(seed)
    c = jax_fsai.range_dense_factor(ref, jax_fsai.range_fsai_columns(
        ref, jnp.asarray(a)))
    q = np.random.default_rng(seed).uniform(-0.5, 1.5, 3)
    return np.asarray(c), a, q, 1.0 / np.sqrt(scale), n0


def _gram_inputs(seed):
    """S_eff (the JAX range Gram), the raw dense A, q of degree 2."""
    a, scale, n0, _, ref, _ = _case(seed)
    s = jax_fsai.fsai_dense_preconditioner_range(
        ref, jnp.asarray(a), d_isqrt=jnp.asarray(1.0 / np.sqrt(scale)),
        n0=n0, dtype=jnp.float64)
    d_sqrt = np.sqrt(scale)
    q = np.random.default_rng(seed).uniform(-0.5, 1.5, 3)
    return np.asarray(s), d_sqrt[:, None] * a * d_sqrt[None, :], q


def _t(*xs):
    return [torch.tensor(np.asarray(x)) for x in xs]


@pytest.mark.parametrize("precision", PRECISIONS)
def test_poly_preconditioner_dense_matches_jax(precision):
    c, a, q, d_isqrt, n0 = _dense_inputs(0)
    want = jax_fsai.poly_preconditioner_dense(
        jnp.asarray(c), jnp.asarray(a), jnp.asarray(q),
        d_isqrt=jnp.asarray(d_isqrt), n0=jnp.int32(n0), precision=precision)
    got = fsai.poly_preconditioner_dense(*_t(c, a, q),
                                         d_isqrt=torch.tensor(d_isqrt),
                                         n0=n0, precision=precision)
    _close(got, want)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_poly_preconditioner_dense_group_matches_jax(precision):
    """Three cases, each with its own q and n0, in one call."""
    c, a, q, d_isqrt, n0 = (np.stack(x) for x in zip(
        *(_dense_inputs(seed) for seed in (0, 1, 2))))
    assert len({tuple(x) for x in q}) == 3
    want = jax.vmap(lambda *xs: jax_fsai.poly_preconditioner_dense(
        *xs, precision=precision))(*(jnp.asarray(x)
                                     for x in (c, a, q, d_isqrt, n0)))
    got = fsai.poly_preconditioner_dense(*_t(c, a, q),
                                         d_isqrt=torch.tensor(d_isqrt),
                                         n0=torch.tensor(n0),
                                         precision=precision)
    _close(got, want)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_poly_preconditioner_from_gram_matches_jax(precision):
    s, a_raw, q = _gram_inputs(1)
    want = jax_fsai.poly_preconditioner_from_gram(
        jnp.asarray(s), jnp.asarray(a_raw), jnp.asarray(q),
        precision=precision)
    got = fsai.poly_preconditioner_from_gram(*_t(s, a_raw, q),
                                             precision=precision)
    _close(got, want)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_poly_preconditioner_from_gram_group_matches_jax(precision):
    """Three cases, each with its own q (and so its own r = q * q)."""
    s, a_raw, q = (np.stack(x) for x in zip(
        *(_gram_inputs(seed) for seed in (0, 1, 2))))
    want = jax.vmap(lambda *xs: jax_fsai.poly_preconditioner_from_gram(
        *xs, precision=precision))(*(jnp.asarray(x) for x in (s, a_raw, q)))
    got = fsai.poly_preconditioner_from_gram(*_t(s, a_raw, q),
                                             precision=precision)
    _close(got, want)
    one = fsai.poly_preconditioner_from_gram(*_t(s[2], a_raw[2], q[2]),
                                             precision=precision)
    np.testing.assert_allclose(got[2].numpy(), one.numpy(), rtol=0,
                               atol=RTOL * one.abs().max().item())


def test_bf16_wrap_differs_from_the_full_one():
    """The bf16 branch is a different M (the retry rebuilds it): ~1e-3 off
    the full-precision one, not equal."""
    s, a_raw, q = _t(*_gram_inputs(0))
    full = fsai.poly_preconditioner_from_gram(s, a_raw, q)
    half = fsai.poly_preconditioner_from_gram(s, a_raw, q, precision="bf16")
    rel = ((half - full).abs().max() / full.abs().max()).item()
    assert 1e-5 < rel < 3e-2
    with pytest.raises(ValueError, match="precision"):
        fsai.poly_preconditioner_from_gram(s, a_raw, q, precision="tf32")


def test_fsai_values_range_matches_jax():
    a, _, _, plan, ref, _ = _case(2)
    got = fsai.fsai_values_range(plan, torch.tensor(a))
    _close(got, jax_fsai.fsai_values_range(ref, jnp.asarray(a)), rtol=1e-10)


@pytest.mark.parametrize("fold", [False, True])
def test_range_dense_factor_matches_jax(fold):
    a, scale, n0, plan, ref, _ = _case(1)
    c = jax_fsai.range_fsai_columns(ref, jnp.asarray(a))
    kwargs = ({"d_isqrt": 1.0 / np.sqrt(scale), "n0": n0} if fold else {})
    want = jax_fsai.range_dense_factor(
        ref, c, **{k: jnp.asarray(v) for k, v in kwargs.items()})
    got = fsai.range_dense_factor(
        plan, torch.tensor(np.asarray(c)),
        **{k: torch.tensor(v) for k, v in kwargs.items()})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if not fold:  # the one-hot placement is the slab scatter's C
        slabs = fsai.range_dense_factor_slabs(plan,
                                              torch.tensor(np.asarray(c)))
        np.testing.assert_array_equal(got.numpy(), slabs.numpy())


def test_fsai_factor_scipy_matches_jax():
    a, _, n0, _, _, (pr, pc) = _case(0)
    live = (pr < n0) & (pc < n0)
    a_sp = sp.csr_matrix(a[:n0, :n0])
    got = fsai.fsai_factor_scipy(a_sp, pr[live], pc[live])
    want = jax_fsai.fsai_factor_scipy(a_sp, pr[live], pc[live])
    assert (got != want).nnz == 0
    # C^T A C has a unit diagonal (the Kaporin normalization)
    np.testing.assert_allclose((got.T @ a_sp @ got).diagonal(), 1.0,
                               rtol=1e-12)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_neural_fsai_dense_preconditioner_range_matches_jax(precision):
    a, scale, n0, plan, ref, _ = _case(0)
    jax_model, params, model = _models(
        ASSETS / "checkpoints_fsai" / "best.msgpack")
    want = jax_dense_m(jax_model, params, ref, jnp.asarray(a),
                       jnp.asarray(scale), n0, dtype=jnp.float64,
                       precision=precision)
    with torch.no_grad():
        got = neural_fsai_dense_preconditioner(
            model, plan, torch.tensor(a), torch.tensor(scale), n0,
            dtype=torch.float64, precision=precision)
    _close(got, want, rtol=1e-9)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_neural_fsai_dense_preconditioner_generic_matches_jax(precision):
    vals, scale, n0, plan, ref = _generic_case()
    jax_model, params, model = _models(
        ASSETS / "checkpoints_fsai" / "best.msgpack")
    want = jax_dense_m(jax_model, params, ref, jnp.asarray(vals),
                       jnp.asarray(scale), n0, dtype=jnp.float64,
                       precision=precision)
    with torch.no_grad():
        got = neural_fsai_dense_preconditioner(
            model, plan, torch.tensor(vals), torch.tensor(scale), n0,
            dtype=torch.float64, precision=precision)
    _close(got, want, rtol=1e-9)
