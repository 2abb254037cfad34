"""The port's DIA container and kernel B2 against the JAX package: the
container in f64 (``poisson_dia``, ``from_scipy``, ``to_scipy``,
``to_dense``, ``matvec``), the plain version against the Pallas
``_dia_kernel`` in interpret mode (f32), the CUDA kernel against the
plain version on a card, and the no-fallback rule.

JAX is imported inside the tests that use it, so the CUDA test also runs
on a machine without JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_dia.py``.
"""

import functools
import types

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from deeppreconditioning_tpu_torch import _backend
from deeppreconditioning_tpu_torch.ops import dia_spmv
from deeppreconditioning_tpu_torch.ops.dia_spmv import dia_matvec
from deeppreconditioning_tpu_torch.ops.structured_fsai import (
    bands_to_dia,
    build_structured_plan,
    structured_setup,
)
from deeppreconditioning_tpu_torch.data.poisson import poisson_coeff_dia
from deeppreconditioning_tpu_torch.sparse.dia import DIAMatrix, poisson_dia

SHAPES = [(16, 16), (6, 5, 4), (12, 12, 12)]


def _poisson_2d_scipy(nx):
    ident = sp.eye(nx)
    t = sp.diags(
        [-np.ones(nx - 1), 2.0 * np.ones(nx), -np.ones(nx - 1)], [-1, 0, 1]
    )
    return (sp.kron(ident, t) + sp.kron(t, ident)).tocsr()


def _factor_halves(shape, dtype, device=None):
    """(C^T, C) of a structured FSAI factor: 13 positive and 13 negative
    offsets on a 3-D grid."""
    a = poisson_coeff_dia(shape, rng=np.random.default_rng(3), dtype=dtype,
                          device=device)
    plan = build_structured_plan(shape, power=2)
    bands, _ = structured_setup(a, plan)
    return bands_to_dia(bands, plan.offsets, a.n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("shape", SHAPES)
def test_poisson_dia_matches_jax(shape):
    import jax.numpy as jnp

    from deeppreconditioning_tpu.sparse import dia as jax_dia

    ref = jax_dia.poisson_dia(shape, dtype=jnp.float64)
    got = poisson_dia(shape, dtype=torch.float64)
    assert got.offsets == ref.offsets and got.n == ref.n
    assert got.n_pad == ref.n_pad and got.halo == ref.halo
    np.testing.assert_array_equal(got.vals.numpy(), np.asarray(ref.vals))
    np.testing.assert_allclose(got.to_dense().numpy(),
                               np.asarray(ref.to_dense()), rtol=1e-12)
    diff = got.to_scipy() - ref.to_scipy()
    assert diff.nnz == 0 or abs(diff).max() == 0.0

    x = np.random.default_rng(0).standard_normal(got.n_pad)
    np.testing.assert_allclose(
        got.matvec(torch.tensor(x)).numpy(),
        np.asarray(ref.matvec(jnp.asarray(x))), rtol=1e-12, atol=1e-12)


def test_from_scipy_matches_jax():
    import jax.numpy as jnp

    from deeppreconditioning_tpu.sparse import dia as jax_dia

    m = _poisson_2d_scipy(12)
    ref = jax_dia.DIAMatrix.from_scipy(m, dtype=jnp.float64)
    got = DIAMatrix.from_scipy(m, dtype=torch.float64)
    assert got.offsets == ref.offsets and got.n_pad == ref.n_pad
    np.testing.assert_array_equal(got.vals.numpy(), np.asarray(ref.vals))
    x = np.zeros(got.n_pad)
    x[:m.shape[0]] = np.random.default_rng(1).standard_normal(m.shape[0])
    y = got.matvec(torch.tensor(x)).numpy()
    np.testing.assert_allclose(y[:m.shape[0]], m @ x[:m.shape[0]],
                               rtol=1e-12)
    np.testing.assert_allclose(y, np.asarray(ref.matvec(jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12)


def _pallas_interpret(a_jax, x):
    """``dia_matvec_pallas`` with pallas_call in interpret mode, as
    tests/test_dia.py runs it."""
    import jax.numpy as jnp

    import deeppreconditioning_tpu.ops.pallas_spmv as ps

    orig = ps.pl.pallas_call
    ps.pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        return np.asarray(ps.dia_matvec_pallas(a_jax,
                                               jnp.asarray(x, jnp.float32)))
    finally:
        ps.pl.pallas_call = orig


@pytest.mark.parametrize("operator", ["poisson", "c_up", "c_low"])
def test_plain_matches_pallas_interpret_f32(operator):
    import jax.numpy as jnp

    from deeppreconditioning_tpu.sparse.dia import DIAMatrix as JaxDIA

    shape = (12, 12, 12)
    if operator == "poisson":
        a = poisson_dia(shape)
    else:
        a = dict(zip(("c_up", "c_low"),
                     _factor_halves(shape, torch.float32)))[operator]
    a_jax = JaxDIA(vals=jnp.asarray(a.vals.numpy()), offsets=a.offsets,
                   n=a.n)
    x = np.random.default_rng(2).standard_normal(a.n_pad).astype(np.float32)
    want = _pallas_interpret(a_jax, x)
    got = dia_matvec(a, torch.tensor(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("operator", ["poisson_2d", "poisson_3d", "c_up",
                                      "c_low"])
def test_cuda_kernel_matches_plain(operator, cuda_device):
    if operator == "poisson_2d":
        a = poisson_dia((64, 48), device=cuda_device)
    elif operator == "poisson_3d":
        a = poisson_coeff_dia((24, 20, 16), rng=np.random.default_rng(4),
                              device=cuda_device)
    else:
        a = dict(zip(("c_up", "c_low"), _factor_halves(
            (16, 16, 16), torch.float32, cuda_device)))[operator]
    x = torch.tensor(np.random.default_rng(5).standard_normal(a.n_pad),
                     dtype=torch.float32, device=cuda_device)
    before = _backend.launch_counts()["dia_spmv"]
    got = dia_matvec(a, x)
    torch.cuda.synchronize()
    assert _backend.launch_counts()["dia_spmv"] == before + 1
    ref = a.matvec(x)
    assert bool(torch.isfinite(got).all())
    assert bool(((got - ref).abs() <= 1e-6 + 1e-5 * ref.abs()).all())


@pytest.mark.cuda
def test_cuda_batched_kernel_and_backward_match_plain(cuda_device):
    """Batched B2 (32 samples in one launch) and its autograd backward
    (B2 on A^T) against the plain product and its autograd on the card;
    values that need a gradient are refused."""
    rng = np.random.default_rng(8)
    a = poisson_coeff_dia((12, 12, 12), rng=rng, device=cuda_device)
    vals = torch.stack([a.vals * float(s) for s in rng.uniform(0.5, 2, 32)])
    vals[:, 1] += 0.25  # unsymmetric
    a = DIAMatrix(vals=vals, offsets=a.offsets, n=a.n)
    x = torch.tensor(rng.standard_normal((32, a.n_pad)), dtype=torch.float32,
                     device=cuda_device)
    g = torch.randn_like(x)
    before = _backend.launch_counts()["dia_spmv"]
    got = dia_matvec(a, x)
    torch.cuda.synchronize()
    assert _backend.launch_counts()["dia_spmv"] == before + 1
    assert torch.equal(got, a.matvec(x))
    xr = x.clone().requires_grad_(True)
    dia_matvec(a, xr).backward(g)
    assert _backend.launch_counts()["dia_spmv"] == before + 3
    xp = x.clone().requires_grad_(True)
    a.matvec(xp).backward(g)
    # A^T's bands sum in another order than autograd's pad-backward adds
    scale = float(xp.grad.abs().max())
    assert float((xr.grad - xp.grad).abs().max()) <= 1e-5 * scale
    needs = DIAMatrix(vals=vals.clone().requires_grad_(True),
                      offsets=a.offsets, n=a.n)
    with pytest.raises(ValueError, match="gradient"):
        dia_matvec(needs, x)


def test_cuda_call_without_library_raises(monkeypatch):
    """A CUDA tensor goes to the kernel or raises: with the library
    unavailable the call fails and the plain version never runs."""
    def unavailable():
        raise RuntimeError("kernel library unavailable")

    def plain_must_not_run(*args):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(_backend, "kernel_library", unavailable)
    on_card = types.SimpleNamespace(device=torch.device("cuda", 0))
    a = types.SimpleNamespace(matvec=plain_must_not_run)
    before = _backend.launch_counts()["dia_spmv"]
    with pytest.raises(RuntimeError, match="unavailable"):
        dia_spmv.dia_matvec(a, on_card)
    assert _backend.launch_counts()["dia_spmv"] == before


def test_plain_on_cpu_counts_nothing():
    """The plain-on-CUDA counter stays 0 for CPU tensors."""
    before = _backend.plain_cuda_counts()["dia_spmv"]
    a = poisson_dia((8, 8), dtype=torch.float64)
    dia_matvec(a, torch.ones(a.n_pad, dtype=torch.float64))
    assert _backend.plain_cuda_counts()["dia_spmv"] == before
