"""The port's BSR format and kernel B3's dispatch against the JAX package:
``from_scipy`` / ``from_blocks`` arrays equal to the reference's, the plain
version against ``BSRMatrix.matvec`` (f64) and against the Pallas
``bsr_matmat_pallas`` / ``bsr_matvec_pallas`` in interpret mode (f32), the
wrapper's CPU dispatch and argument checks, why the m > 1
kernel splits its TF32 products in three (an emulation on the CPU), the
CUDA kernel against the plain version on a card, and the no-fallback
rule.

JAX is imported inside the tests that use it, so the CUDA tests also run
on a machine without JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_bsr.py``.
"""

import functools
import types

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from deeppreconditioning_tpu_torch import _backend
from deeppreconditioning_tpu_torch.data.fvm import generate_sludge_case
from deeppreconditioning_tpu_torch.ops import bsr_spmm
from deeppreconditioning_tpu_torch.ops.bsr_spmm import (
    bsr_matmat,
    bsr_matvec,
    check_bsr_args,
)
from deeppreconditioning_tpu_torch.sparse.bsr import BSRMatrix
from deeppreconditioning_tpu_torch.data.fvm import numpy_assembly


@pytest.fixture(autouse=True, scope="module")
def _numpy_fvm_assembly():
    """The port's numpy FVM assembly: the route the reference's counts
    and arrays held here were made on."""
    with numpy_assembly():
        yield


def _fvm():
    return generate_sludge_case(np.random.default_rng(0),
                                mesh_cells=1).matrix.tocsr()


def _random_spd():
    rng = np.random.default_rng(4)
    b = sp.random(100, 100, density=0.05, random_state=rng)
    return (b @ b.T + 10 * sp.eye(100)).tocsr()


def _block_dense(nb=6, per_row=4, bs=16, seed=5):
    """A small block-dense operator built as the roofline builds its
    design point: random block columns per row (repeats included)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(nb), per_row)
    cols = rng.integers(0, nb, size=nb * per_row)
    cols[1] = cols[0]  # a repeated block column in row 0
    blocks = rng.standard_normal((nb * per_row, bs, bs)).astype(np.float32)
    return rows, cols, blocks


OPERATORS = {"fvm": (_fvm, 32), "random_spd": (_random_spd, 16)}


@pytest.mark.parametrize("name", sorted(OPERATORS))
def test_from_scipy_matches_jax(name):
    import jax.numpy as jnp

    from deeppreconditioning_tpu.sparse.bsr import BSRMatrix as JaxBSR

    build, bs = OPERATORS[name]
    a = build()
    ref = JaxBSR.from_scipy(a, block_size=bs, dtype=jnp.float64)
    got = BSRMatrix.from_scipy(a, block_size=bs, dtype=torch.float64)
    assert got.n == ref.n and got.n_pad == ref.n_pad
    assert got.block_cols.dtype == torch.int32
    np.testing.assert_array_equal(got.block_cols.numpy(),
                                  np.asarray(ref.block_cols))
    np.testing.assert_array_equal(got.blocks.numpy(), np.asarray(ref.blocks))
    f32 = BSRMatrix.from_scipy(a, block_size=bs)
    np.testing.assert_array_equal(
        f32.blocks.numpy(),
        np.asarray(JaxBSR.from_scipy(a, block_size=bs).blocks))


def test_from_blocks_matches_jax_from_scipy():
    """The roofline's block-dense operator built straight from its block
    list equals the reference's round trip through CSR."""
    import jax.numpy as jnp

    from deeppreconditioning_tpu.sparse.bsr import BSRMatrix as JaxBSR

    rows, cols, blocks = _block_dense()
    nb, bs = 6, blocks.shape[1]
    a_sp = sp.bsr_matrix(
        (blocks, cols, np.arange(0, rows.shape[0] + 1, 4)),
        shape=(nb * bs, nb * bs),
    ).tocsr()
    ref = JaxBSR.from_scipy(a_sp, block_size=bs, dtype=jnp.float32)
    got = BSRMatrix.from_blocks(rows, cols, blocks, nb)
    np.testing.assert_array_equal(got.block_cols.numpy(),
                                  np.asarray(ref.block_cols))
    np.testing.assert_array_equal(got.blocks.numpy(), np.asarray(ref.blocks))


@pytest.mark.parametrize("name", sorted(OPERATORS))
def test_plain_matvec_matches_jax_f64(name):
    import jax.numpy as jnp

    from deeppreconditioning_tpu.sparse.bsr import BSRMatrix as JaxBSR

    build, bs = OPERATORS[name]
    a = build()
    ours = BSRMatrix.from_scipy(a, block_size=bs, dtype=torch.float64)
    ref = JaxBSR.from_scipy(a, block_size=bs, dtype=jnp.float64)
    x = np.random.default_rng(1).standard_normal(ours.n_pad)
    x[a.shape[0]:] = 0.0
    want = np.asarray(ref.matvec(jnp.asarray(x)))
    got = bsr_matvec(ours, torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got.numpy()[:a.shape[0]], a @ x[:a.shape[0]],
                               rtol=1e-10, atol=1e-12)


@pytest.fixture
def interpret_pallas(monkeypatch):
    import deeppreconditioning_tpu.ops.pallas_bsr as pb

    monkeypatch.setattr(pb.pl, "pallas_call",
                        functools.partial(pb.pl.pallas_call, interpret=True))
    return pb


@pytest.mark.parametrize("m", [None, 8])
def test_plain_matches_pallas_interpret_f32(m, interpret_pallas):
    import jax.numpy as jnp

    from deeppreconditioning_tpu.sparse.bsr import BSRMatrix as JaxBSR

    pb = interpret_pallas
    a = _fvm()
    n = a.shape[0]
    ours = BSRMatrix.from_scipy(a, block_size=32)
    ref = JaxBSR.from_scipy(a, block_size=32, dtype=jnp.float32)
    rng = np.random.default_rng(2)
    shape = (ours.n_pad,) if m is None else (ours.n_pad, m)
    x = np.zeros(shape, np.float32)
    x[:n] = rng.standard_normal((n,) + shape[1:]).astype(np.float32)
    if m is None:
        want = pb.bsr_matvec_pallas(ref, jnp.asarray(x), lanes=8)
        got = bsr_matvec(ours, torch.tensor(x))
    else:
        want = pb.bsr_matmat_pallas(ref, jnp.asarray(x))
        got = bsr_matmat(ours, torch.tensor(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_cpu_dispatch_takes_the_plain_version():
    a = BSRMatrix.from_scipy(_random_spd(), block_size=16)
    x = torch.randn(a.n_pad, generator=torch.Generator().manual_seed(0))
    before = _backend.launch_counts()["bsr_spmm"]
    y = bsr_matvec(a, x)
    y_m = bsr_matmat(a, torch.stack([x, 2 * x], dim=1))
    assert _backend.launch_counts()["bsr_spmm"] == before
    torch.testing.assert_close(y_m[:, 0], y)
    torch.testing.assert_close(y_m[:, 1], 2 * y)
    assert _backend.plain_cuda_counts()["bsr_spmm"] == 0


class _OnCard:
    """A CPU tensor that reports ``cuda:0`` as its device, so the argument
    checks run to their end here."""

    def __init__(self, t):
        self._t = t
        self.device = torch.device("cuda", 0)

    def __getattr__(self, name):
        return getattr(self._t, name)


def _on_card(blocks, cols, x):
    return (BSRMatrix(blocks=_OnCard(blocks), block_cols=_OnCard(cols),
                      n=blocks.shape[0] * blocks.shape[2]), _OnCard(x))


def _args(r=3, s=2, bs=16, m=None):
    x = torch.zeros((r * bs,) if m is None else (r * bs, m))
    return (torch.zeros((r, s, bs, bs)),
            torch.full((r, s), r, dtype=torch.int32), x)


@pytest.mark.parametrize("bs, m, want", [(16, None, 1), (32, 1, 1),
                                          (64, 8, 8), (128, 128, 128)])
def test_argument_checks_accept(bs, m, want):
    assert check_bsr_args(*_on_card(*_args(bs=bs, m=m))) == want


@pytest.mark.parametrize("case, match", [
    ("cpu", "CUDA device"),
    ("float64", "float32 only"),
    ("int64_cols", "int32"),
    ("block_size", "block size"),
    ("not_square", "must be"),
    ("cols_shape", "block_cols must be"),
    ("x_rows", "x must be"),
    ("x_empty", "x must be"),
    ("strided", "contiguous"),
    ("blocks_misaligned", "16-byte aligned"),
    ("x_misaligned", "16-byte aligned"),
])
def test_argument_checks_refuse(case, match):
    blocks, cols, x = _args()
    if case == "float64":
        blocks = blocks.double()
    elif case == "int64_cols":
        cols = cols.long()
    elif case == "block_size":
        blocks, cols, x = _args(bs=8)
    elif case == "not_square":
        blocks = torch.zeros((3, 2, 16, 8))
    elif case == "cols_shape":
        cols = cols[:, :1]
    elif case == "x_rows":
        x = torch.zeros(40)
    elif case == "x_empty":
        x = torch.zeros((48, 0))
    elif case == "strided":
        x = torch.zeros((48, 2))[:, 0]
    elif case == "blocks_misaligned":
        blocks = torch.zeros(3 * 2 * 16 * 16 + 1)[1:].reshape(3, 2, 16, 16)
    elif case == "x_misaligned":
        x = torch.zeros(49)[1:]
    if case == "cpu":
        args = (BSRMatrix(blocks=blocks, block_cols=cols, n=48), x)
    else:
        args = _on_card(blocks, cols, x)
    with pytest.raises(ValueError, match=match):
        check_bsr_args(*args)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _tf32(a):
    """TF32 as the tensor cores read a float32: the 13 low mantissa bits
    masked off."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return (bits & np.uint32(0xffffe000)).view(np.float32)


def _split(a):
    """B3's split: hi = tf32(a), lo = a - hi (exact), read as tf32(lo)."""
    hi = _tf32(a)
    return hi, _tf32(a - hi)


@pytest.mark.parametrize("m", [8, 128])
def test_three_tf32_products_hold_the_kernel_tolerance(m):
    """On a small frame operator, the 3xTF32 products of B3's m > 1 path
    (a_lo b_hi + a_hi b_lo + a_hi b_hi, products exact, as the tensor
    cores form them) stay within B3's tolerance of the float64 product,
    1e-5 max|Y| + 1e-6; single-pass TF32 (a_hi b_hi) does not."""
    from deeppreconditioning_tpu_torch.bench.roofline import frame_operator

    a, _ = frame_operator((4, 4, 3), block_size=32)
    blocks = a.blocks.numpy()
    cols = a.block_cols.numpy()
    r, bs = a.n_block_rows, a.block_size
    x = np.random.default_rng(m).standard_normal((a.n_pad, m)).astype(
        np.float32)
    xb = np.concatenate([x.reshape(r, bs, m), np.zeros((1, bs, m),
                                                       np.float32)])
    gathered = xb[cols]  # (R, S, bs, m); the sentinel's block is zero
    a_hi, a_lo = _split(blocks)
    x_hi, x_lo = _split(gathered)

    def product(p, q):
        return np.einsum("rsij,rsjm->rim", p.astype(np.float64),
                         q.astype(np.float64)).reshape(a.n_pad, m)

    want = product(blocks, gathered)
    tol = 1e-5 * np.abs(want).max() + 1e-6
    three = (product(a_lo, x_hi) + product(a_hi, x_lo)
             + product(a_hi, x_hi)).astype(np.float32)
    single = product(a_hi, x_hi).astype(np.float32)
    assert np.abs(three - want).max() <= tol
    assert np.abs(single - want).max() > tol


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [16, 32, 64, 128])
@pytest.mark.parametrize("m", [None, 1, 2, 3, 8, 40, 128, 130])
def test_cuda_kernel_matches_plain(bs, m, cuda_device):
    a = BSRMatrix.from_scipy(_fvm(), block_size=bs, device=cuda_device)
    rng = np.random.default_rng(bs)
    shape = (a.n_pad,) if m is None else (a.n_pad, m)
    x = torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                     device=cuda_device)
    before = _backend.launch_counts()["bsr_spmm"]
    got = bsr_matvec(a, x) if m is None else bsr_matmat(a, x)
    torch.cuda.synchronize()
    assert _backend.launch_counts()["bsr_spmm"] == before + 1
    ref = a.matvec(x) if m is None else a.matmat(x)
    bound = 1e-5 * float(ref.abs().max()) + 1e-6
    assert float((got - ref).abs().max()) <= bound


def test_cuda_call_without_library_raises(monkeypatch):
    """A CUDA tensor goes to the kernel or raises: with the library
    unavailable the call fails and the plain version never runs."""
    def unavailable():
        raise RuntimeError("kernel library unavailable")

    def plain_must_not_run(*args):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(_backend, "kernel_library", unavailable)
    monkeypatch.setattr(BSRMatrix, "matmat", plain_must_not_run)
    monkeypatch.setattr(BSRMatrix, "matvec", plain_must_not_run)
    on_card = types.SimpleNamespace(device=torch.device("cuda", 0))
    a = BSRMatrix(blocks=on_card, block_cols=on_card, n=1)
    before = _backend.launch_counts()["bsr_spmm"]
    for call in (bsr_spmm.bsr_matvec, bsr_spmm.bsr_matmat):
        with pytest.raises(RuntimeError, match="unavailable"):
            call(a, on_card)
    assert _backend.launch_counts()["bsr_spmm"] == before
