"""Kernel B1 (batched Gauss–Jordan) of the PyTorch port against the JAX
reference: the plain version against ``_masked_gauss_jordan_xla`` (f64,
at one width of every instance) and against the Pallas
``_gj_kernel`` in interpret mode (f32), the kernel's width instances and
the exactness of its identity padding in both dtypes, the CUDA kernel's
float32 and float64 instances against the plain version on a card, the
kernel's argument
checks, the widths of the committed checkpoints, the no-fallback
rule, and gradients: the plain version carries one, the kernel refuses
operands that need one.

JAX is imported inside the tests that use it, so the CUDA test also runs
on a machine without JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_gauss_jordan.py``.
"""

import types
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

from deeppreconditioning_tpu_torch import _backend
from deeppreconditioning_tpu_torch.ops import gauss_jordan
from deeppreconditioning_tpu_torch.ops.gauss_jordan import (
    INSTANCE_WIDTHS,
    MAX_WIDTH,
    check_gauss_jordan_args,
    instance_width,
    masked_gauss_jordan,
    masked_gauss_jordan_torch,
)
from deeppreconditioning_tpu_torch.train.checkpoint import load_checkpoint

REPO = Path(__file__).resolve().parents[1]
WIDTHS = (4, 8, 13, 24, 41, 63)
# Every instance width and the widths just past each, as the kernel
# rounds them up: 1..4 -> 4, 5..8 -> 8, ..., 49..63 -> 64.
CUDA_WIDTHS = (1, 4, 5, 8, 9, 13, 16, 17, 24, 25, 31, 32, 33, 41, 42, 43,
               48, 49, 63)


def _systems(w, n, seed):
    """SPD blocks with a unit diagonal (like Jacobi-scaled FSAI blocks)
    and one-hot right-hand sides."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, w, w))
    a = g @ g.transpose(0, 2, 1) / w + np.eye(w)
    d = 1.0 / np.sqrt(np.einsum("nii->ni", a))
    a = a * d[:, :, None] * d[:, None, :]
    e = np.zeros((n, w))
    e[np.arange(n), rng.integers(0, w, n)] = 1.0
    return a, e


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("w", WIDTHS)
def test_plain_matches_xla_f64(w):
    import jax.numpy as jnp

    from deeppreconditioning_tpu.ops.fsai import _masked_gauss_jordan_xla

    a, e = _systems(w, 64, seed=w)
    ref = _masked_gauss_jordan_xla(jnp.asarray(a), jnp.asarray(e))
    got = masked_gauss_jordan_torch(torch.tensor(a), torch.tensor(e))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(np.einsum("nij,nj->ni", a, got.numpy()), e,
                               atol=1e-10)


@pytest.mark.parametrize("w", [1, 16, 32, 48])
def test_plain_matches_xla_f64_at_every_instance(w):
    """The float64 instance's oracle at the instance widths that
    ``test_plain_matches_xla_f64`` leaves out (with it, one width in each
    instance of 1..63), against the reference's float64 elimination."""
    import jax.numpy as jnp

    from deeppreconditioning_tpu.ops.fsai import _masked_gauss_jordan_xla

    a, e = _systems(w, 16, seed=400 + w)
    ref = _masked_gauss_jordan_xla(jnp.asarray(a), jnp.asarray(e))
    got = masked_gauss_jordan(torch.tensor(a), torch.tensor(e))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("w", WIDTHS)
def test_plain_matches_pallas_interpret_f32(w):
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from deeppreconditioning_tpu.ops.fsai import _gj_kernel

    r = 128
    a, e = _systems(w, r, seed=100 + w)
    a, e = a.astype(np.float32), e.astype(np.float32)
    aug = jnp.concatenate(
        [jnp.transpose(jnp.asarray(a), (1, 2, 0)),
         jnp.transpose(jnp.asarray(e))[:, None, :]],
        axis=1,
    )  # lane-major (w, w+1, r)
    out = pl.pallas_call(
        partial(_gj_kernel, w=w),
        grid=1,
        in_specs=[pl.BlockSpec((w, w + 1, r), lambda i: (0, 0, 0))],
        out_specs=pl.BlockSpec((w, r), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((w, r), jnp.float32),
        interpret=True,
    )(aug)
    got = masked_gauss_jordan(torch.tensor(a), torch.tensor(e))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(out).T, rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("w", [1, 4, 13, 24, 31, 32, 41, 63])
def test_identity_padding_to_the_instance_width_is_exact(w, dtype):
    """The kernel runs width w on instance width W >= w with identity rows
    and a zero right-hand side in slots w..W-1: the plain version on the
    padded systems gives y[:, :w] bit for bit, and zeros past w."""
    big = instance_width(w)
    a, e = _systems(w, 256, seed=300 + w)
    sub = torch.tensor(a, dtype=dtype)
    rhs = torch.tensor(e, dtype=dtype)
    pad_sub = torch.eye(big, dtype=dtype).repeat(256, 1, 1)
    pad_sub[:, :w, :w] = sub
    pad_rhs = torch.zeros((256, big), dtype=dtype)
    pad_rhs[:, :w] = rhs
    want = masked_gauss_jordan_torch(sub, rhs)
    got = masked_gauss_jordan_torch(pad_sub, pad_rhs)
    assert torch.equal(got[:, :w], want)
    assert not got[:, w:].any()


def test_instance_widths_cover_every_width():
    assert INSTANCE_WIDTHS == tuple(sorted(INSTANCE_WIDTHS))
    for w in range(1, MAX_WIDTH + 1):
        big = instance_width(w)
        assert big >= w and big in INSTANCE_WIDTHS
        smaller = [x for x in INSTANCE_WIDTHS if x < big]
        assert not smaller or smaller[-1] < w  # the smallest that fits
    for bad in (0, MAX_WIDTH + 1):
        with pytest.raises(ValueError, match="outside"):
            instance_width(bad)


@pytest.mark.cuda
@pytest.mark.parametrize("w", CUDA_WIDTHS)
def test_cuda_kernel_matches_plain(w, cuda_device):
    a, e = _systems(w, 1024, seed=200 + w)
    sub = torch.tensor(a, dtype=torch.float32, device=cuda_device)
    rhs = torch.tensor(e, dtype=torch.float32, device=cuda_device)
    before = _backend.launch_counts()["gauss_jordan"]
    got = masked_gauss_jordan(sub, rhs)
    torch.cuda.synchronize()
    assert _backend.launch_counts()["gauss_jordan"] == before + 1
    ref = masked_gauss_jordan_torch(sub, rhs)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("w", CUDA_WIDTHS)
def test_cuda_kernel_f64_matches_plain(w, cuda_device):
    """The float64 instance against the float64 plain version, at
    chip_smoke's float64 bar."""
    a, e = _systems(w, 1024, seed=500 + w)
    sub = torch.tensor(a, dtype=torch.float64, device=cuda_device)
    rhs = torch.tensor(e, dtype=torch.float64, device=cuda_device)
    before = _backend.launch_counts()["gauss_jordan"]
    got = masked_gauss_jordan(sub, rhs)
    torch.cuda.synchronize()
    assert _backend.launch_counts()["gauss_jordan"] == before + 1
    assert got.dtype == torch.float64
    ref = masked_gauss_jordan_torch(sub, rhs)
    torch.testing.assert_close(got, ref, rtol=1e-10, atol=1e-12)


def test_plain_version_carries_a_gradient():
    """On the CPU the plain version is differentiable: its gradient with
    respect to the local blocks equals that of a dense solve."""
    a, e = _systems(24, 16, seed=5)
    sub = torch.tensor(a, requires_grad=True)
    ref_sub = torch.tensor(a, requires_grad=True)
    weights = torch.tensor(np.random.default_rng(6).standard_normal((16, 24)))
    y = masked_gauss_jordan(sub, torch.tensor(e))
    assert y.grad_fn is not None
    (y * weights).sum().backward()
    ref = torch.linalg.solve(ref_sub, torch.tensor(e)[..., None])[..., 0]
    (ref * weights).sum().backward()
    torch.testing.assert_close(y, ref, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(sub.grad, ref_sub.grad, rtol=1e-10,
                               atol=1e-12)


@pytest.mark.cuda
def test_cuda_kernel_refuses_operands_that_need_a_gradient(cuda_device):
    """The kernel has no backward, so an operand that needs a gradient is
    refused instead of silently dropping it; without autograd it runs."""
    a, e = _systems(24, 64, seed=7)
    sub = torch.tensor(a, dtype=torch.float32, device=cuda_device,
                       requires_grad=True)
    rhs = torch.tensor(e, dtype=torch.float32, device=cuda_device)
    with pytest.raises(ValueError, match="no backward"):
        masked_gauss_jordan(sub, rhs)
    with torch.no_grad():
        got = masked_gauss_jordan(sub, rhs)
    torch.testing.assert_close(got, masked_gauss_jordan_torch(
        sub.detach(), rhs), rtol=1e-4, atol=1e-6)


def test_committed_checkpoint_widths_fit_the_kernel():
    """Every committed checkpoint that records a static width (the width
    of the local systems its setups hand to B1) is one B1 takes: the
    frame-structure checkpoint's 41 included."""
    widths = {}
    for path in sorted(REPO.glob("assets/checkpoints*/*.msgpack")):
        payload = load_checkpoint(path)
        if "width" in payload:
            widths[path.relative_to(REPO).as_posix()] = int(payload["width"])
    assert len(widths) == 14, widths
    assert widths["assets/checkpoints_frames/best.msgpack"] == 41
    too_wide = {p: w for p, w in widths.items() if not 1 <= w <= MAX_WIDTH}
    assert not too_wide, too_wide


class _OnCard:
    """A CPU tensor that reports ``cuda:0`` as its device, so the argument
    checks run to their end here."""

    def __init__(self, t):
        self._t = t
        self.device = torch.device("cuda", 0)

    def __getattr__(self, name):
        return getattr(self._t, name)


def _args(n=4, w=6, dtype=torch.float32):
    return torch.zeros((n, w, w), dtype=dtype), torch.zeros((n, w),
                                                            dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("w", [1, 31, 32, 41, MAX_WIDTH])
def test_argument_checks_accept(w, dtype):
    sub, e = _args(w=w, dtype=dtype)
    check_gauss_jordan_args(_OnCard(sub), _OnCard(e))


@pytest.mark.parametrize("case, match", [
    ("cpu", "CUDA device"),
    ("mixed_dtype", "one dtype"),
    ("float16", "float32 or float64"),
    ("not_square", "must be"),
    ("rhs_shape", "e must be"),
    ("too_wide", "outside 1..63"),
    ("empty_width", "outside 1..63"),
    ("strided", "contiguous"),
    ("misaligned", "16-byte aligned"),
])
def test_argument_checks_refuse(case, match):
    sub, e = _args()
    if case == "cpu":
        args = (sub, e)
    elif case == "mixed_dtype":
        args = (sub, e.double())
    elif case == "float16":
        args = _args(dtype=torch.float16)
    elif case == "not_square":
        args = (torch.zeros((4, 6, 5)), e)
    elif case == "rhs_shape":
        args = (sub, torch.zeros((4, 5)))
    elif case == "too_wide":
        args = _args(w=MAX_WIDTH + 1)
    elif case == "empty_width":
        args = _args(w=0)
    elif case == "strided":
        args = (torch.zeros((4, 6, 12))[:, :, ::2], e)
    else:
        args = (sub, torch.zeros(4 * 6 + 1)[1:].reshape(4, 6))
    if case != "cpu":
        args = tuple(_OnCard(t) for t in args)
    with pytest.raises(ValueError, match=match):
        check_gauss_jordan_args(*args)


def test_cuda_call_without_library_raises(monkeypatch):
    """A CUDA tensor goes to the kernel or raises: with the library
    unavailable the call fails and the plain version never runs."""
    def unavailable():
        raise RuntimeError("kernel library unavailable")

    def plain_must_not_run(*args):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(_backend, "kernel_library", unavailable)
    monkeypatch.setattr(gauss_jordan, "masked_gauss_jordan_torch",
                        plain_must_not_run)
    on_card = types.SimpleNamespace(device=torch.device("cuda", 0))
    before = _backend.launch_counts()["gauss_jordan"]
    with pytest.raises(RuntimeError, match="unavailable"):
        gauss_jordan.masked_gauss_jordan(on_card, on_card)
    assert _backend.launch_counts()["gauss_jordan"] == before


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_backend, "_library", None)
    monkeypatch.setattr(_backend.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_backend, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _backend.kernel_library()
