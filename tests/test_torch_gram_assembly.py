"""The Gram slabs' assembly (``ops/gram_assembly.py``): the plain version
against an independent slab loop and, inside ``range_m_from_strips``,
against the JAX reference; the kernel's argument checks, bytes and
bound; the per-case range plan's route through it; and on a card the
kernel (``csrc/gram_assembly.cu``) against the plain version bit for bit
(the sludge plans' windows, H 256, n_pad 256, unaligned starts), its
determinism, its launch counts, a CUDA graph's replay on new starts, and
its refusals.

JAX is imported inside the test that uses it, so the card tests also run
on a machine without JAX:
``python -m pytest --noconftest -q -m cuda tests/test_torch_gram_assembly.py``.
"""

import functools
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from deeppreconditioning_tpu_torch import _backend
from deeppreconditioning_tpu_torch.data.datasets import _prepare_sample
from deeppreconditioning_tpu_torch.data.fvm import (
    generate_sludge_case,
    numpy_assembly,
)
from deeppreconditioning_tpu_torch.ops import fsai, gram_assembly
from deeppreconditioning_tpu_torch.ops.gram_assembly import (
    check_gram_assembly_args,
    gram_assembly_torch,
)
from deeppreconditioning_tpu_torch.utils.profiling import (
    card_peaks,
    gram_assembly_work,
)

REPO = Path(__file__).resolve().parents[1]


def _sludge_lo(seed, n_pad, mesh_cells, range_h):
    """(window starts, H) of a sludge case's per-case range plan (power
    4, w 24), as the per-case cell builds it."""
    with numpy_assembly():
        case = generate_sludge_case(np.random.default_rng(seed),
                                    mesh_cells=mesh_cells)
    m = case.matrix
    h = _prepare_sample(m.row, m.col, m.data, case.solution, case.rhs,
                        n_pad)
    pr, pc = fsai.tril_power_pattern(h.rows, h.cols, n_pad, power=4)
    plan = fsai.build_range_fsai_plan(pr, pc, n_pad, width=24,
                                      range_h=range_h)
    return np.asarray(plan.lo, np.int64), plan.h


SHAPES = ("per_case", "h256", "n_pad256", "unaligned", "one_start")


@functools.cache
def _shape(name):
    """(window starts, H, n_pad) of the shape ``name``."""
    if name == "per_case":
        return (*_sludge_lo(2200000001, 1024, 2, 128), 1024)
    if name == "h256":
        return (*_sludge_lo(2200000002, 1024, 2, 256), 1024)
    if name == "n_pad256":
        return (*_sludge_lo(0, 256, 1, 128), 256)
    if name == "unaligned":
        # starts off a multiple of 4 and a height that is not one: the
        # kernel's guarded loads
        rng = np.random.default_rng(7)
        return np.sort(rng.integers(0, 512 - 126 + 1, 60)), 126, 512
    return np.full(9, 3, np.int64), 64, 128  # every window the same


def _slabs(name, dtype, seed=0):
    lo, h, n_pad = _shape(name)
    g = np.random.default_rng(seed).standard_normal((len(lo), h, h))
    return g.astype(dtype), lo, n_pad


def _slab_loop(g, lo, n_pad):
    """An independent numpy loop: each slab added in ascending order."""
    m = np.zeros((n_pad, n_pad), g.dtype)
    h = g.shape[-1]
    for b, start in enumerate(lo):
        m[start:start + h, start:start + h] += g[b]
    return m


def test_the_sludge_plans_clip_their_tail_windows():
    """The per-case shapes the kernel serves: B 128 windows of H 128
    starting at 8 b, clipped at n_pad - H = 896 (16 tail blocks there), so
    up to 31 windows cover one entry (the 16 at 896 and the 15 from 776 to
    888 on the tail's first rows)."""
    lo, h, n_pad = _shape("per_case")
    assert (len(lo), h, n_pad) == (128, 128, 1024)
    np.testing.assert_array_equal(lo, np.minimum(8 * np.arange(128), 896))
    assert (lo == 896).sum() == 16
    cover = (lo[:, None] <= np.arange(n_pad)) & (
        np.arange(n_pad) < lo[:, None] + h)
    assert cover.sum(0).max() == 31
    lo, h, n_pad = _shape("h256")
    assert (h, lo.max()) == (256, 768)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", SHAPES)
def test_plain_matches_slab_loop(name, dtype):
    g, lo, n_pad = _slabs(name, dtype)
    got = gram_assembly.gram_assembly(torch.tensor(g), torch.tensor(lo),
                                      n_pad)
    assert got.dtype == torch.tensor(g).dtype
    np.testing.assert_array_equal(got.numpy(), _slab_loop(g, lo, n_pad))


def test_plain_refuses_a_start_past_the_end():
    g, lo, n_pad = _slabs("n_pad256", np.float64)
    lo = lo.copy()
    lo[-1] = n_pad - g.shape[-1] + 1
    with pytest.raises(ValueError, match="outside"):
        gram_assembly.gram_assembly(torch.tensor(g), torch.tensor(lo),
                                    n_pad)
    lo[-1] = -1
    with pytest.raises(ValueError, match="outside"):
        gram_assembly.gram_assembly(torch.tensor(g), torch.tensor(lo),
                                    n_pad)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_range_m_from_strips_matches_jax(seed):
    """The per-case Gram assembly inside ``range_m_from_strips``, in
    float64, against the JAX reference's loop of slab adds on
    ``tests/test_torch_fsai.py``'s cases."""
    import jax.numpy as jnp

    from deeppreconditioning_tpu.ops import fsai as jax_fsai
    from test_torch_fsai import _case

    with numpy_assembly():
        a, scale, n0, plan, ref = _case(seed)
    assert plan.lo_static is None
    c_ref = jax_fsai.range_fsai_columns(ref, jnp.asarray(a))
    strips = fsai.range_strips(plan, torch.tensor(np.asarray(c_ref)))
    d_isqrt = 1.0 / np.sqrt(scale)
    got = fsai.range_m_from_strips(plan, strips, torch.tensor(d_isqrt), n0)
    want = np.asarray(jax_fsai.range_m_from_strips(
        ref, jax_fsai.range_strips(ref, c_ref), jnp.asarray(d_isqrt), n0))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    assert not got[n0:].any() and not got[:, n0:].any()


def test_range_m_from_strips_routes_a_case_plan_through_the_assembly(
        monkeypatch):
    """A per-case plan assembles through ``gram_assembly`` (once, with
    the plan's starts); a plan with static starts adds its slabs itself."""
    calls = []

    def spy(g, lo, n_pad):
        calls.append((tuple(g.shape), lo, n_pad))
        return gram_assembly_torch(g, lo, n_pad)

    monkeypatch.setattr(fsai, "gram_assembly", spy)
    lo, h, n_pad = _shape("n_pad256")
    for static_lo in (False, True):
        with numpy_assembly():
            case = generate_sludge_case(np.random.default_rng(0),
                                        mesh_cells=1)
        m = case.matrix
        s = _prepare_sample(m.row, m.col, m.data, case.solution, case.rhs,
                            n_pad)
        pr, pc = fsai.tril_power_pattern(s.rows, s.cols, n_pad, power=4)
        plan = fsai.build_range_fsai_plan(
            pr, pc, n_pad, width=24, range_h=128,
            static_lo=static_lo).to("cpu")
        strips = torch.ones(n_pad // 8, 8, h, dtype=torch.float64)
        fsai.range_m_from_strips(plan, strips,
                                 torch.ones(n_pad, dtype=torch.float64),
                                 s.original_size)
    assert len(calls) == 1
    shape, starts, size = calls[0]
    assert (shape, size) == ((n_pad // 8, h, h), n_pad)
    np.testing.assert_array_equal(starts.numpy(), lo)


class _OnCard:
    """A CPU tensor that reports ``cuda:0`` as its device, so the argument
    checks run to their end here."""

    def __init__(self, t):
        self._t = t
        self.device = torch.device("cuda", 0)

    def __getattr__(self, name):
        return getattr(self._t, name)


def _args(b=4, h=8, n_pad=32, dtype=torch.float32):
    return (torch.zeros((b, h, h), dtype=dtype),
            torch.zeros(b, dtype=torch.int64), n_pad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b, h, n_pad", [(128, 128, 1024), (1, 4, 4),
                                         (3, 126, 512)])
def test_argument_checks_accept(b, h, n_pad, dtype):
    g, lo, _ = _args(b, h, n_pad, dtype)
    check_gram_assembly_args(_OnCard(g), _OnCard(lo), n_pad)


@pytest.mark.parametrize("case, match", [
    ("cpu", "CUDA device"),
    ("float16", "float32 or float64"),
    ("lo_int32", "int64"),
    ("not_square", "must be"),
    ("lo_shape", "lo must be"),
    ("lo_2d", "lo must be"),
    ("taller_than_m", "1 <= H"),
    ("n_pad", "multiple of 4"),
    ("strided", "contiguous"),
    ("misaligned", "16-byte aligned"),
])
def test_argument_checks_refuse(case, match):
    g, lo, n_pad = _args()
    if case == "float16":
        g = g.half()
    elif case == "lo_int32":
        lo = lo.int()
    elif case == "not_square":
        g = torch.zeros((4, 8, 6))
    elif case == "lo_shape":
        lo = torch.zeros(5, dtype=torch.int64)
    elif case == "lo_2d":
        lo = torch.zeros((4, 1), dtype=torch.int64)
    elif case == "taller_than_m":
        g, lo, _ = _args(h=36)
    elif case == "n_pad":
        n_pad = 30
    elif case == "strided":
        g = torch.zeros((4, 8, 16))[:, :, ::2]
    elif case == "misaligned":
        g = torch.zeros(4 * 64 + 1)[1:].reshape(4, 8, 8)
    args = (g, lo) if case == "cpu" else (_OnCard(g), _OnCard(lo))
    with pytest.raises(ValueError, match=match):
        check_gram_assembly_args(*args, n_pad)


def test_cuda_call_without_library_raises(monkeypatch):
    """A CUDA tensor goes to the kernel or raises: with the library
    unavailable the call fails and the plain version never runs."""
    def unavailable():
        raise RuntimeError("kernel library unavailable")

    def plain_must_not_run(*args):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(_backend, "kernel_library", unavailable)
    monkeypatch.setattr(gram_assembly, "gram_assembly_torch",
                        plain_must_not_run)
    on_card = types.SimpleNamespace(device=torch.device("cuda", 0))
    before = _backend.launch_counts()["gram_assembly"]
    with pytest.raises(RuntimeError, match="unavailable"):
        gram_assembly.gram_assembly(on_card, on_card, 1024)
    assert _backend.launch_counts()["gram_assembly"] == before


def test_gram_assembly_work_and_bound():
    """The per-case call reads 128 slabs of 128^2 float32 and 128 int64
    starts and writes a 1024^2 M: 12 583 936 bytes, 3.756 us at 3350
    GB/s; its 2 097 152 adds are nothing beside that."""
    work = gram_assembly_work(128, 128, 1024)
    assert (work.bytes, work.flops) == (12583936, 2097152)
    peaks = card_peaks("NVIDIA H100 80GB HBM3")
    seconds, roof = work.bound(peaks.hbm_gb_s, peaks.fp32_tflop_s)
    assert roof == "bytes"
    assert seconds * 1e6 == pytest.approx(3.7564, abs=1e-4)
    assert gram_assembly_work(128, 128, 1024, itemsize=8).bytes == (
        2 * 12583936 - 1024)


# -- on the card -----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _on(device, name, dtype, seed=0):
    g, lo, n_pad = _slabs(name, dtype, seed)
    return (torch.tensor(g, device=device), torch.tensor(lo, device=device),
            n_pad)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", SHAPES)
def test_cuda_kernel_matches_plain_bit_for_bit(name, dtype, cuda_device):
    """The kernel adds in the plain version's order: the same bits, on
    every entry (zeros off the windows included); a second launch gives
    them again; one launch a call, of the input's dtype, and no plain
    call on the card but the comparison's."""
    g, lo, n_pad = _on(cuda_device, name, dtype)
    _backend.reset_launch_counts()
    got = gram_assembly.gram_assembly(g, lo, n_pad)
    again = gram_assembly.gram_assembly(g, lo, n_pad)
    torch.cuda.synchronize()
    assert _backend.launch_counts()["gram_assembly"] == 2
    assert _backend.dtype_launch_counts()[
        ("gram_assembly", str(g.dtype).removeprefix("torch."))] == 2
    assert _backend.plain_cuda_counts()["gram_assembly"] == 0
    assert got.dtype == g.dtype and got.shape == (n_pad, n_pad)
    assert torch.equal(got, again)
    want = gram_assembly_torch(g, lo, n_pad)
    assert _backend.plain_cuda_counts()["gram_assembly"] == 1
    assert torch.equal(got, want)
    np.testing.assert_array_equal(
        got.cpu().numpy(), _slab_loop(g.cpu().numpy(), lo.cpu().numpy(),
                                      n_pad))


@pytest.mark.cuda
@torch.no_grad()
def test_cuda_graph_replays_the_kernel_on_new_starts(cuda_device):
    """Captured once, a replay reads the starts and slabs in its static
    buffers, so new values give their own M, bit for bit the plain
    version's; the capture launched nothing."""
    g, lo, n_pad = _on(cuda_device, "per_case", np.float32)
    _backend.reset_launch_counts()
    gram_assembly.gram_assembly(g, lo, n_pad)  # warm
    stream = torch.cuda.Stream(cuda_device)
    stream.wait_stream(torch.cuda.current_stream(cuda_device))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        graph.capture_begin()
        m = gram_assembly.gram_assembly(g, lo, n_pad)
        graph.capture_end()
    torch.cuda.current_stream(cuda_device).wait_stream(stream)
    for name, seed in (("per_case", 1), ("per_case", 2)):
        new_g, new_lo, _ = _on(cuda_device, name, np.float32, seed)
        new_lo = torch.flip(new_lo, (0,)) if seed == 2 else new_lo
        g.copy_(new_g)
        lo.copy_(new_lo)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(m, gram_assembly_torch(new_g, new_lo, n_pad))


@pytest.mark.cuda
def test_cuda_kernel_refuses_a_slab_that_needs_a_gradient(cuda_device):
    g, lo, n_pad = _on(cuda_device, "n_pad256", np.float32)
    g.requires_grad_(True)
    with pytest.raises(ValueError, match="no backward"):
        gram_assembly.gram_assembly(g, lo, n_pad)
    with torch.no_grad():
        got = gram_assembly.gram_assembly(g, lo, n_pad)
    assert torch.equal(got, gram_assembly_torch(g.detach(), lo, n_pad))


_BAD_START = """
import torch
from deeppreconditioning_tpu_torch.ops.gram_assembly import gram_assembly
g = torch.zeros((2, 8, 8), device="cuda")
lo = torch.tensor([0, {start}], device="cuda")
gram_assembly(g, lo, 32)
torch.cuda.synchronize()
print("no error")
"""


@pytest.mark.cuda
@pytest.mark.parametrize("start", [25, -1])
def test_cuda_kernel_fails_on_a_start_out_of_range(start, cuda_device):
    """A start past n_pad - H (or below 0) fails the launch on the device
    (an assert the kernel checks at every launch), in a process of its
    own: the error leaves that process's CUDA context unusable."""
    out = subprocess.run(
        [sys.executable, "-c", _BAD_START.format(start=start)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no error" not in out.stdout
    assert "assert" in (out.stdout + out.stderr).lower()
