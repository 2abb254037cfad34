"""Kernel B2's launch plan, on the CPU: the tile geometry that
``csrc/dia_spmv.cu`` runs (window groups, 16-byte chunks, shared memory,
grid) on the operators the port applies it to, a pure-torch emulation of
the kernel's indexing (x staged per window, read back per band) held bit
for bit against ``DIAMatrix.matvec`` in float32 and float64, and the
plan's checks on values the kernel refuses.

The kernel itself runs only on a card: the ``cuda``-marked tests at the
end (``python -m pytest --noconftest -m cuda tests/test_torch_dia_launch.py``)
hold the cached plan and the raw stream under CUDA-graph capture there.
"""

import numpy as np
import pytest
import torch

from deeppreconditioning_tpu_torch import _backend
from deeppreconditioning_tpu_torch.data.poisson import poisson_coeff_dia
from deeppreconditioning_tpu_torch.ops import dia_spmv
from deeppreconditioning_tpu_torch.ops.structured_fsai import (
    bands_to_dia,
    build_structured_plan,
    structured_setup,
)
from deeppreconditioning_tpu_torch.sparse.dia import DIAMatrix, poisson_dia

OPERATORS = ["poisson_512^2", "poisson_128^3", "batched_12^3",
             "batched_12^3_transpose", "c_up_12^3", "c_low_12^3",
             "c_up_128^3", "c_low_128^3", "bands_32"]


def _operator(name, dtype=torch.float32):
    rng = np.random.default_rng(11)
    if name == "poisson_512^2":
        return poisson_dia((512, 512), dtype=dtype)
    if name == "poisson_128^3":
        return poisson_dia((128, 128, 128), dtype=dtype)
    if name.startswith("batched_12^3"):
        # the structured trainer's operator: 32 samples of 12^3
        a = poisson_coeff_dia((12, 12, 12), rng=rng, dtype=dtype)
        scale = torch.tensor(rng.uniform(0.5, 2.0, 32), dtype=dtype)
        vals = a.vals[None] * scale[:, None, None]
        vals[:, 1] += 0.25  # unsymmetric
        a = DIAMatrix(vals=vals, offsets=a.offsets, n=a.n)
        return a.transpose() if name.endswith("transpose") else a
    if name.endswith("12^3"):
        # the halves of a real structured FSAI factor
        a = poisson_coeff_dia((12, 12, 12), rng=rng, dtype=dtype)
        plan = build_structured_plan((12, 12, 12), power=2)
        bands, _ = structured_setup(a, plan)
        c_up, c_low = bands_to_dia(bands, plan.offsets, a.n)
        return c_up if name.startswith("c_up") else c_low
    if name.endswith("128^3"):
        # the 128^3 factor's band layout, random values
        plan = build_structured_plan((128, 128, 128), power=2)
        n = 128 ** 3
        bands = torch.tensor(rng.standard_normal((len(plan.offsets), n)),
                             dtype=dtype)
        c_up, c_low = bands_to_dia(bands, plan.offsets, n)
        return c_up if name.startswith("c_up") else c_low
    assert name == "bands_32"
    offsets = tuple(int(o) for o in rng.choice(
        np.arange(-3000, 3001), size=32, replace=False))
    return DIAMatrix(vals=torch.tensor(rng.standard_normal((32, 8192)),
                                       dtype=dtype), offsets=offsets, n=8000)


def _geometry(a):
    batch = a.vals.shape[0] if a.vals.dim() == 3 else 1
    return dia_spmv.tile_geometry(tuple(a.offsets), a.n_pad, batch)


def _slot_sources(geom):
    """For every float of a CTA's shared memory, the x index (relative to
    the tile's first row) that the window copies put there; a large
    negative sentinel in the padding chunk."""
    slot = torch.full((geom.smem_floats,), -(1 << 40), dtype=torch.int64)
    for start, chunks, base in geom.windows:
        slot[base:base + 4 * chunks] = start + torch.arange(4 * chunks)
    return slot


def _emulate(geom, a, x):
    """The kernel's arithmetic through its indexing: row i of tile t reads
    band d's x from shared float ``band_base[d] + r`` (r = i - t0), as the
    two aligned R-vectors around it and the shift select do; the window
    holds x[t0 + slot] there, zero outside [0, n_pad).  Products and sums
    in band order, each rounded."""
    n_pad, rows, tile = geom.n_pad, geom.rows, geom.tile
    slot = _slot_sources(geom)
    i = torch.arange(n_pad)
    r = i % tile
    r0, k = (r // rows) * rows, r % rows
    x_flat = x.reshape(-1, n_pad)
    vals = a.vals.reshape(-1, len(a.offsets), n_pad)
    acc = torch.zeros_like(x_flat)
    for d, base in enumerate(geom.band_base):
        shift = (base + r0) % rows
        aligned = base + r0 - shift
        assert bool((aligned % rows == 0).all())
        assert int(aligned.max()) + 2 * rows - 1 < geom.smem_floats
        src = (i - r) + slot[aligned + shift + k]
        inside = (src >= 0) & (src < n_pad)
        xv = torch.where(inside, x_flat[:, src.clamp(0, n_pad - 1)],
                         torch.zeros((), dtype=x.dtype))
        acc = acc + vals[:, d] * xv
    return acc.reshape(x.shape)


@pytest.mark.parametrize("name", OPERATORS)
def test_windows_cover_every_read(name):
    """Every (band, row of a tile) reads, through its band base, the
    shared float that holds x[row + offset]; the windows are whole
    16-byte chunks at chunk-aligned starts; the CTA's shared memory stays
    within 48 KB; the grid covers every row and every sample."""
    a = _operator(name)
    geom = _geometry(a)
    tile = geom.tile
    assert geom.rows == dia_spmv.max_rows_per_thread(len(a.offsets))
    assert tile % 4 == 0 and geom.threads % 32 == 0
    slot = _slot_sources(geom)
    rel = torch.arange(tile)
    for d, off in enumerate(a.offsets):
        assert torch.equal(slot[geom.band_base[d] + rel], rel + off), (d, off)
    ends = []
    for start, chunks, base in geom.windows:
        assert start % 4 == 0 and base % 4 == 0 and chunks > 0
        ends.append(base + 4 * chunks)
    assert geom.smem_floats == max(ends) + 4
    assert geom.smem_bytes <= 48 * 1024
    assert geom.tiles * tile >= a.n_pad > (geom.tiles - 1) * tile
    batch = a.vals.shape[0] if a.vals.dim() == 3 else 1
    assert geom.batch == batch and geom.params.batch == batch
    p = geom.params
    assert (p.n_diag, p.n_pad, p.threads, p.rows, p.tiles, p.smem_floats,
            p.n_groups) == (len(a.offsets), a.n_pad, geom.threads,
                            geom.rows, geom.tiles, geom.smem_floats,
                            len(geom.windows))
    assert list(p.band_base[:len(a.offsets)]) == list(geom.band_base)


@pytest.mark.parametrize("name", OPERATORS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_emulated_kernel_equals_plain(name, dtype):
    a = _operator(name, dtype)
    rng = np.random.default_rng(12)
    x = torch.tensor(rng.standard_normal(tuple(a.vals.shape[:-2])
                                         + (a.n_pad,)), dtype=dtype)
    assert torch.equal(_emulate(_geometry(a), a, x), a.matvec(x))


def test_window_groups_of_the_main_layouts():
    """The groups the design names: three windows at 128^3 (T, T + 256,
    T), three for the 128^3 factor halves, one of T + 288 at the
    trainer's 12^3 and one of T + 1024 at 512^2; the trainer's batch
    gets a grid of at least one CTA per SM."""
    g = dia_spmv.tile_geometry((-16384, -128, -1, 0, 1, 128, 16384),
                               128 ** 3, 1)
    assert [4 * c for _, c, _ in g.windows] == [g.tile, g.tile + 256, g.tile]
    halves = build_structured_plan((128,) * 3, power=2).offsets
    for offsets in (halves, tuple(-o for o in halves)):
        assert len(dia_spmv.tile_geometry(offsets, 128 ** 3, 1).windows) == 3
    g = dia_spmv.tile_geometry((-144, -12, -1, 0, 1, 12, 144), 2048, 32)
    assert [4 * c for _, c, _ in g.windows] == [g.tile + 288]
    assert g.tiles * 32 >= dia_spmv.SM_COUNT
    g = dia_spmv.tile_geometry((-512, -1, 0, 1, 512), 512 * 512, 1)
    assert [4 * c for _, c, _ in g.windows] == [g.tile + 1024]


def _vals(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("case", ["dtype", "rank_1", "rank_4", "bands",
                                  "too_many_bands", "n_pad", "batch",
                                  "contiguity", "gradient"])
def test_plan_checks_refuse(case):
    """The plan's checks raise on every operator the kernel refuses."""
    offsets = (-1, 0, 1)
    vals = {
        "dtype": _vals(3, 1024, dtype=torch.float64),
        "rank_1": _vals(1024),
        "rank_4": _vals(2, 2, 3, 1024),
        "bands": _vals(4, 1024),
        "too_many_bands": _vals(33, 1024),
        "n_pad": _vals(3, 1022),
        "batch": _vals(65536, 3, 4),
        "contiguity": _vals(1024, 3).t(),
        "gradient": _vals(3, 1024).requires_grad_(True),
    }[case]
    if case == "too_many_bands":
        offsets = tuple(range(33))
    with torch.enable_grad(), pytest.raises(ValueError):
        dia_spmv.check_values(vals, offsets)


def test_geometry_refuses_what_the_kernel_cannot_tile():
    with pytest.raises(ValueError):
        dia_spmv.tile_geometry(tuple(range(33)), 1024, 1)
    with pytest.raises(ValueError):
        dia_spmv.tile_geometry((0,), 1022, 1)
    with pytest.raises(ValueError):
        dia_spmv.tile_geometry((0,), 1024, 65536)


def test_plan_needs_values_on_a_card():
    """A CPU operator never gets a launch plan: the plan raises."""
    with pytest.raises(ValueError, match="CUDA"):
        dia_spmv.launch_plan(poisson_dia((8, 8)))


def test_every_dia_constructor_pads_to_whole_chunks():
    """The port's DIA constructors pad n_pad to a multiple of 1024, so a
    16-byte chunk of x is wholly inside or wholly outside [0, n_pad)."""
    rng = np.random.default_rng(0)
    a = poisson_coeff_dia((5, 6, 7), rng=rng)
    ops = [poisson_dia((5, 7)), a, a.transpose(),
           DIAMatrix.from_scipy(poisson_dia((9, 9)).to_scipy())]
    plan = build_structured_plan((5, 6, 7), power=2)
    bands, _ = structured_setup(a, plan)
    ops += list(bands_to_dia(bands, plan.offsets, a.n))
    for op in ops:
        assert op.n_pad % 1024 == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_plan_is_cached_and_rebuilt(cuda_device):
    a = poisson_dia((32, 32, 32), device=cuda_device)
    x = torch.randn(a.n_pad, device=cuda_device)
    y = dia_spmv.dia_matvec(a, x)
    plan = a.launch_plan
    assert plan is not None and plan.key[0] == a.vals.data_ptr()
    assert torch.equal(dia_spmv.dia_matvec(a, x), y)
    assert a.launch_plan is plan
    a.vals = a.vals * 2
    assert torch.equal(dia_spmv.dia_matvec(a, x), a.matvec(x))
    assert a.launch_plan is not plan
    with pytest.raises(ValueError, match="x must"):
        dia_spmv.dia_matvec(a, x[:-4])
    with pytest.raises(ValueError, match="16-byte"):
        dia_spmv.dia_matvec(a, torch.randn(a.n_pad + 1,
                                           device=cuda_device)[1:])


@pytest.mark.cuda
def test_cuda_raw_stream_follows_graph_capture(cuda_device):
    """The raw stream the wrapper launches on is the capture stream inside
    ``torch.cuda.graph``, and a replay recomputes the product."""
    a = poisson_dia((32, 32, 32), device=cuda_device)
    x = torch.randn(a.n_pad, device=cuda_device)
    index = cuda_device.index
    dia_spmv.dia_matvec(a, x)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = _backend.launch_counts()["dia_spmv"]
    with torch.cuda.graph(graph):
        raw = torch._C._cuda_getCurrentRawStream(index)
        assert raw == torch.cuda.current_stream(cuda_device).cuda_stream
        y = dia_spmv.dia_matvec(a, x)
    assert _backend.launch_counts()["dia_spmv"] == before + 1
    x.copy_(torch.randn_like(x))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, a.matvec(x))
