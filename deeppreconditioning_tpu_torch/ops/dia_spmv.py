"""Banded SpMV: kernel B2, its launch plan, its dispatch and its backward.

``dia_matvec(a, x)`` computes ``y = A x`` for a ``DIAMatrix``, keeping the
interface of the reference's ``ops/pallas_spmv.py::dia_matvec``; batched
values (S, n_diag, n_pad) take x (S, n_pad), all S products in one launch.

Dispatch follows the tensor: a CPU tensor takes the plain PyTorch version
(``DIAMatrix.matvec``); a CUDA tensor launches the hand-written kernel
``csrc/dia_spmv.cu`` (which replaces the TPU kernel
``ops/pallas_spmv.py::_dia_kernel``) or raises.  There is no fallback
from the kernel to the plain version and no size crossover: every CUDA
matvec, coarse multigrid levels included, is a kernel launch.

Every check of the operator, and the kernel's tiling, is done once per
operator: ``launch_plan`` checks the values, takes the tile geometry
(``tile_geometry``, cached by band layout: the window groups, the tile,
the grid and the parameter block the kernel reads) and caches the plan on
the ``DIAMatrix``, keyed on the values' address, shape, dtype and device,
so replaced values build a new plan.  A call then checks only x, allocates
y, reads the raw current stream (``torch._C._cuda_getCurrentRawStream``,
which follows a CUDA graph's capture stream) and makes one ctypes call.
So ``dia_matvec`` is declared ``capture_safe`` (``utils/graphs.py``): the
single-system PCG replays its launches from a CUDA graph.

Where x needs a gradient, the product goes through ``DIAMatvec``, an
autograd function whose forward is that dispatch and whose backward is
the same dispatch on A^T (``DIAMatrix.transpose``: offsets negated, bands
re-based), so on the card both directions are B2 launches, each through
its operator's plan.  The reference has no such kernel: XLA differentiates
its plain product.  A gradient for the values is not provided: on the
card a ``vals`` that needs one raises, as B1 does; on the CPU the plain
product carries it.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from deeppreconditioning_tpu_torch import _backend
from deeppreconditioning_tpu_torch.sparse.dia import DIAMatrix
from deeppreconditioning_tpu_torch.utils.graphs import capture_safe

MAX_DIAGS = 32  # the window table travels by value in the kernel's parameters
MAX_ROWS = 1 << 30  # int row and window indices stay in range
MAX_BATCH = 65535  # the sample is the launch grid's y index
CHUNK = 4  # floats in one 16-byte cp.async chunk; n_pad is a multiple
SMEM_BYTES = 48 * 1024  # shared memory a CTA takes without the opt-in
CTA_THREADS = (256, 128, 64, 32)  # the plan's choices, largest tile first
SM_COUNT = 132  # H100 SXM: the grid gives each SM a CTA where it can


def max_rows_per_thread(n_diag: int) -> int:
    """The most rows R a thread may own: 4 up to 8 bands, 2 up to 16, 1
    above (the band values a thread holds stay at 32 registers or
    fewer)."""
    return 4 if n_diag <= 8 else 2 if n_diag <= 16 else 1


class _PlanParams(ctypes.Structure):
    """The kernel's launch plan, field for field ``DiaPlan`` in
    ``csrc/dia_spmv.cu``."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "n_diag", "n_pad", "batch", "threads", "rows", "tiles",
        "smem_floats", "n_groups")] + [
        (name, ctypes.c_int * MAX_DIAGS) for name in (
            "win_start", "win_chunks", "win_base", "band_base")]


@dataclass(frozen=True)
class TileGeometry:
    """How B2 tiles one band layout: T = ``threads * rows`` rows a CTA,
    ``tiles`` CTAs a sample; per window group its start relative to the
    tile's first row, its 16-byte chunks and its first float in shared
    memory; per band (in band order) the shared index of x[t0 + off].
    ``smem_floats`` holds the windows and one chunk past them (a thread's
    second aligned vector may reach into it)."""

    offsets: tuple[int, ...]
    n_pad: int
    batch: int
    threads: int
    rows: int
    tiles: int
    windows: tuple[tuple[int, int, int], ...]  # (start, chunks, base)
    band_base: tuple[int, ...]
    smem_floats: int
    params: _PlanParams

    @property
    def tile(self) -> int:
        return self.threads * self.rows

    @property
    def smem_bytes(self) -> int:
        return 4 * self.smem_floats


def window_groups(offsets, tile: int) -> list[tuple[int, int]]:
    """(min, max) offset of each window group: the sorted offsets, merged
    wherever two neighbours lie less than ``tile`` apart."""
    groups: list[list[int]] = []
    for off in sorted(set(offsets)):
        if groups and off - groups[-1][1] < tile:
            groups[-1][1] = off
        else:
            groups.append([off, off])
    return [(lo, hi) for lo, hi in groups]


def _windows(offsets, tile: int):
    """The windows of one tile size: ((start, chunks, base) per group,
    band_base per band, shared floats)."""
    windows, base_of = [], {}
    base = 0
    for lo, hi in window_groups(offsets, tile):
        start = (lo // CHUNK) * CHUNK  # rounded out to whole chunks
        end = -(-(tile + hi) // CHUNK) * CHUNK
        windows.append((start, (end - start) // CHUNK, base))
        for off in offsets:
            if lo <= off <= hi:
                base_of[off] = base + off - start
        base += end - start
    return windows, tuple(base_of[off] for off in offsets), base + CHUNK


@functools.lru_cache(maxsize=256)
def tile_geometry(offsets: tuple[int, ...], n_pad: int, batch: int,
                  sm_count: int = SM_COUNT, rows: int | None = None,
                  threads: int | None = None) -> TileGeometry:
    """The tile for a band layout: the largest T (at most 256 threads)
    whose windows fit ``SMEM_BYTES`` and whose grid gives each of
    ``sm_count`` SMs a CTA, else the smallest that fits.  ``rows`` and
    ``threads`` pin R and the CTA size (``scripts/torch_dia_tile_sweep.py``
    times every pair)."""
    n_diag = len(offsets)
    if not 1 <= n_diag <= MAX_DIAGS:
        raise ValueError(f"{n_diag} bands; the kernel takes 1..{MAX_DIAGS}")
    if any(abs(o) > MAX_ROWS for o in offsets):
        raise ValueError(f"offsets outside +-{MAX_ROWS}: {offsets}")
    if not CHUNK <= n_pad <= MAX_ROWS or n_pad % CHUNK:
        raise ValueError(f"n_pad {n_pad}: the kernel takes a multiple of "
                         f"{CHUNK} in {CHUNK}..{MAX_ROWS}")
    if not 1 <= batch <= MAX_BATCH:
        raise ValueError(f"batch {batch} outside 1..{MAX_BATCH}")
    top = max_rows_per_thread(n_diag)
    if rows not in (None, 1, 2, 4) or (rows or 1) > top:
        raise ValueError(f"{rows} rows a thread; {n_diag} bands take 1.."
                         f"{top}")
    if threads is not None and threads not in CTA_THREADS:
        raise ValueError(f"{threads} threads; the kernel takes {CTA_THREADS}")
    pairs = [(rows or top, t) for t in CTA_THREADS if threads in (None, t)]
    chosen = None
    for r, t in pairs:
        tile = t * r
        windows, band_base, smem_floats = _windows(offsets, tile)
        if 4 * smem_floats > SMEM_BYTES:
            continue
        chosen = r, t, windows, band_base, smem_floats
        if -(-n_pad // tile) * batch >= sm_count:
            break
    if chosen is None:
        raise ValueError(f"no tile of {offsets} fits {SMEM_BYTES} bytes of "
                         f"shared memory")
    rows, threads, windows, band_base, smem_floats = chosen
    tiles = -(-n_pad // (threads * rows))
    params = _PlanParams(
        n_diag=n_diag, n_pad=n_pad, batch=batch, threads=threads, rows=rows,
        tiles=tiles, smem_floats=smem_floats, n_groups=len(windows))
    for g, (start, chunks, base) in enumerate(windows):
        params.win_start[g] = start
        params.win_chunks[g] = chunks
        params.win_base[g] = base
    for d, base in enumerate(band_base):
        params.band_base[d] = base
    return TileGeometry(
        offsets=tuple(offsets), n_pad=n_pad, batch=batch, threads=threads,
        rows=rows, tiles=tiles, windows=tuple(windows), band_base=band_base,
        smem_floats=smem_floats, params=params)


def check_values(vals: torch.Tensor, offsets) -> tuple[int, int, int]:
    """Everything B2 needs of an operator's values but their device:
    float32, (n_diag, n_pad) or (S, n_diag, n_pad) with one band per
    offset, 1..32 bands, n_pad and S in range, contiguous, 16-byte
    aligned, and no gradient wanted under grad mode.  Returns (n_diag,
    n_pad, batch); raises ValueError otherwise."""
    if vals.dtype != torch.float32:
        raise ValueError(f"float32 only, got {vals.dtype}")
    if vals.dim() not in (2, 3):
        raise ValueError(f"vals must be (n_diag, n_pad) or (S, n_diag, "
                         f"n_pad), got {tuple(vals.shape)}")
    n_diag, n_pad = vals.shape[-2:]
    batch = vals.shape[0] if vals.dim() == 3 else 1
    if n_diag != len(offsets) or not 1 <= n_diag <= MAX_DIAGS:
        raise ValueError(f"{n_diag} bands for {len(offsets)} offsets; "
                         f"the kernel takes 1..{MAX_DIAGS}")
    if (not CHUNK <= n_pad <= MAX_ROWS or n_pad % CHUNK
            or not 1 <= batch <= MAX_BATCH):
        raise ValueError(f"n_pad {n_pad} (a multiple of {CHUNK} in "
                         f"{CHUNK}..{MAX_ROWS}) or batch {batch} (1.."
                         f"{MAX_BATCH}) out of range")
    if not vals.is_contiguous() or vals.data_ptr() % 16:
        raise ValueError("vals must be contiguous and 16-byte aligned")
    if torch.is_grad_enabled() and vals.requires_grad:
        raise ValueError("dia_spmv_cuda has no backward: the values must "
                         "not require a gradient")
    return n_diag, n_pad, batch


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@dataclass(frozen=True)
class LaunchPlan:
    """One operator's launch: its key (the values' address, shape, dtype
    and device), offsets, the device index and shape x must have, the
    tile geometry of its band layout and the address of its parameter
    block."""

    key: tuple
    offsets: tuple[int, ...]
    device_index: int
    x_shape: torch.Size
    geometry: TileGeometry
    params_ptr: int


def launch_plan(a: DIAMatrix) -> LaunchPlan:
    """``a``'s cached launch plan, built (and cached on ``a``) when there
    is none or its key no longer matches ``a.vals``; raises ValueError on
    values the kernel does not take."""
    vals = a.vals
    key = (vals.data_ptr(), vals.shape, vals.dtype, vals.device)
    plan = a.launch_plan
    if plan is not None and plan.key == key and plan.offsets is a.offsets:
        return plan
    if vals.device.type != "cuda":
        raise ValueError(f"dia_spmv_cuda needs vals on a CUDA device, got "
                         f"{vals.device}")
    _, n_pad, batch = check_values(vals, a.offsets)
    index = vals.device.index
    geometry = tile_geometry(tuple(a.offsets), n_pad, batch,
                             _sm_count(index))
    plan = LaunchPlan(
        key=key, offsets=a.offsets, device_index=index,
        x_shape=vals.shape[:-2] + (n_pad,), geometry=geometry,
        params_ptr=ctypes.addressof(geometry.params))
    a.launch_plan = plan
    return plan


def _launch(lib, a: DIAMatrix, x: torch.Tensor) -> torch.Tensor:
    """The per-call path: the cached plan, x's checks, y, one launch."""
    vals = a.vals
    plan = launch_plan(a)
    if (x.get_device() != plan.device_index or x.dtype != torch.float32
            or x.shape != plan.x_shape or not x.is_contiguous()):
        raise ValueError(
            f"x must be a contiguous float32 {tuple(plan.x_shape)} on "
            f"cuda:{plan.device_index}, got {x.dtype} {tuple(x.shape)} on "
            f"{x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or vals.requires_grad):
        raise ValueError("dia_spmv_cuda has no backward: its operands must "
                         "not require a gradient")
    x_ptr = x.data_ptr()
    if x_ptr % 16:
        raise ValueError("x must start on a 16-byte boundary")
    y = torch.empty_like(x)
    rc = lib.dp_dia_spmv_f32(
        plan.key[0], x_ptr, y.data_ptr(), plan.params_ptr,
        torch._C._cuda_getCurrentRawStream(plan.device_index))
    if rc != 0:
        raise RuntimeError(f"dia_spmv kernel launch failed: cuda error {rc}")
    _backend.count_launch("dia_spmv")
    return y


def dia_spmv_cuda(a: DIAMatrix, x: torch.Tensor) -> torch.Tensor:
    """Launch kernel B2 on the current stream; raises on anything it does
    not take (device, dtype, shape, contiguity, alignment, more than 32
    bands), on operands that need a gradient (the launch has none:
    ``dia_matvec`` routes such an x through ``DIAMatvec``) and on a
    refused launch."""
    return _launch(_backend.kernel_library(), a, x)


_CPU = torch.device("cpu")  # compared with x.device: cheaper than its type


def _dispatch(a: DIAMatrix, x: torch.Tensor) -> torch.Tensor:
    if x.device == _CPU:
        return a.matvec(x)
    return dia_spmv_cuda(a, x)


class DIAMatvec(torch.autograd.Function):
    """y = A x with dL/dx = A^T dL/dy, both through ``dia_matvec``'s
    dispatch (B2 on the card).  A^T is ``a.transpose()``, or the operator
    passed as ``a_t`` (built once by a caller that reuses A, and then its
    launch plan with it)."""

    @staticmethod
    def forward(ctx, x, a, a_t):
        if a.vals.requires_grad:
            raise ValueError("DIAMatvec has no gradient for the values")
        ctx.a, ctx.a_t = a, a_t
        return _dispatch(a, x.contiguous())

    @staticmethod
    def backward(ctx, grad):
        a_t = ctx.a_t if ctx.a_t is not None else ctx.a.transpose()
        return _dispatch(a_t, grad.contiguous()), None, None


@capture_safe
def dia_matvec(a: DIAMatrix, x: torch.Tensor,
               a_t: DIAMatrix | None = None) -> torch.Tensor:
    """y = A x.  CPU: plain version; otherwise the CUDA kernel, or raise.
    An x that needs a gradient goes through ``DIAMatvec`` (``a_t``, if
    given, is A^T for its backward)."""
    if x.device == _CPU:
        if torch.is_grad_enabled() and x.requires_grad and not (
                a.vals.requires_grad):
            return DIAMatvec.apply(x, a, a_t)
        return a.matvec(x)
    lib = _backend.kernel_library()  # the kernel or raise, before anything
    if torch.is_grad_enabled() and x.requires_grad:
        return DIAMatvec.apply(x, a, a_t)
    return _launch(lib, a, x)
