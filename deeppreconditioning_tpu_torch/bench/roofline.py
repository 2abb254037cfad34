"""The SpMV roofline on the card: kernel B2's sweep and kernel B3's rows.

    python -m deeppreconditioning_tpu_torch.bench.roofline

Counterpart of ``scripts/spmv_roofline.py``.  Two sections:

- DIA: the 7-point Poisson operator (``poisson_dia``) at 64^3, 96^3,
  128^3, 192^3 and 256^3 through B2, beside the matrix-free stencil (plain
  PyTorch) on the same grid.  Bytes per call: ``(n_diag + 2) * n_pad * 4``
  for B2 (bands, x and y once), ``2 * n * 4`` for the stencil.
- BSR at block size 128 through B3's m = 1 path: ``block_dense_512x8``
  (every stored block full; the kernel's design point), the 30x30x20
  ``frame_structure`` stiffness operator (6 dof per node, the format's
  real consumer) and the castellated 3-D stencils ``stencil_48cubed`` /
  ``stencil_64cubed`` (a 7-point row fills a few percent of a block: the
  format's mismatch, kept visible).  Bytes per call: every stored block,
  the block-column table, x and y, ``R * S * bs^2 * 4 + R * S * 4 +
  2 * n_pad * 4``; ``bsr_block_gb_s`` counts the blocks alone, as the
  reference's column does.

Every row is timed under both protocols of ``utils/profiling.time_stream``
(cold: a pool of operand copies past twice the L2; resident: one
operand), as ``bench/spmv.py`` does, and reported as microseconds per
call, Gnnz/s, GB/s and the share of the card's HBM bandwidth.  Writes
``assets/results/torch/spmv_roofline.csv`` and ``spmv_bsr.csv`` with the
reference's column names (its unsuffixed times are the cold protocol
here) plus the resident and HBM-share columns.  The reference's TPU halo
byte model, its dependency-chained timing and its ``--dia-only`` escape
are not kept.
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np
import torch

from deeppreconditioning_tpu_torch import _backend
from deeppreconditioning_tpu_torch.bench.spmv import _dia_call, _row
from deeppreconditioning_tpu_torch.bench.suite import RESULTS_DIRECTORY
from deeppreconditioning_tpu_torch.data.frames import generate_frame_case
from deeppreconditioning_tpu_torch.data.fvm import generate_sludge_case_3d
from deeppreconditioning_tpu_torch.ops.bsr_spmm import bsr_matvec
from deeppreconditioning_tpu_torch.ops.stencil import poisson3d_stencil_matvec
from deeppreconditioning_tpu_torch.sparse.bsr import BSRMatrix
from deeppreconditioning_tpu_torch.sparse.dia import poisson_dia
from deeppreconditioning_tpu_torch.utils.profiling import hbm_bandwidth_gb_s

DIA_SIDES = (64, 96, 128, 192, 256)
BLOCK_SIZE = 128
FRAME_DIMS = (30, 30, 20)
STENCIL_SIDES = (48, 64)
BLOCK_DENSE = (512, 8)  # block rows, dense blocks per row


def dia_bytes(n_diag: int, n_pad: int) -> int:
    """Bytes a B2 call moves at least: the bands, x and y once."""
    return (n_diag + 2) * n_pad * 4


def bsr_bytes(a: BSRMatrix) -> int:
    """Bytes a B3 m = 1 call moves at least: every stored block (empty
    slots included, as the kernel reads them), the block-column table, x
    and y."""
    return a.blocks.numel() * 4 + a.block_cols.numel() * 4 + 2 * a.n_pad * 4


def block_dense_operator(n_rows: int = BLOCK_DENSE[0],
                         per_row: int = BLOCK_DENSE[1],
                         block_size: int = BLOCK_SIZE, seed: int = 5,
                         device=None) -> tuple[BSRMatrix, int]:
    """The reference's design point (``default_rng(5)``): ``per_row``
    random block columns per block row, each a dense standard-normal
    block, built straight from the block list (repeated columns summed,
    as the reference's round trip through CSR sums them); returns the
    matrix and its nnz."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n_rows), per_row)
    cols = rng.integers(0, n_rows, size=n_rows * per_row)
    blocks = rng.standard_normal(
        (n_rows * per_row, block_size, block_size)).astype(np.float32)
    a = BSRMatrix.from_blocks(rows, cols, blocks, n_rows, device=device)
    return a, int(torch.count_nonzero(a.blocks))


def frame_operator(dims=FRAME_DIMS, block_size: int = BLOCK_SIZE,
                   device=None) -> tuple[BSRMatrix, int]:
    """The frame-structure stiffness operator on a ``dims`` node grid
    (``default_rng(9)``, no ground-truth solve) and its nnz."""
    case = generate_frame_case(np.random.default_rng(9), dims=dims,
                               solve=False)
    mat = case.matrix.tocsr()
    return (BSRMatrix.from_scipy(mat, block_size=block_size, device=device),
            mat.nnz)


def stencil_operator(side: int, block_size: int = BLOCK_SIZE,
                     device=None) -> tuple[BSRMatrix, int]:
    """The castellated 3-D pressure-Poisson stencil on a ``side``^3 grid
    (``default_rng(7)``, no ground-truth solve) and its nnz."""
    case = generate_sludge_case_3d(np.random.default_rng(7),
                                   dims=(side,) * 3, max_cells=side ** 3,
                                   solve=False)
    mat = case.matrix.tocsr()
    return (BSRMatrix.from_scipy(mat, block_size=block_size, device=device),
            mat.nnz)


def bsr_operators(device) -> list[tuple[str, BSRMatrix, int]]:
    """The BSR section's operators, float32 on ``device``: (name, matrix,
    nnz)."""
    ops = [(f"block_dense_{BLOCK_DENSE[0]}x{BLOCK_DENSE[1]}",
            *block_dense_operator(device=device)),
           ("frame_structure", *frame_operator(device=device))]
    ops += [(f"stencil_{g}cubed", *stencil_operator(g, device=device))
            for g in STENCIL_SIDES]
    return ops


def _bsr_call(blocks, cols, x):
    return bsr_matvec(
        BSRMatrix(blocks=blocks, block_cols=cols,
                  n=blocks.shape[0] * blocks.shape[2]), x)


def _flat(prefix: str, report: dict) -> dict:
    return {
        f"{prefix}_us": report["time_us"],
        f"{prefix}_gnnz_s": report["gnnz_per_s"],
        f"{prefix}_gb_s": report["achieved_gb_s"],
        f"{prefix}_bw_frac": report["bandwidth_fraction"],
    }


@torch.no_grad()
def dia_section(device, sides=DIA_SIDES) -> list[dict]:
    """One CSV row per grid side: B2 and the stencil, cold and resident."""
    hbm = hbm_bandwidth_gb_s(torch.cuda.get_device_name(device))
    rng = np.random.default_rng(0)
    out = []
    for g in sides:
        shape = (g, g, g)
        a = poisson_dia(shape, device=device)
        x = torch.tensor(rng.standard_normal(a.n_pad), dtype=torch.float32,
                         device=device)
        nnz = int(torch.count_nonzero(a.vals))
        dia = _row(f"dia_{g}", lambda v, xx, _o=a.offsets, _n=a.n:
                   _dia_call(v, xx, _o, _n), (a.vals, x), nnz,
                   dia_bytes(len(a.offsets), a.n_pad), device, hbm)
        stencil = _row(f"stencil_{g}", lambda xx, _s=shape:
                       poisson3d_stencil_matvec(xx, _s), (x,), nnz,
                       2 * a.n * 4, device, hbm)
        row = {"grid": g, "n": a.n, "nnz": nnz}
        for kind, r in (("dia", dia), ("stencil", stencil)):
            row.update(_flat(kind, r["cold"]))
            row.update(_flat(f"{kind}_resident", r["resident"]))
        out.append(row)
        del a, x
    return out


@torch.no_grad()
def bsr_section(device, operators=None) -> list[dict]:
    """One CSV row per BSR operator (``operators`` defaults to
    ``bsr_operators(device)``): B3 at m = 1, cold and resident."""
    hbm = hbm_bandwidth_gb_s(torch.cuda.get_device_name(device))
    operators = operators or bsr_operators(device)
    rng = np.random.default_rng(0)
    out = []
    for name, a, nnz in operators:
        x = torch.tensor(rng.standard_normal(a.n_pad), dtype=torch.float32,
                         device=device)
        moved = bsr_bytes(a)
        r = _row(name, _bsr_call, (a.blocks, a.block_cols, x), nnz, moved,
                 device, hbm)
        block_share = a.blocks.numel() * 4 / moved
        row = {"operator": name, "n": a.n, "nnz": nnz,
               "block_fill": nnz / a.blocks.numel()}
        for prefix, report in (("bsr", r["cold"]),
                               ("bsr_resident", r["resident"])):
            row[f"{prefix}_us"] = report["time_us"]
            row[f"{prefix}_gnnz_s"] = report["gnnz_per_s"]
            row[f"{prefix}_block_gb_s"] = report["achieved_gb_s"] * block_share
            row[f"{prefix}_gb_s"] = report["achieved_gb_s"]
            row[f"{prefix}_bw_frac"] = report["bandwidth_fraction"]
        row.update(block_rows=a.n_block_rows, slots=a.slots,
                   bytes_per_call=moved)
        out.append(row)
        del x
    return out


def write_csv(rows: list[dict], path: Path, device_name: str) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w") as fio:
        writer = csv.DictWriter(fio, fieldnames=[*rows[0], "device"])
        writer.writeheader()
        writer.writerows({**row, "device": device_name} for row in rows)


def main() -> None:
    device = _backend.device()
    name = torch.cuda.get_device_name(device)
    print(f"device: {name}")
    dia = dia_section(device)
    for row in dia:
        print(f"{row['grid']:>3}^3 B2 cold {row['dia_us']:.2f} us "
              f"({row['dia_bw_frac']:.3f} HBM) resident "
              f"{row['dia_resident_us']:.2f} us; stencil cold "
              f"{row['stencil_us']:.2f} us")
    write_csv(dia, RESULTS_DIRECTORY / "spmv_roofline.csv", name)
    bsr = bsr_section(device)
    for row in bsr:
        print(f"{row['operator']:<18} B3 cold {row['bsr_us']:.2f} us "
              f"{row['bsr_gnnz_s']:.2f} Gnnz/s {row['bsr_block_gb_s']:.1f} "
              f"block GB/s ({row['bsr_bw_frac']:.3f} HBM) resident "
              f"{row['bsr_resident_us']:.2f} us")
    write_csv(bsr, RESULTS_DIRECTORY / "spmv_bsr.csv", name)
    print(f"wrote {RESULTS_DIRECTORY / 'spmv_roofline.csv'} and "
          f"{RESULTS_DIRECTORY / 'spmv_bsr.csv'}")


if __name__ == "__main__":
    main()
