"""The SpMV section on the card: kernel B2 against the HBM roofline.

    python -m deeppreconditioning_tpu_torch.bench.spmv

Counterpart of ``bench.py::_spmv_throughput``.  Rows: B2 on
``poisson_dia`` at 2-D 512^2, 3-D 128^3 and 3-D 256^3; B2 on the 13-band
halves of a 128^3 structured FSAI factor (``c_up``, positive offsets, and
``c_low``, negative offsets) of the scaling path's operator; and the
matrix-free 7-point stencil (plain PyTorch) at 128^3 and 256^3.

Each row is timed under both protocols of ``utils/profiling.time_stream``
(cold: a pool of operand copies past twice the L2; resident: one
operand) and reported as microseconds per call, Gnnz/s, GB/s and the
share of the card's HBM bandwidth.  Bytes per DIA call are
``(n_diag + 2) * n_pad * 4`` (read the bands and x once, write y); the
stencil's are ``2 * n * 4`` (read x, write y), its light-speed bound.
"""

from __future__ import annotations

import numpy as np
import torch

from deeppreconditioning_tpu_torch import _backend
from deeppreconditioning_tpu_torch.bench.scaling import scaling_operator
from deeppreconditioning_tpu_torch.ops.dia_spmv import dia_matvec
from deeppreconditioning_tpu_torch.ops.stencil import poisson3d_stencil_matvec
from deeppreconditioning_tpu_torch.ops.structured_fsai import (
    bands_to_dia,
    build_structured_plan,
    structured_setup,
)
from deeppreconditioning_tpu_torch.sparse.dia import DIAMatrix, poisson_dia
from deeppreconditioning_tpu_torch.utils.profiling import (
    RooflineReport,
    cold_pool_size,
    hbm_bandwidth_gb_s,
    time_stream,
)

POISSON_SHAPES = (("2d_512", (512, 512)), ("3d_128", (128, 128, 128)),
                  ("3d_256", (256, 256, 256)))
STENCIL_SHAPES = {f"poisson_{label}": shape
                  for label, shape in POISSON_SHAPES if len(shape) == 3}
FACTOR_SIDE = 128


@torch.no_grad()
def spmv_operators(device) -> list[tuple[str, DIAMatrix]]:
    """The section's DIA operators, float32 on ``device``."""
    ops = [(f"poisson_{label}", poisson_dia(shape, device=device))
           for label, shape in POISSON_SHAPES]
    a, _ = scaling_operator(FACTOR_SIDE, device=device)
    shape = (FACTOR_SIDE,) * 3
    plan = build_structured_plan(shape, power=2)
    bands, _ = structured_setup(a, plan)
    c_up, c_low = bands_to_dia(bands, plan.offsets, a.n)
    ops += [(f"factor_{FACTOR_SIDE}_c_up", c_up),
            (f"factor_{FACTOR_SIDE}_c_low", c_low)]
    return ops


def _dia_call(vals, x, offsets, n):
    return dia_matvec(DIAMatrix(vals=vals, offsets=offsets, n=n), x)


def _row(name, fn, operand, nnz, bytes_moved, device, hbm_gb_s) -> dict:
    """Cold and resident roofline reports of ``fn(*operand)``."""
    operand_bytes = sum(t.numel() * t.element_size() for t in operand)
    copies = cold_pool_size(operand_bytes)
    pool = [operand] + [tuple(t.clone() for t in operand)
                        for _ in range(copies - 1)]
    row = {"name": name, "nnz": nnz, "bytes": bytes_moved}
    for protocol, use in (("cold", pool), ("resident", pool[:1])):
        secs = time_stream(fn, use, device)
        row[protocol] = RooflineReport(
            name=name, seconds=secs, nnz=nnz, bytes_moved=bytes_moved,
            flops=2 * nnz, hbm_gb_s=hbm_gb_s,
        ).summary()
    return row


@torch.no_grad()
def spmv_section(device, operators=None) -> list[dict]:
    """Rows of the section (see the module docstring); ``operators``
    defaults to ``spmv_operators(device)``."""
    hbm = hbm_bandwidth_gb_s(torch.cuda.get_device_name(device))
    operators = operators or spmv_operators(device)
    rng = np.random.default_rng(0)
    rows = []
    for name, a in operators:
        x = torch.tensor(rng.standard_normal(a.n_pad), dtype=torch.float32,
                         device=device)
        nnz = int(torch.count_nonzero(a.vals))
        rows.append(_row(
            name,
            lambda v, xx, _o=a.offsets, _n=a.n: _dia_call(v, xx, _o, _n),
            (a.vals, x), nnz, (len(a.offsets) + 2) * a.n_pad * 4, device,
            hbm,
        ))
        if name in STENCIL_SHAPES:
            shape = STENCIL_SHAPES[name]
            rows.append(_row(
                name.replace("poisson", "stencil"),
                lambda xx, _s=shape: poisson3d_stencil_matvec(xx, _s),
                (x,), nnz, 2 * a.n * 4, device, hbm,
            ))
        del x
    return rows


def main() -> None:
    device = _backend.device()
    print(f"device: {torch.cuda.get_device_name(device)}")
    print(f"{'row':<22} {'protocol':<9} {'us':>9} {'Gnnz/s':>8} "
          f"{'GB/s':>8} {'HBM share':>9}")
    for row in spmv_section(device):
        for protocol in ("cold", "resident"):
            s = row[protocol]
            print(f"{row['name']:<22} {protocol:<9} {s['time_us']:>9.2f} "
                  f"{s['gnnz_per_s']:>8.2f} {s['achieved_gb_s']:>8.1f} "
                  f"{s['bandwidth_fraction']:>9.3f}")


if __name__ == "__main__":
    main()
