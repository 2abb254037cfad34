"""The port's generate stage: the FVM pressure-Poisson data set on disk.

    python -m deeppreconditioning_tpu_torch.generate_data \
        [--samples N] [--mesh-cells M] [--root DIR] [--family 2d|3d]

Counterpart of ``scripts/generate_data.py``: ``--samples`` cases
(default ``params.yaml``'s ``number_samples``) from seed 69420 at
``--mesh-cells`` (default ``mesh_cells``), written under ``--root``
(default ``data_root``, ``assets/data/raw``) as
``sludge_patterns/case_0000`` ... in the reference's layout
(``matrix.npz`` a scipy COO archive, ``right_hand_side.csv``,
``solution.csv``; ``data.fvm.save_case``).  ``--family 3d`` writes the
castellated 3-D cases to ``sludge_patterns_3d``, every other case
randomly permuted (the non-banded split).

The work is on the host: the 2-D assembly takes the host runtime's
``fvm_assemble`` whenever it builds (``data.fvm.native_assembly``), as
the reference takes its native library; the ground-truth solve is
scipy's CG.  With the numpy assembly pinned (``data.fvm.numpy_assembly``)
the archives' arrays and the text files equal the reference's byte for
byte.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

from deeppreconditioning_tpu_torch.config import params_show
from deeppreconditioning_tpu_torch.data.fvm import (
    generate_sludge_case,
    generate_sludge_case_3d,
    save_case,
)

REPO = Path(__file__).resolve().parents[1]
SEED = 69420  # scripts/generate_data.py's seed


def parse_args(argv=None) -> argparse.Namespace:
    params = params_show(REPO / "params.yaml")
    parser = argparse.ArgumentParser(
        prog="python -m deeppreconditioning_tpu_torch.generate_data")
    parser.add_argument("--samples", type=int, default=params.number_samples)
    parser.add_argument("--mesh-cells", type=int, default=params.mesh_cells)
    parser.add_argument("--root", type=Path, default=REPO / params.data_root)
    parser.add_argument(
        "--family", default="2d", choices=["2d", "3d"],
        help="2d: structured sludge tanks (reference parity); 3d: "
        "castellated 3-D meshes, every other case randomly permuted")
    return parser.parse_args(argv)


def run(args: argparse.Namespace, log=print) -> Path:
    """Generate and write the cases; returns the family's folder."""
    rng = np.random.default_rng(SEED)
    suffix = "" if args.family == "2d" else "_3d"
    out = Path(args.root) / f"sludge_patterns{suffix}"
    start = time.perf_counter()
    for i in range(args.samples):
        if args.family == "3d":
            case = generate_sludge_case_3d(
                rng, mesh_cells=args.mesh_cells, castellated=True,
                permute=bool(i % 2))
        else:
            case = generate_sludge_case(rng, mesh_cells=args.mesh_cells)
        save_case(case, out / f"case_{i:04d}")
        if (i + 1) % 50 == 0:
            rate = (i + 1) / (time.perf_counter() - start)
            log(f"{i + 1}/{args.samples} cases ({rate:.1f}/s)")
    log(f"done: {args.samples} cases in {time.perf_counter() - start:.1f}s "
        f"-> {out}")
    return out


def main(argv=None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
