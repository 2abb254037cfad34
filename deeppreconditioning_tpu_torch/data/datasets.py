"""Host dataset of FVM or frame cases (tril, identity padding, scaling).

A numpy copy of the host half of ``deeppreconditioning_tpu/data/
datasets.py``: ``_prepare_sample`` (tril filter, symmetric Jacobi scaling
A~ = D^-1/2 A D^-1/2, identity padding to ``dof_pad``, (row, col) sort),
``round_up``, the 80/20 ``_split_folders`` rule and the dataset-global
``dof_max`` / ``dof_pad`` (read from every case, not only the split's).
No conv plans: those belong to the conv model families.

Cases come from disk (``<family>/case_*/matrix.npz`` etc., the layout
``data/fvm.save_case`` writes; the family is ``sludge_patterns``,
``sludge_patterns_3d`` or ``frame_structures``) or from memory (a list of ``FVMCase``); both give
the same host samples.
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple, Sequence

import numpy as np

ROOT: Path = Path("./assets/data/raw/")
FAMILIES = ("sludge_patterns", "sludge_patterns_3d", "frame_structures")


class _HostSample(NamedTuple):
    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray  # scaled tril values incl. identity padding
    solution: np.ndarray  # (dof_pad,) solution of the scaled system
    rhs: np.ndarray  # (dof_pad,) scaled
    scale: np.ndarray  # (dof_pad,) diagonal scale: A = D^1/2 A~ D^1/2
    original_size: int


def round_up(n: int, m: int) -> int:
    return ((max(n, 1) + m - 1) // m) * m


def _prepare_sample(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    solution: np.ndarray,
    rhs: np.ndarray,
    dof_pad: int,
) -> _HostSample:
    """tril filter + identity padding + diagonal normalization + sort.

    The scaled system satisfies A~ x~ = b~ with x~ = D^1/2 x and
    b~ = D^-1/2 b; padding rows are trivial 1 * x = 1 equations.
    """
    n = solution.shape[0]
    keep = rows >= cols
    rows, cols, vals = rows[keep], cols[keep], vals[keep]

    diag = np.ones(n)
    diag_mask = rows == cols
    diag[rows[diag_mask]] = vals[diag_mask]
    if not (diag > 0).all():
        raise ValueError("SPD input must have positive diagonal")
    d_isqrt = 1.0 / np.sqrt(diag)
    vals = vals * d_isqrt[rows] * d_isqrt[cols]

    extra = np.arange(n, dof_pad)
    rows = np.concatenate([rows, extra]).astype(np.int64)
    cols = np.concatenate([cols, extra]).astype(np.int64)
    vals = np.concatenate([vals, np.full(extra.shape, 1.0)])

    order = np.argsort(rows * dof_pad + cols, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]

    scale = np.ones((dof_pad,))
    scale[:n] = diag
    sol = np.full((dof_pad,), 1.0)
    sol[:n] = solution / d_isqrt[:n]
    b = np.full((dof_pad,), 1.0)
    b[:n] = rhs * d_isqrt[:n]

    return _HostSample(
        rows.astype(np.int32), cols.astype(np.int32), vals, sol, b,
        scale, n,
    )


def _split_folders(folders: list, stage: str) -> list:
    """80/20 split by order."""
    cut = len(folders) * 80 // 100
    if stage == "train":
        return folders[:cut]
    if stage == "test":
        return folders[cut:]
    raise ValueError(f"Invalid stage {stage}")


def _read_case(folder: Path) -> tuple:
    with np.load(folder / "matrix.npz") as z:
        rows, cols, vals = z["row"], z["col"], z["data"]
    sol = np.loadtxt(folder / "solution.csv")
    rhs = np.loadtxt(folder / "right_hand_side.csv")
    return rows, cols, vals, sol, rhs


class SludgePatternDataSet:
    """Host samples of a split in case order (batch size 1, not shuffled:
    the benchmark's view of the split).

    ``cases``: in-memory ``FVMCase`` list in generation order; without it
    the cases are read from ``root / family / case_*``.
    ``dof_pad`` is ``round_up(dof_max, 128)`` with ``dof_max`` over every
    case.
    """

    def __init__(
        self,
        stage: str,
        root: Path = ROOT,
        cases: Sequence | None = None,
        family: str = "sludge_patterns",
    ) -> None:
        if family not in FAMILIES:
            raise ValueError(f"family {family!r} not in {FAMILIES}")
        if cases is not None:
            all_items = list(cases)
            dof_max = max(c.matrix.shape[0] for c in all_items)
        else:
            all_items = sorted((Path(root) / family).glob("case_*"))
            if not all_items:
                raise FileNotFoundError(f"no cases under {root}/{family}")
            dof_max = 0
            for folder in all_items:
                with np.load(folder / "matrix.npz") as z:
                    dof_max = max(dof_max, int(z["shape"].max()))
        if dof_max <= 0:
            raise ValueError("Maximum degrees of freedom is zero")
        items = _split_folders(all_items, stage)
        self.dof_max = dof_max
        self.dof_pad = round_up(dof_max, 128)

        self._host = []
        for item in items:
            if cases is not None:
                m = item.matrix
                raw = (m.row, m.col, m.data, item.solution, item.rhs)
            else:
                raw = _read_case(item)
            self._host.append(_prepare_sample(*raw, self.dof_pad))

    def __len__(self) -> int:
        return len(self._host)

    def host_sample(self, index: int) -> _HostSample:
        return self._host[index]
