"""Host dataset of FVM or frame cases (tril, identity padding, scaling).

A numpy copy of the host half of ``deeppreconditioning_tpu/data/
datasets.py``: ``_prepare_sample`` (tril filter, symmetric Jacobi scaling
A~ = D^-1/2 A D^-1/2, identity padding to ``dof_pad``, (row, col) sort),
``round_up``, the 80/20 ``_split_folders`` rule and the dataset-global
``dof_max`` / ``dof_pad`` (read from every case, not only the split's).

Two views of a split: ``SludgePatternDataSet``, the benchmark's (host
samples in case order, batch size 1), and ``PlannedDataSet``, the
trainer's (shuffled once, ``DeviceBatch``es of ``batch_size`` cases on
the dataset's device).  Every training batch carries the level-0 tril
sites in feature order (``sites``, the rows, cols and valid of the
reference's ``batch.plans[0]``: what the NeuralFSAI plan provider reads).
``RandomSPDDataSet`` and ``StAnDataSet`` are the reference's other two
training sets, subclasses of ``PlannedDataSet``.

Given ``specs`` (a list of ``ConvSpec``s or an object with ``build``, see
``models.plan_builder_for``), either view builds every case's host plan
once and derives the split-global level buckets as the reference's
``PlannedDataSet._finalize`` does, through one helper (``ConvPlans``;
the seconds in ``plan_seconds``).  ``SludgePatternDataSet`` then serves
case ``index`` as a host ``ConvBatch`` (features, padded plans, scales;
batch size 1), which the benchmark suite moves to its device;
``PlannedDataSet``'s batches carry their members' padded, stacked
``plans`` on the data set's device.  Batches are built on first use and
kept.

Cases come from disk (``<family>/case_*/matrix.npz`` etc., the layout
``data/fvm.save_case`` writes; the family is ``sludge_patterns``,
``sludge_patterns_3d`` or ``frame_structures``) or from memory (a list of ``FVMCase``); both give
the same host samples.
"""

from __future__ import annotations

import random
import time
from pathlib import Path
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from deeppreconditioning_tpu_torch.ops.sparse_conv import (
    LayerPlan,
    build_sample_plan,
    pad_plans_by_level,
    stack_plans,
)
from deeppreconditioning_tpu_torch.sparse.coo import BatchedCOO

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


def _split_items(stage: str, root: Path, cases: Sequence | None,
                 family: str) -> Tuple[list, int]:
    """The split's items (``FVMCase``s or case folders, in case order) and
    ``dof_max`` over every case of the family."""
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
    return _split_folders(all_items, stage), dof_max


def _raw_case(item) -> tuple:
    """(rows, cols, vals, solution, rhs) of a case folder or an
    ``FVMCase``."""
    if isinstance(item, Path):
        return _read_case(item)
    m = item.matrix
    return m.row, m.col, m.data, item.solution, item.rhs


class ConvPlans:
    """Every sample's host conv plan of a split, kept, and the split's
    level buckets, as the reference's ``PlannedDataSet._finalize`` derives
    them: ``nnz0_pad`` is ``round_up(max nnz, 256)`` over the samples, each
    level's bucket its largest site count rounded up to 256, level 0's
    ``nnz0_pad``.  ``specs`` is a list of ``ConvSpec``s (a chain) or an
    object with ``build`` (``models.plan_builder_for``); ``seconds`` is
    the time of the builds."""

    def __init__(self, specs, host_samples: Sequence[_HostSample],
                 dof_pad: int) -> None:
        start = time.perf_counter()
        if hasattr(specs, "build"):
            build = specs.build
        else:
            specs = list(specs)

            def build(r, c, hw):
                return build_sample_plan(r, c, hw, specs)
        hw = (dof_pad, dof_pad)
        self.host = [build(h.rows, h.cols, hw) for h in host_samples]
        self.nnz0_pad = round_up(max(h.rows.shape[0] for h in host_samples),
                                 256)
        level_max = [max(sizes) for sizes in
                     zip(*(p.level_nnz for p in self.host))]
        level_max[0] = max(level_max[0], self.nnz0_pad)
        self.level_buckets = [round_up(m, 256) for m in level_max]
        self.level_buckets[0] = self.nnz0_pad
        self.seconds = time.perf_counter() - start

    def stacked(self, indices: Sequence[int]) -> Tuple[LayerPlan, ...]:
        """The plans of samples ``indices``, padded to the buckets and
        stacked: one batched ``LayerPlan`` per layer (CPU, int64)."""
        return tuple(stack_plans(pad_plans_by_level(
            [self.host[i] for i in indices], self.level_buckets)))


class ConvBatch(NamedTuple):
    """One case for a conv model (batch size 1)."""

    features: torch.Tensor  # (1, nnz0_pad, 1) scaled tril values, float32
    plans: Tuple[LayerPlan, ...]  # per layer, batched (1, ...)
    scales: torch.Tensor  # (1, dof_pad) diagonal D, float32

    def to(self, device) -> "ConvBatch":
        return ConvBatch(self.features.to(device),
                         tuple(p.to(device) for p in self.plans),
                         self.scales.to(device))


class SludgePatternDataSet:
    """Host samples of a split in case order (batch size 1, not shuffled:
    the benchmark's view of the split).

    ``cases``: in-memory ``FVMCase`` list in generation order; without it
    the cases are read from ``root / family / case_*``.
    ``dof_pad`` is ``round_up(dof_max, 128)`` with ``dof_max`` over every
    case.  With ``specs``, ``data_set[index]`` is case ``index``'s host
    ``ConvBatch``, its plans padded to the split's ``ConvPlans`` buckets
    (``nnz0_pad``, ``level_buckets``).
    """

    def __init__(
        self,
        stage: str,
        root: Path = ROOT,
        cases: Sequence | None = None,
        family: str = "sludge_patterns",
        specs=None,
    ) -> None:
        items, self.dof_max = _split_items(stage, root, cases, family)
        self.dof_pad = round_up(self.dof_max, 128)
        self._host = [_prepare_sample(*_raw_case(item), self.dof_pad)
                      for item in items]
        self.specs = specs
        self._batches: dict = {}
        if specs is not None:
            self._plans = ConvPlans(specs, self._host, self.dof_pad)
            self.nnz0_pad = self._plans.nnz0_pad
            self.level_buckets = self._plans.level_buckets
            self.plan_seconds = self._plans.seconds

    def __len__(self) -> int:
        return len(self._host)

    def host_sample(self, index: int) -> _HostSample:
        return self._host[index]

    def __getitem__(self, index: int) -> ConvBatch:
        if self.specs is None:
            raise TypeError("a data set without specs has no conv batches")
        if index < 0 or index >= len(self):
            raise IndexError(index)
        if index not in self._batches:
            h = self._host[index]
            feats = np.zeros((1, self.nnz0_pad, 1), np.float32)
            feats[0, :h.rows.shape[0], 0] = h.vals
            self._batches[index] = ConvBatch(
                torch.from_numpy(feats),
                self._plans.stacked([index]),
                torch.from_numpy(h.scale.astype(np.float32)[None]),
            )
        return self._batches[index]


class Sites(NamedTuple):
    """Level-0 tril sites of a batch in feature order, (B, nnz0_pad) each:
    the rows, cols and valid of the reference's ``batch.plans[0]``."""

    rows: torch.Tensor
    cols: torch.Tensor
    valid: torch.Tensor


class DeviceBatch(NamedTuple):
    """One training or validation batch on the dataset's device (apart
    from ``original_sizes``)."""

    features: torch.Tensor  # (B, nnz0_pad, 1) scaled tril values
    sites: Sites  # their (row, col) sites and valid mask
    systems: BatchedCOO  # scaled tril(A~), same site order as features
    solutions: torch.Tensor  # (B, dof_pad) solutions of the scaled systems
    right_hand_sides: torch.Tensor  # (B, dof_pad), scaled to match A~
    scales: torch.Tensor  # (B, dof_pad) diagonals D: A = D^1/2 A~ D^1/2
    original_sizes: Tuple[int, ...]  # true dofs
    index: int  # the batch's index in its data set
    # per layer, batched (B, ...) and padded to the data set's level
    # buckets; None without specs
    plans: Tuple[LayerPlan, ...] | None = None


class PlannedDataSet:
    """The trainer's view of a split: host samples, shuffled once with
    ``random.Random(seed)`` (the reference's folder shuffle), served as
    ``DeviceBatch``es of ``batch_size`` consecutive samples (a trailing
    partial batch is dropped).

    This class reads the sludge-pattern or frame cases (``family``) from
    ``root`` or ``cases``; ``order`` holds the split's case indices in
    batch order.  ``RandomSPDDataSet`` and ``StAnDataSet`` fill it with
    other systems.  ``nnz0_pad`` is ``round_up(max nnz, 256)`` over the
    split's samples, so every batch has one shape.  With ``specs`` (as
    ``SludgePatternDataSet``'s) every sample's conv plan is built once at
    construction (``plan_seconds``), the level buckets are taken over the
    whole split (``ConvPlans``: split views share them), and each batch
    carries its members' padded, stacked ``plans``.  Each batch is built
    on first use and kept for the data set's life, so it keeps its
    identity across epochs.
    """

    def __init__(
        self,
        stage: str,
        batch_size: int,
        root: Path = ROOT,
        cases: Sequence | None = None,
        family: str = "sludge_patterns",
        shuffle: bool = True,
        seed: int = 69,
        device="cpu",
        dtype: torch.dtype = torch.float32,
        specs=None,
    ) -> None:
        items, dof_max = _split_items(stage, root, cases, family)
        self.order = list(range(len(items)))
        if shuffle:
            random.Random(seed).shuffle(self.order)
        self.items = [items[i] for i in self.order]
        self._finalize([_raw_case(item) for item in self.items], dof_max,
                       batch_size, specs, device, dtype)

    def _finalize(self, raw: Sequence[tuple], dof_max: int, batch_size: int,
                  specs, device, dtype: torch.dtype) -> None:
        """Samples from raw (rows, cols, vals, solution, rhs) systems in
        batch order, and their plans with ``specs``."""
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.dtype = dtype
        self.dof_max = dof_max
        self.dof_pad = round_up(dof_max, 128)
        self._host = [_prepare_sample(*r, self.dof_pad) for r in raw]
        self.nnz0_pad = round_up(max(h.rows.shape[0] for h in self._host),
                                 256)
        self.specs = specs
        self._plans = None
        if specs is not None:
            self._plans = ConvPlans(specs, self._host, self.dof_pad)
            self.level_buckets = self._plans.level_buckets
            self.plan_seconds = self._plans.seconds
        self._batches: dict = {}

    def __len__(self) -> int:
        return len(self._host) // self.batch_size

    def host_sample(self, index: int) -> _HostSample:
        """The host sample of batch ``index``'s first member."""
        return self._host[index * self.batch_size]

    def __getitem__(self, index: int) -> DeviceBatch:
        if index < 0 or index >= len(self):
            raise IndexError(index)
        if index not in self._batches:
            self._batches[index] = self._build_batch(index)
        return self._batches[index]

    def _build_batch(self, index: int) -> DeviceBatch:
        span = range(index * self.batch_size, (index + 1) * self.batch_size)
        members = [self._host[i] for i in span]
        b, nnz0 = len(members), self.nnz0_pad
        feats = np.zeros((b, nnz0), np.float64)
        rows = np.zeros((b, nnz0), np.int64)
        cols = np.zeros((b, nnz0), np.int64)
        valid = np.zeros((b, nnz0), bool)
        idx_list = []
        for bi, h in enumerate(members):
            nnz = h.rows.shape[0]
            feats[bi, :nnz] = h.vals
            rows[bi, :nnz] = h.rows
            cols[bi, :nnz] = h.cols
            valid[bi, :nnz] = True
            idx_list.append(np.column_stack(
                (np.full(nnz, bi, np.int64), h.rows, h.cols)))
        systems = BatchedCOO.from_numpy(
            np.vstack(idx_list), np.concatenate([h.vals for h in members]),
            b, (self.dof_pad, self.dof_pad), bucket=nnz0, dtype=self.dtype,
            device=self.device,
        )

        def dev(x, dtype=None):
            return torch.as_tensor(x, dtype=dtype, device=self.device)

        plans = None
        if self._plans is not None:
            plans = tuple(p.to(self.device)
                          for p in self._plans.stacked(span))
        return DeviceBatch(
            features=dev(feats[..., None], self.dtype),
            sites=Sites(dev(rows), dev(cols), dev(valid)),
            systems=systems,
            solutions=dev(np.stack([h.solution for h in members]),
                          self.dtype),
            right_hand_sides=dev(np.stack([h.rhs for h in members]),
                                 self.dtype),
            scales=dev(np.stack([h.scale for h in members]), self.dtype),
            original_sizes=tuple(h.original_size for h in members),
            index=index,
            plans=plans,
        )


class RandomSPDDataSet(PlannedDataSet):
    """Random sparse SPD systems (the reference's ``RandomSPDDataSet``):
    A = B B^T + 1e-3 I with B strictly lower-triangular, ``(1 -
    sparsity)`` of its entries standard normal at random sites; x = 1,
    b = A x.  All ``length`` systems are drawn from
    ``np.random.default_rng(seed)`` in the reference's order; the first
    80% form the train split, the rest the test split, shuffled with
    ``random.Random(seed)``."""

    def __init__(
        self,
        stage: str,
        dof: int,
        batch_size: int,
        specs=None,
        sparsity: float = 0.99,
        length: int = 1000,
        shuffle: bool = True,
        seed: int = 69,
        device="cpu",
        dtype: torch.dtype = torch.float32,
    ) -> None:
        if not 0 < sparsity <= 1:
            raise ValueError(f"sparsity {sparsity} not in (0, 1]")
        if stage not in ("train", "test"):
            raise ValueError(f"Invalid stage {stage}")
        rng = np.random.default_rng(seed)
        cut = length * 80 // 100
        keep = range(cut) if stage == "train" else range(cut, length)
        tri_r, tri_c = np.tril_indices(dof, k=-1)
        n_off = int((1 - sparsity) * tri_r.shape[0])
        raw = []
        for i in range(length):
            sel = rng.choice(tri_r.shape[0], size=n_off, replace=False)
            bmat = np.zeros((dof, dof))
            bmat[tri_r[sel], tri_c[sel]] = rng.standard_normal(n_off)
            if i not in keep:
                continue
            a = bmat @ bmat.T + 1e-3 * np.eye(dof)
            x = np.ones(dof)
            r, c = np.nonzero(a)
            raw.append((r, c, a[r, c], x, a @ x))
        if shuffle:
            random.Random(seed).shuffle(raw)
        self._finalize(raw, dof, batch_size, specs, device, dtype)


def download_from_kaggle() -> None:
    """The StAn download of the reference: this package reaches no
    network, so it raises; mirror kaggle.com/datasets/zurutech/
    stand-small-problems into ``ROOT / "stand_small_{train,test}"``."""
    raise RuntimeError(
        "no network access: place the Kaggle StAn npz files under "
        "ROOT/stand_small_{train,test} by hand"
    )


class StAnDataSet(PlannedDataSet):
    """The Kaggle StAn frame-structure systems (the reference's
    ``StAnDataSet``) from ``root / stand_small_{stage} / *.npz`` (keys in
    order: indices (2, nnz), values, solution, rhs), files sorted then
    shuffled with ``random.Random(seed)``, the first ``limit`` kept;
    padded to the reference's ``DOF_MAX``."""

    DOF_MAX = 5166

    def __init__(
        self,
        stage: str,
        batch_size: int,
        specs=None,
        shuffle: bool = True,
        root: Path = ROOT,
        seed: int = 69,
        limit: int | None = None,
        device="cpu",
        dtype: torch.dtype = torch.float32,
    ) -> None:
        files = sorted(Path(root).glob(f"stand_small_{stage}/*.npz"))
        if not files:
            raise FileNotFoundError(
                f"no StAn files under {root}/stand_small_{stage}")
        if shuffle:
            random.Random(seed).shuffle(files)
        if limit:
            files = files[:limit]
        raw = []
        for f in files:
            with np.load(f) as z:
                indices, values, solution, rhs = (z[k] for k in list(z.keys()))
            raw.append((indices[0], indices[1], values, solution, rhs))
        self.files = files
        self._finalize(raw, self.DOF_MAX, batch_size, specs, device, dtype)
