"""Per-case preconditioner benchmark suite.

Counterpart of ``deeppreconditioning_tpu/bench/suite.py::BenchmarkSuite``'s
per-case protocol for the techniques vanilla, jacobi, fsai and learned
(NeuralFSAI).  Every technique competes on the RAW system rebuilt from the
dataset's scaled host sample; per case and technique it records kappa,
density %, PCG iterations, setup seconds, solve seconds, their total and
success %, and ``dump_csv`` writes the reference's table schema
``technique,kappas,densities,iterations,setups,durations,totals,successes``.

Timing: median of ``timing_reps`` synchronized runs after a warm-up
(``utils/profiling.time_call``: CUDA events on the card).  FSAI plans and
the dense scaled matrix are input preparation, built outside the timed
setup and cached, as in the reference.  A case whose pattern fits the
range-blocked plan takes it; any other case falls back to the generic
``FSAIPlan`` (``generic_cases`` records which, per technique).  As in the
reference, the generic classical setup computes in the value vector's
float32 whatever ``dtype`` is.
"""

from __future__ import annotations

import csv
from collections import OrderedDict
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import scipy.sparse as sp
import torch

from deeppreconditioning_tpu_torch import _backend
from deeppreconditioning_tpu_torch.models.neural_fsai import (
    NeuralFSAI,
    neural_fsai_dense_preconditioner,
)
from deeppreconditioning_tpu_torch.ops.fsai import (
    build_fsai_plan,
    build_range_fsai_plan,
    cap_pattern_spread,
    fsai_dense_preconditioner,
    fsai_dense_preconditioner_range,
    pattern_col_width,
    tril_power_pattern,
    tril_power_pattern_capped,
)
from deeppreconditioning_tpu_torch.ops.ic0 import jacobi_preconditioner
from deeppreconditioning_tpu_torch.solvers.cg import (
    dense_matvec,
    ell_matvec,
    identity_apply,
    preconditioned_conjugate_gradient,
)
from deeppreconditioning_tpu_torch.sparse.ell import ELLMatrix
from deeppreconditioning_tpu_torch.utils.profiling import time_call

RESULTS_DIRECTORY = Path("./assets/results/torch/")
TECHNIQUES = ("vanilla", "jacobi", "fsai", "learned")
TABLE_PARAMETERS = ["kappas", "densities", "iterations", "setups",
                    "durations", "totals", "successes"]


def _diag_apply(d, r):
    return d * r


@dataclass
class BenchmarkSuite:
    """Benchmark learned vs classical preconditioners on a test split.

    Args:
        data_set: ``data.datasets.SludgePatternDataSet`` (either family).
        model: ``NeuralFSAI`` (needed for 'learned'); moved to ``device``
            and ``dtype``.
        device: defaults to the card (``_backend.device()``, which raises
            without one); the CPU tests pass ``"cpu"``.
    """

    data_set: object
    model: NeuralFSAI | None = None
    techniques: tuple = TECHNIQUES
    max_iter: int = 1024
    rtol: float = 1e-8
    dtype: torch.dtype = torch.float32
    device: torch.device = field(default_factory=_backend.device)
    fsai_power: int = 4  # classical FSAI pattern tril(|A|^4)
    learned_power: int = 0  # NeuralFSAI pattern power; 0 -> fsai_power
    check_every: int = 8
    timing_reps: int = 3
    kappa_cases: int = 5  # dense kappa / spectrum for the leading cases
    results_directory: Path = RESULTS_DIRECTORY
    kappas: dict = field(default_factory=dict)
    densities: dict = field(default_factory=dict)
    iterations: dict = field(default_factory=dict)
    setups: dict = field(default_factory=dict)
    durations: dict = field(default_factory=dict)
    totals: dict = field(default_factory=dict)
    successes: dict = field(default_factory=dict)
    setup_calls: dict = field(default_factory=dict)  # device setups run
    generic_cases: dict = field(default_factory=dict)  # cases on FSAIPlan

    def __post_init__(self):
        unknown = set(self.techniques) - set(TECHNIQUES)
        if unknown:
            raise ValueError(f"techniques not ported: {sorted(unknown)}")
        self.device = torch.device(self.device)
        if "learned" in self.techniques:
            if not isinstance(self.model, NeuralFSAI):
                raise ValueError("'learned' needs a NeuralFSAI model")
            self.model = self.model.to(device=self.device, dtype=self.dtype)
            self.model.eval()
        for name in self.techniques:
            for store in (self.kappas, self.densities, self.iterations,
                          self.setups, self.durations, self.totals,
                          self.successes):
                store[name] = []
            self.setup_calls[name] = 0
            self.generic_cases[name] = set()
        self._meta_cache = {}
        self._plan_cache = OrderedDict()

    # -- system reconstruction -------------------------------------------
    def _reconstruct(self, index):
        """Rebuild the RAW system A = D^1/2 A~ D^1/2, b = D^1/2 b~ from the
        host sample, with values, scales and rhs rounded through float32
        first (the reference's device batch stores them in float32)."""
        h = self.data_set.host_sample(index)
        n0 = h.original_size
        vals = h.vals.astype(np.float32).astype(np.float64)
        d_sqrt = np.sqrt(h.scale.astype(np.float32).astype(np.float64))
        keep = (h.rows < n0) & (h.cols < n0)
        r, c, v = h.rows[keep], h.cols[keep], vals[keep]
        v = v * d_sqrt[r] * d_sqrt[c]
        off = r != c
        a_sp = sp.csr_matrix(
            (np.concatenate([v, v[off]]),
             (np.concatenate([r, c[off]]), np.concatenate([c, r[off]]))),
            shape=(n0, n0),
        )
        rhs = (h.rhs.astype(np.float32).astype(np.float64) * d_sqrt)[:n0]
        return a_sp, rhs, n0

    # -- preconditioner constructors -------------------------------------
    def _dense_stats(self, m, n0, need_dense):
        if need_dense:
            m_sp = sp.csr_matrix(m[:n0, :n0].double().cpu().numpy())
            return 100.0 * m_sp.nnz / (n0 * n0), m_sp
        return float(torch.count_nonzero(m)) * 100.0 / (n0 * n0), None

    def _setup_vanilla(self, index, a_sp, ell, need_dense, timing=False):
        if timing:
            return identity_apply, None, None, None
        n0 = a_sp.shape[0]
        return identity_apply, None, 100.0 * n0 / (n0 * n0), sp.eye(n0).tocsr()

    def _setup_jacobi(self, index, a_sp, ell, need_dense, timing=False):
        n0 = a_sp.shape[0]
        d = np.zeros(ell.n_pad)
        d[:n0] = jacobi_preconditioner(a_sp)
        d_dev = torch.tensor(d, dtype=self.dtype, device=self.device)
        self.setup_calls["jacobi"] += 1
        if timing:
            return _diag_apply, d_dev, None, None
        return _diag_apply, d_dev, 100.0 * n0 / (n0 * n0), sp.diags(d[:n0]).tocsr()

    def _fsai_meta(self, n_pad, power):
        """Dataset-global pattern metadata for one pattern power:
        (static column width, range height H, per-case patterns, spread
        cap).  Cases whose block row spread exceeds
        ``max(n_pad // 4, 128)`` do not set H.  When H > 128 and capping
        the pattern at row - col <= H - 136 drops at most 2% of the
        entries, the cap is applied and H lowered by 128."""
        if power in self._meta_cache:
            return self._meta_cache[power]
        ds_width, spread = 1, 1
        pats = {}
        spread_cap = max(n_pad // 4, 128)
        n_blocks = n_pad // 8
        for index in range(len(self.data_set)):
            h = self.data_set.host_sample(index)
            r0, c0 = h.rows.astype(np.int32), h.cols.astype(np.int32)
            pr, pc = tril_power_pattern(r0, c0, n_pad, power=power)
            ds_width = max(ds_width, pattern_col_width(pr, pc))
            lo = np.full(n_blocks, n_pad, np.int64)
            hi = np.full(n_blocks, -1, np.int64)
            np.minimum.at(lo, pc // 8, pr)
            np.maximum.at(hi, pc // 8, pr)
            present = hi >= 0
            case_spread = int((hi - lo + 1)[present].max(initial=1))
            if case_spread <= spread_cap:
                spread = max(spread, case_spread)
            pats[index] = (r0, c0, pr, pc)
        range_h = int(np.ceil(spread / 128) * 128)
        cap = None
        if range_h > 128:
            h_try = range_h - 128
            cap_try = h_try - 8  # a window of H holds spread + JB - 1
            total = sum(p[2].shape[0] for p in pats.values())
            beyond = sum(int(((p[2] - p[3]) > cap_try).sum())
                         for p in pats.values())
            if total and beyond <= 0.02 * total:
                pats = {i: (r0, c0, *cap_pattern_spread(pr, pc, cap_try))
                        for i, (r0, c0, pr, pc) in pats.items()}
                range_h, cap = h_try, cap_try
        self._meta_cache[power] = (ds_width, range_h, pats, cap)
        return self._meta_cache[power]

    def _fsai_plan(self, index, ell, width=None, power=None):
        """Per-case FSAI plan and its operand on the device, and float32
        scales: ``("range", RangeFSAIPlan, dense scaled A~)`` or, for a
        case whose pattern does not fit the range plan,
        ``("generic", FSAIPlan, scaled tril value vector)``; the operand
        is float32, as the reference stores it, whatever ``dtype`` is.  A
        small LRU cache, since a case's timing reps reuse them.
        ``width`` / ``power`` override the dataset-global width and the
        classical power (a NeuralFSAI checkpoint fixes both)."""
        power = self.fsai_power if power is None else power
        key = (index, width, power)
        cache = self._plan_cache
        if key in cache:
            cache.move_to_end(key)
            return cache[key]
        while len(cache) >= 4:
            cache.popitem(last=False)
        n_pad = ell.n_pad
        ds_width, range_h, pats, spread_cap = self._fsai_meta(n_pad, power)
        eff_width = ds_width if width is None else width
        r0, c0, pr, pc = pats[index]
        h = self.data_set.host_sample(index)
        if eff_width < pattern_col_width(pr, pc):
            # a trained width below the case's: keep the strongest
            # couplings per column instead of refusing the case
            pr, pc = tril_power_pattern_capped(
                r0, c0, h.vals.astype(np.float64), n_pad,
                power=power, width=eff_width,
            )
            if spread_cap is not None:
                pr, pc = cap_pattern_spread(pr, pc, spread_cap)
        scales = torch.tensor(h.scale, dtype=torch.float32, device=self.device)
        try:
            plan = build_range_fsai_plan(
                pr, pc, n_pad, width=eff_width, range_h=min(range_h, n_pad),
            )
        except ValueError:
            plan = build_fsai_plan(r0, c0, pr, pc, n_pad, width=eff_width)
            cache[key] = ("generic", plan.to(self.device), torch.tensor(
                h.vals, dtype=torch.float32, device=self.device), scales)
            return cache[key]
        a_d = np.zeros((n_pad, n_pad))
        a_d[r0, c0] = h.vals
        a_d = a_d + np.tril(a_d, -1).T
        cache[key] = ("range", plan.to(self.device), torch.tensor(
            a_d, dtype=torch.float32, device=self.device), scales)
        return cache[key]

    def _setup_fsai(self, index, a_sp, ell, need_dense, timing=False):
        n0 = a_sp.shape[0]
        kind, plan, operand, scales = self._fsai_plan(index, ell)
        if kind == "range":
            d_isqrt = 1.0 / torch.sqrt(scales.to(self.dtype))
            m = fsai_dense_preconditioner_range(
                plan, operand, d_isqrt=d_isqrt, n0=n0, dtype=self.dtype
            )
        else:
            self.generic_cases["fsai"].add(index)
            d_isqrt = 1.0 / torch.sqrt(scales.to(operand.dtype))
            m = fsai_dense_preconditioner(
                plan, operand, d_isqrt=d_isqrt, n0=n0, dtype=self.dtype
            )
        self.setup_calls["fsai"] += 1
        if timing:
            return dense_matvec, m, None, None
        return (dense_matvec, m, *self._dense_stats(m, n0, need_dense))

    def _setup_learned(self, index, a_sp, ell, need_dense, timing=False):
        n0 = a_sp.shape[0]
        kind, plan, operand, scales = self._fsai_plan(
            index, ell, width=self.model.width,
            power=self.learned_power or None,
        )
        if kind == "generic":
            self.generic_cases["learned"].add(index)
        m = neural_fsai_dense_preconditioner(
            self.model, plan, operand, scales, n0, dtype=self.dtype
        )
        self.setup_calls["learned"] += 1
        if timing:
            return dense_matvec, m, None, None
        return (dense_matvec, m, *self._dense_stats(m, n0, need_dense))

    # -- measurement ------------------------------------------------------
    def _solve(self, ell, b_dev, apply_m, m_data):
        return preconditioned_conjugate_gradient(
            ell_matvec, ell, b_dev, apply_m, m_data,
            rtol=self.rtol, max_iter=self.max_iter,
            check_every=self.check_every,
        )

    def _system(self, index):
        a_sp, rhs, n0 = self._reconstruct(index)
        ell = ELLMatrix.from_scipy(
            a_sp, n_pad=self.data_set.dof_pad, dtype=self.dtype,
            device=self.device,
        )
        b = np.zeros(ell.n_pad)
        b[:n0] = rhs
        return a_sp, ell, torch.tensor(b, dtype=self.dtype, device=self.device)

    def setup(self, name: str, index: int):
        """Technique ``name``'s preconditioner for case ``index``, built as
        the timed setup builds it: ``(apply_m, m_data)`` on the suite's
        device (``m_data`` is M for fsai / learned, the diagonal for
        jacobi, None for vanilla)."""
        a_sp, ell, _ = self._system(index)
        return getattr(self, f"_setup_{name}")(
            index, a_sp, ell, False, timing=True)[:2]

    @torch.no_grad()
    def run(self) -> None:
        eigenvalues = {}
        if len(self.data_set):
            # warm-up on case 0: first-touch allocations and library
            # handles stay out of the per-case timings
            _, ell0, b0 = self._system(0)
            for name in self.techniques:
                self._solve(ell0, b0, *self.setup(name, 0))
        for index in range(len(self.data_set)):
            a_sp, ell, b_dev = self._system(index)
            for name in self.techniques:
                need_dense = index < self.kappa_cases
                setup_fn = getattr(self, f"_setup_{name}")
                if name == "vanilla":
                    setup = 0.0
                else:
                    setup = time_call(
                        lambda: setup_fn(index, a_sp, ell, False,
                                         timing=True),
                        self.device, reps=self.timing_reps,
                    )
                # statistics pass, outside the timed region
                apply_m, m_data, density, m_sp = setup_fn(
                    index, a_sp, ell, need_dense
                )
                res = self._solve(ell, b_dev, apply_m, m_data)
                duration = time_call(
                    lambda: self._solve(ell, b_dev, apply_m, m_data),
                    self.device, reps=self.timing_reps, warmup=0,
                )

                if need_dense and m_sp is not None:
                    ma = (m_sp @ a_sp).toarray()
                    kappa = float(np.linalg.cond(ma))
                    if index == 0:
                        eigenvalues[name] = np.linalg.svd(
                            ma, compute_uv=False
                        ).tolist()
                else:
                    kappa = float("nan")

                success = float(res.residual) < self.rtol
                self.kappas[name].append(kappa)
                self.densities[name].append(float(density))
                self.iterations[name].append(int(res.iterations))
                self.setups[name].append(setup)
                self.durations[name].append(duration)
                self.totals[name].append(setup + duration)
                self.successes[name].append(100.0 * success)

            if index == 0 and eigenvalues:
                self.results_directory.mkdir(parents=True, exist_ok=True)
                with (self.results_directory
                      / "eigenvalues.csv").open("w") as fio:
                    writer = csv.writer(fio)
                    writer.writerow(eigenvalues.keys())
                    writer.writerows(zip(*eigenvalues.values()))

    def summary(self) -> dict:
        """Mean of every measured quantity per technique."""
        out = {}
        for name in self.techniques:
            kap = np.asarray(self.kappas[name], float)
            out[name] = {
                "kappa": (float(np.nanmean(kap))
                          if np.isfinite(kap).any() else float("nan")),
                "density": float(np.mean(self.densities[name])),
                "iterations": float(np.mean(self.iterations[name])),
                "setup": float(np.mean(self.setups[name])),
                "duration": float(np.mean(self.durations[name])),
                "total": float(np.mean(self.totals[name])),
                "success": float(np.mean(self.successes[name])),
            }
        return out

    def dump_csv(self) -> None:
        """table.csv + totals.csv in the reference's schema."""
        self.results_directory.mkdir(parents=True, exist_ok=True)
        with (self.results_directory / "table.csv").open("w") as fio:
            fio.write("technique," + ",".join(TABLE_PARAMETERS) + "\n")
            for technique in self.techniques:
                line = technique
                for parameter in TABLE_PARAMETERS:
                    vals = np.asarray(
                        getattr(self, parameter)[technique], dtype=float
                    )
                    mean = (float(np.nanmean(vals))
                            if np.isfinite(vals).any() else float("nan"))
                    line += "," + str(mean)
                fio.write(line + "\n")
        with (self.results_directory / "totals.csv").open("w") as fio:
            fio.write(",".join(self.techniques) + "\n")
            for index in range(len(self.totals[self.techniques[0]])):
                fio.write(",".join(
                    str(self.totals[t][index]) for t in self.techniques
                ) + "\n")
