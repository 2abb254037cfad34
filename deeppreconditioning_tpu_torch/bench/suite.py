"""Preconditioner benchmark suite: the per-case and the batched protocol.

Counterpart of ``deeppreconditioning_tpu/bench/suite.py::BenchmarkSuite``
for the reference's eight techniques: vanilla, jacobi, incomplete_cholesky
(IC(0), two level-scheduled triangular solves), incomplete_cholesky_neumann
(IC(0) through truncated Neumann sweeps), incomplete_lu (ICT(1, 0.1), the
same two solves), algebraic_multigrid (a V(1,1) cycle), fsai and learned
(bench.py's seven, ``TECHNIQUES``, are the default and the main path;
``ALL_TECHNIQUES`` adds incomplete_lu): NeuralFSAI, or a conv family
(``PreconditionerNet``, ``PreconditionerSparseUNet``) over the dataset's
conv plans, applied as a dense M = L L^T (``learned_apply="dense"``) or in
factor form z = L (L^T r) (``"factor"``, ``ops/factor_apply``).

Per case (``run``): every technique competes on the RAW system rebuilt
from the dataset's scaled host sample; per case and technique it records
kappa, density %, PCG iterations, setup seconds, solve seconds, their
total and success %, and ``dump_csv`` writes the reference's table schema
``technique,kappas,densities,iterations,setups,durations,totals,successes``.
The IC, ILU and AMG setups are host work (factorization and levels in
the host runtime, aggregation in numpy) plus their transfer to the card,
timed as such.

Timing: median of ``timing_reps`` synchronized runs after a warm-up
(``utils/profiling.time_call``: CUDA events on the card), one run for the
host-bound techniques (``HOST_BOUND_TECHNIQUES``: IC, IC-Neumann, ILU,
AMG).  FSAI plans and the dense scaled matrix are input preparation,
built outside the timed setup and cached, as in the reference.  A case
whose pattern fits the range-blocked plan takes it; any other case falls
back to the generic ``FSAIPlan`` (``generic_cases`` records which, per
technique).  As in the
reference, the generic classical setup computes in the value vector's
float32 whatever ``dtype`` is.  ``prep_seconds`` adds up that untimed
input preparation (pattern powers, plan builds), which bench.py reports
as ``input_prep_s``.  A conv model's index plans are the dataset's, built
with it; its factor-apply plans are built on first use, untimed
(``prep_seconds["plan"]``).

Batched (``run_batched``): the whole split at once per technique, one
setup over all cases and one fixed-trip PCG over the stacked dense scaled
systems (``_scaled_dense_matvec``), for vanilla, jacobi,
incomplete_cholesky_neumann (M = G^T G densified on the card),
algebraic_multigrid (the V-cycle composed densely), fsai (dense M) and
learned.  The learned M takes the reference's two routes
(``batched_learned_apply``): the factor in band form
(``ops/banded_factor``) while the split's band spread fits
``banded_spread_cap``, else the dense M from the group forward and the
polynomial wrap (the irregular split's permuted cases).  fsai and learned
group the cases by plan kind; each group's local solves are one B1
launch.  Each technique tries a bf16 M (or bf16 bands) first and falls
back to float32 unless every case converges; its trips are the warm-up
solve's slowest case + 2, and the counts come from the fixed-trip run.
A bf16 M is kept as its bf16-rounded values in float32 and multiplied
with the bf16-rounded vector, which gives the reference's float32 sum of
bf16 products.  Timing: the setup median of ``setup_reps`` builds after
the warm-up build (the solve uses that one), one build for the
host-bound ones (``HOST_BOUND_TECHNIQUES``); the
solve median of ``reps`` fixed-trip runs.  The dense learned build's
polynomial wrap runs on bf16 inputs with float32 sums on the bf16 attempt
and in full float32 on the float32 retry, so the retry rebuilds M.  As in
the reference, the batched learned technique takes NeuralFSAI only.
"""


from __future__ import annotations

import csv
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg  # noqa: F401  (sp.linalg)
import torch

from deeppreconditioning_tpu_torch import _backend
from deeppreconditioning_tpu_torch.models import CONV_MODELS
from deeppreconditioning_tpu_torch.models.neural_fsai import (
    NeuralFSAI,
    neural_fsai_dense_preconditioner,
)
from deeppreconditioning_tpu_torch.models.precond_net import output_to_dense
from deeppreconditioning_tpu_torch.ops.amg import (
    _aggregate,
    _prolongation,
    amg_apply,
    build_amg,
)
from deeppreconditioning_tpu_torch.ops.factor_apply import (
    build_factor_apply_plan,
    factor_normal_apply,
    pattern_widths,
)
from deeppreconditioning_tpu_torch.ops.banded_factor import (
    band_spread,
    extract_bands,
    make_banded_poly_apply,
)
from deeppreconditioning_tpu_torch.ops.fsai import (
    RangeFSAIPlan,
    build_fsai_plan,
    build_range_fsai_plan,
    cap_pattern_spread,
    fsai_dense_preconditioner,
    fsai_dense_preconditioner_range,
    pattern_col_width,
    range_strips_uniform,
    round_bf16,
    stack_plans,
    strips_to_bands,
    take_cases,
    tril_power_pattern,
    tril_power_pattern_capped,
    window_vector,
)
from deeppreconditioning_tpu_torch.ops.ic0 import (
    ic0_factor,
    ict_factor,
    jacobi_preconditioner,
)
from deeppreconditioning_tpu_torch.ops.trisolve import (
    build_tri_neumann,
    build_tri_schedule,
    ic_apply,
    neumann_ic_apply,
    transpose_schedule,
)
from deeppreconditioning_tpu_torch.solvers.cg import (
    batched_pcg_fixed_trips,
    batched_preconditioned_conjugate_gradient,
    dense_matvec,
    ell_matvec,
    identity_apply,
    preconditioned_conjugate_gradient,
)
from deeppreconditioning_tpu_torch.sparse.ell import ELLMatrix
from deeppreconditioning_tpu_torch.utils.profiling import time_call

RESULTS_DIRECTORY = Path("./assets/results/torch/")
# bench.py's seven: the suite's default and the main path's
TECHNIQUES = ("vanilla", "jacobi", "incomplete_cholesky",
              "incomplete_cholesky_neumann", "algebraic_multigrid",
              "fsai", "learned")
# the reference's eight (its test stage's ``--techniques all``)
ALL_TECHNIQUES = ("vanilla", "jacobi", "incomplete_cholesky",
                  "incomplete_cholesky_neumann", "incomplete_lu",
                  "algebraic_multigrid", "fsai", "learned")
# timed once per case (per case) or per technique (batched setup): their
# setups are host work (IC(0), ICT, levels, aggregation), and the
# level-scheduled IC solve (~120 waves of eager launches per apply) is the
# slowest technique
HOST_BOUND_TECHNIQUES = frozenset({"incomplete_cholesky",
                                   "incomplete_cholesky_neumann",
                                   "incomplete_lu",
                                   "algebraic_multigrid"})
TABLE_PARAMETERS = ["kappas", "densities", "iterations", "setups",
                    "durations", "totals", "successes"]
BATCHED_KEYS = ["iterations", "iterations_max", "trips", "setup_batch",
                "solve_batch", "total_batch", "per_case_total",
                "per_case_solve", "success", "cases"]


def _diag_apply(d, r):
    return d * r


def _tri_apply(md, r):
    return ic_apply(md[0], md[1], r)


def _neumann_apply(md, r):
    return neumann_ic_apply(md, r)


def _amg_apply(md, r):
    return amg_apply(md, r)


def _learned_factor_values(model, features, plans, scales, n0: int,
                           dtype=torch.float32):
    """Conv forward -> the effective L values in factor form: L_eff[i, j] =
    D_i^-1/2 L~[i, j] for i, j < n0, else 0."""
    values = model(features.to(dtype), plans)[0]
    rows, cols = plans[-1].rows[0], plans[-1].cols[0]
    d_isqrt = 1.0 / torch.sqrt(scales[0].to(dtype))
    return values * d_isqrt[rows] * ((rows < n0) & (cols < n0))


def _learned_setup_device(model, features, plans, scales, n0: int,
                          dtype=torch.float32):
    """Conv forward -> the dense effective preconditioner on the RAW
    system, M = L_eff L_eff^T with L_eff = D^-1/2 L~ masked to the live
    block (the reference's row mask and column mask with its diagonal
    exception, which reaches live rows only).  Conv dilation activates
    sites past n0; left in, they would make CG iterate on a singular
    padded subspace."""
    values = model(features.to(dtype), plans)
    n = scales.shape[1]
    d_isqrt = 1.0 / torch.sqrt(scales[0].to(dtype))
    l_eff = d_isqrt[:, None] * output_to_dense(values, plans[-1], n)[0]
    live = torch.arange(n, device=l_eff.device) < n0
    l_eff = torch.where(live[:, None] & live[None, :], l_eff, 0.0)
    return l_eff @ l_eff.T


# -- batched applies and setups ------------------------------------------------


def _bmv(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(B, n, n) @ (B, n) -> (B, n)."""
    return torch.bmm(m, x[..., None])[..., 0]


def _scaled_dense_matvec(a_data, x):
    """Batched RAW-system matvec from the stacked dense SCALED matrix:
    A = D^1/2 A~ D^1/2, so y = d_sqrt * (A~ @ (d_sqrt * x)), in full
    float32 (TF32 off)."""
    a_tilde, d_sqrt = a_data
    return d_sqrt * _bmv(a_tilde, d_sqrt * x)


def _scaled_dense_matvec_fast(a_data, r):
    """The bf16 attempt's matvec inside the banded apply: A~ (held in
    ``a_data`` already rounded to bf16) times the bf16-rounded d_sqrt * r,
    summed in float32 (the reference's single bf16 pass)."""
    a_round, d_sqrt = a_data
    return d_sqrt * _bmv(a_round, round_bf16(d_sqrt * r))


def _dense_apply_batched(m, r):
    """z = M r for every case, float32 M."""
    return _bmv(m, r)


def _dense_apply_batched_bf16(m, r):
    """z = M r for a bf16 M (held as its rounded values): the products
    of bf16 M and bf16 r, exact in float32, summed in float32."""
    return _bmv(m, round_bf16(r))


def _jacobi_setup_batched(d_sqrt, n0s):
    """1/diag(A) per case: the raw diagonal is d_sqrt^2 (the scaled
    system has a unit diagonal)."""
    live = torch.arange(d_sqrt.shape[1], device=d_sqrt.device) < n0s[:, None]
    return torch.where(live, 1.0 / (d_sqrt * d_sqrt), 0.0)


def _live_pairs(n_pad: int, n0s: torch.Tensor) -> torch.Tensor:
    live = torch.arange(n_pad, device=n0s.device) < n0s[:, None]
    return live[:, :, None] & live[:, None, :]


def _neumann_dense_setup(l_dense, n0s, sweeps: int):
    """Dense truncated-Neumann IC: G = P(L) ~ L^-1 by ``sweeps`` matrix
    Jacobi iterations G <- D^-1 (I - E G) (E the strict lower part), then
    M = G^T G, for every case."""
    n_pad = l_dense.shape[-1]
    d = torch.diagonal(l_dense, dim1=-2, dim2=-1)
    live = torch.arange(n_pad, device=l_dense.device) < n0s[:, None]
    inv_d = torch.where(live, 1.0 / torch.where(d == 0, 1.0, d), 0.0)
    e = torch.tril(l_dense, -1)
    eye = torch.eye(n_pad, dtype=l_dense.dtype, device=l_dense.device)
    g = inv_d[:, :, None] * eye
    for _ in range(sweeps):
        g = inv_d[:, :, None] * (eye - torch.bmm(e, g))
    g = torch.where(_live_pairs(n_pad, n0s), g, 0.0)
    return torch.bmm(g.transpose(1, 2), g)


def _neumann_coo_setup(rows, cols, vals, n0s, n_pad: int, sweeps: int,
                       dtype):
    """Densify each case's IC(0) factor from its padded COO triplets
    (sentinel n_pad drops the padding; 1 on the diagonal past n0), then
    ``_neumann_dense_setup``."""
    b = rows.shape[0]
    flat = torch.where((rows < n_pad) & (cols < n_pad), rows * n_pad + cols,
                       n_pad * n_pad)
    l_flat = torch.zeros(b, n_pad * n_pad + 1, dtype=dtype,
                         device=vals.device)
    l_flat.scatter_add_(1, flat, vals.to(dtype))
    l_dense = l_flat[:, :-1].reshape(b, n_pad, n_pad)
    dead = torch.arange(n_pad, device=vals.device) >= n0s[:, None]
    l_dense = l_dense + torch.diag_embed(dead.to(dtype))
    return _neumann_dense_setup(l_dense, n0s, sweeps)


def _amg_dense_compose(a_tilde, d_sqrt, n0s, p, mc, omega=0.67):
    """The V(1,1)-cycle of a one-level hierarchy with a dense root as a
    dense operator per case,

        M = W + (I - W A) (W + P Mc P^T (I - A W)),   W = omega D^-1,

    amg_apply's algebra (pre-smooth, coarse correction, post-smooth)."""
    a = a_tilde * (d_sqrt[:, :, None] * d_sqrt[:, None, :])
    n_pad = a.shape[-1]
    live = torch.arange(n_pad, device=a.device) < n0s[:, None]
    w = torch.where(live, omega / (d_sqrt * d_sqrt), 0.0)
    pm = torch.bmm(torch.bmm(p, mc), p.transpose(1, 2))
    aw = a * w[:, None, :]
    diag_w = torch.diag_embed(w)
    x2 = diag_w + pm - torch.bmm(pm, aw)
    m = diag_w + x2 - w[:, :, None] * torch.bmm(a, x2)
    return torch.where(_live_pairs(n_pad, n0s), m, 0.0)


def _fsai_dense_setup_group(plan, operands, scales, n0s, dtype):
    """Classical FSAI for a group of cases: the local solves of every
    case in one B1 launch, then each dense M on the raw system."""
    d_isqrt = 1.0 / torch.sqrt(scales.to(dtype))
    if isinstance(plan, RangeFSAIPlan):
        return fsai_dense_preconditioner_range(plan, operands, d_isqrt, n0s,
                                               dtype=dtype)
    return fsai_dense_preconditioner(plan, operands.to(dtype), d_isqrt, n0s,
                                     dtype=dtype)


def _learned_banded_setup_group(model, plan, operands, scales, n0s,
                                d_max: int, dtype):
    """NeuralFSAI for a group of cases in band form: the group forward
    (one B1 launch), the scaling fold and the padding masks, then the
    bands (B, d_max, n_pad) and q (B, degree + 1)."""
    out = model(plan, operands.to(dtype))
    d_isqrt = 1.0 / torch.sqrt(scales.to(dtype))
    if not isinstance(plan, RangeFSAIPlan):
        bands = extract_bands(plan.out_rows, out.c_vals, d_max,
                              d_isqrt=d_isqrt, n0=n0s)
        return bands, out.q_coeffs.to(dtype)
    n_pad, jb, h = plan.n_pad, plan.block_cols, plan.h
    n0 = n0s.reshape(-1, 1, 1)
    cols = torch.arange(n_pad, device=n0s.device)[:, None]
    vals = out.c_vals * ((plan.out_rows < n_pad) & (cols < n0)).to(dtype)
    strips = range_strips_uniform(plan, vals)
    rows_iota = (jb * torch.arange(n_pad // jb, device=n0s.device)[:, None]
                 + torch.arange(h, device=n0s.device)[None, :])
    d_win = window_vector(d_isqrt, jb, h) * (rows_iota < n0).to(dtype)
    strips = strips * d_win[..., :, None, :]
    return strips_to_bands(strips, jb, d_max), out.q_coeffs.to(dtype)


@dataclass
class BenchmarkSuite:
    """Benchmark learned vs classical preconditioners on a test split.

    Args:
        data_set: ``data.datasets.SludgePatternDataSet`` (any family; built
            with the conv model's ``specs`` for a conv model).
        model: ``NeuralFSAI``, ``PreconditionerNet`` or
            ``PreconditionerSparseUNet`` (needed for 'learned'); moved to
            ``device`` and ``dtype``.
        learned_apply: a conv model's apply, ``"dense"`` or ``"factor"``.
        batched_learned_apply: the batched learned route, ``"banded"``,
            ``"dense"`` or ``"auto"`` (band form while the split's band
            spread is at most ``banded_spread_cap``, as the reference).
        device: defaults to the card (``_backend.device()``, which raises
            without one); the CPU tests pass ``"cpu"``.
    """

    data_set: object
    model: torch.nn.Module | None = None
    techniques: tuple = TECHNIQUES
    learned_apply: str = "dense"
    batched_learned_apply: str = "auto"
    banded_spread_cap: int = 512  # the band form's widest spread in "auto"
    max_iter: int = 1024
    rtol: float = 1e-8
    dtype: torch.dtype = torch.float32
    device: torch.device = field(default_factory=_backend.device)
    fsai_power: int = 4  # classical FSAI pattern tril(|A|^4)
    learned_power: int = 0  # NeuralFSAI pattern power; 0 -> fsai_power
    ic_neumann_sweeps: int = 8  # truncated-Neumann IC apply order
    check_every: int = 8
    timing_reps: int = 3  # per case; once for HOST_BOUND_TECHNIQUES
    kappa_cases: int = 5  # dense kappa / spectrum for the leading cases
    results_directory: Path = RESULTS_DIRECTORY
    kappas: dict = field(default_factory=dict)
    densities: dict = field(default_factory=dict)
    iterations: dict = field(default_factory=dict)
    setups: dict = field(default_factory=dict)
    durations: dict = field(default_factory=dict)
    totals: dict = field(default_factory=dict)
    successes: dict = field(default_factory=dict)
    setup_calls: dict = field(default_factory=dict)  # per-case setups run
    generic_cases: dict = field(default_factory=dict)  # cases on FSAIPlan
    prep_seconds: dict = field(default_factory=dict)  # untimed input prep
    batched: dict = field(default_factory=dict)  # run_batched's records
    batched_builds: dict = field(default_factory=dict)  # batched setups run
    batched_launch_groups: dict = field(default_factory=dict)  # B1 launches
    # per batched build: the chunks of every plan group
    batched_routes: dict = field(default_factory=dict)  # the learned
    # route taken ("banded" / "dense") and the split's band spread (None
    # where "dense" is forced)

    _BATCHED_CHECK_EVERY = {
        "vanilla": 32, "jacobi": 32,
        "incomplete_cholesky_neumann": 8,
        "algebraic_multigrid": 4,
        "fsai": 8, "learned": 4,
    }

    def __post_init__(self):
        unknown = set(self.techniques) - set(ALL_TECHNIQUES)
        if unknown:
            raise ValueError(f"techniques not ported: {sorted(unknown)}")
        self.device = torch.device(self.device)
        if self.learned_apply not in ("dense", "factor"):
            raise ValueError(f"learned_apply {self.learned_apply!r}")
        if self.batched_learned_apply not in ("auto", "banded", "dense"):
            raise ValueError(
                f"batched_learned_apply {self.batched_learned_apply!r}")
        if "learned" in self.techniques:
            if not isinstance(self.model, (NeuralFSAI, *CONV_MODELS)):
                raise ValueError("'learned' needs a NeuralFSAI or conv model")
            if isinstance(self.model, NeuralFSAI):
                if self.learned_apply != "dense":
                    raise ValueError("NeuralFSAI takes the dense apply only")
            elif getattr(self.data_set, "specs", None) is None:
                raise ValueError("a conv model needs a data set built with "
                                 "its specs")
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
        self._bat_cache = None
        self._bat_fsai = {}
        self._conv_batches = {}
        self._factor_plans = {}
        self._factor_widths = None

    def _add_prep(self, stage: str, seconds: float) -> None:
        """Accumulate untimed input preparation (pattern powers, plan
        builds) under ``stage``."""
        self.prep_seconds[stage] = self.prep_seconds.get(stage, 0.0) + seconds

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

    def _tri_setup(self, name, l, ell, need_dense, timing):
        """A host factor L applied as z = L^-T L^-1 r by two
        level-scheduled triangular solves on the device."""
        lower = build_tri_schedule(l, n_pad=ell.n_pad).to(self.device,
                                                            self.dtype)
        upper = transpose_schedule(l, n_pad=ell.n_pad).to(self.device,
                                                           self.dtype)
        self.setup_calls[name] += 1
        if timing:
            return _tri_apply, (lower, upper), None, None
        n0 = l.shape[0]
        m_sp = None
        if need_dense:  # M = L^-T L^-1 materialized for kappa only
            linv = sp.linalg.spsolve_triangular(l.tocsr(), np.eye(n0),
                                                lower=True)
            m_sp = sp.csr_matrix(linv.T @ linv)
        return _tri_apply, (lower, upper), 100.0 * l.nnz / (n0 * n0), m_sp

    def _setup_incomplete_cholesky(self, index, a_sp, ell, need_dense,
                                   timing=False):
        """IC(0) on the host, applied by the two triangular solves."""
        return self._tri_setup("incomplete_cholesky", ic0_factor(a_sp), ell,
                               need_dense, timing)

    def _setup_incomplete_lu(self, index, a_sp, ell, need_dense,
                             timing=False):
        """The reference's ILUT analog: for SPD input the ILU factors are
        the ICT pair (L, L^T), ICT(add_fill_in 1, threshold 0.1) on the
        host, applied by the two triangular solves."""
        return self._tri_setup(
            "incomplete_lu", ict_factor(a_sp, add_fill_in=1, threshold=0.1),
            ell, need_dense, timing)

    def _setup_incomplete_cholesky_neumann(self, index, a_sp, ell,
                                           need_dense, timing=False):
        """IC(0) applied by ``ic_neumann_sweeps`` Neumann sweeps on L and
        on L^T (SPD, so PCG-safe)."""
        l = ic0_factor(a_sp)
        op = build_tri_neumann(l, sweeps=self.ic_neumann_sweeps,
                               n_pad=ell.n_pad).to(self.device, self.dtype)
        self.setup_calls["incomplete_cholesky_neumann"] += 1
        if timing:
            return _neumann_apply, op, None, None
        n0 = a_sp.shape[0]
        m_sp = None
        if need_dense:  # M's columns: the apply of the identity's rows
            eye = torch.eye(ell.n_pad, dtype=self.dtype, device=self.device)
            m_cols = neumann_ic_apply(op, eye).double().cpu().numpy()
            m_sp = sp.csr_matrix(m_cols.T[:n0, :n0])
        return _neumann_apply, op, 100.0 * l.nnz / (n0 * n0), m_sp

    def _setup_algebraic_multigrid(self, index, a_sp, ell, need_dense,
                                   timing=False):
        """Aggregation AMG: the host hierarchy (``ops/amg.build_amg``) and
        its V(1,1)-cycle on the device."""
        m = build_amg(a_sp, n_pad=ell.n_pad, dtype=self.dtype,
                      device=self.device)
        self.setup_calls["algebraic_multigrid"] += 1
        if timing:
            return _amg_apply, m, None, None
        n0 = a_sp.shape[0]
        nc = m.coarse_inv.shape[0]
        m_sp = None
        if need_dense:
            eye = torch.eye(ell.n_pad, dtype=self.dtype, device=self.device)
            m_sp = sp.csr_matrix(np.column_stack([
                amg_apply(m, eye[j])[:n0].double().cpu().numpy()
                for j in range(n0)]))
        return (_amg_apply, m, 100.0 * (a_sp.nnz + nc * nc) / (n0 * n0),
                m_sp)

    def _fsai_meta(self, n_pad, power):
        """Dataset-global pattern metadata for one pattern power:
        (static column width, range height H, per-case patterns, spread
        cap).  Cases whose block row spread exceeds
        ``max(n_pad // 4, 128)`` do not set H.  When H > 128 and capping
        the pattern at row - col <= H - 136 drops at most 2% of the
        entries, the cap is applied and H lowered by 128."""
        if power in self._meta_cache:
            return self._meta_cache[power]
        prep_start = time.perf_counter()
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
        self._add_prep("pattern", time.perf_counter() - prep_start)
        return self._meta_cache[power]

    def _case_pattern(self, index, n_pad, power, width):
        """Case ``index``'s pattern at ``power`` for a plan of ``width``:
        the dataset's, or, for a width below the case's, the strongest
        couplings per column (spread-capped as the dataset's)."""
        _, _, pats, spread_cap = self._fsai_meta(n_pad, power)
        r0, c0, pr, pc = pats[index]
        if width < pattern_col_width(pr, pc):
            pr, pc = tril_power_pattern_capped(
                r0, c0, self.data_set.host_sample(index).vals.astype(
                    np.float64), n_pad, power=power, width=width)
            if spread_cap is not None:
                pr, pc = cap_pattern_spread(pr, pc, spread_cap)
        return r0, c0, pr, pc

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
        ds_width, range_h, _, _ = self._fsai_meta(n_pad, power)
        prep_start = time.perf_counter()
        eff_width = ds_width if width is None else width
        r0, c0, pr, pc = self._case_pattern(index, n_pad, power, eff_width)
        h = self.data_set.host_sample(index)
        scales = torch.tensor(h.scale, dtype=torch.float32, device=self.device)
        try:
            plan = build_range_fsai_plan(
                pr, pc, n_pad, width=eff_width, range_h=min(range_h, n_pad),
            )
        except ValueError:
            plan = build_fsai_plan(r0, c0, pr, pc, n_pad, width=eff_width)
            cache[key] = ("generic", plan.to(self.device), torch.tensor(
                h.vals, dtype=torch.float32, device=self.device), scales)
        else:
            a_d = np.zeros((n_pad, n_pad))
            a_d[r0, c0] = h.vals
            a_d = a_d + np.tril(a_d, -1).T
            cache[key] = ("range", plan.to(self.device), torch.tensor(
                a_d, dtype=torch.float32, device=self.device), scales)
        self._add_prep("plan", time.perf_counter() - prep_start)
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
        if not isinstance(self.model, NeuralFSAI):
            return self._setup_learned_conv(index, a_sp, ell, need_dense,
                                            timing)
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

    def _conv_batch(self, index):
        """Case ``index``'s ``ConvBatch`` on the device, moved once."""
        if index not in self._conv_batches:
            self._conv_batches[index] = self.data_set[index].to(self.device)
        return self._conv_batches[index]

    def _learned_widths(self):
        """Dataset-global (w_lower, w_upper) of the final-plan patterns."""
        if self._factor_widths is None:
            w_l, w_u = 1, 1
            for index in range(len(self.data_set)):
                fin = self.data_set[index].plans[-1]
                wl, wu = pattern_widths(*(t[0].numpy() for t in fin[1:]))
                w_l, w_u = max(w_l, wl), max(w_u, wu)
            self._factor_widths = (w_l, w_u)
        return self._factor_widths

    def _learned_plan(self, index, ell):
        """Case ``index``'s ``FactorApplyPlan`` on the device and its L
        pattern on the host (rows, cols, valid): pattern-only input prep,
        built once, untimed."""
        if index not in self._factor_plans:
            widths = self._learned_widths()
            prep_start = time.perf_counter()
            rows, cols, valid = (t[0].numpy()
                                 for t in self.data_set[index].plans[-1][1:])
            plan = build_factor_apply_plan(rows, cols, valid, ell.n_pad,
                                           widths=widths)
            self._factor_plans[index] = (plan.to(self.device),
                                         (rows, cols, valid))
            self._add_prep("plan", time.perf_counter() - prep_start)
        return self._factor_plans[index]

    def _setup_learned_conv(self, index, a_sp, ell, need_dense,
                            timing=False):
        """A conv model's learned technique: the dense M (``z = M r``) or
        the factor values (``z = L (L^T r)``)."""
        n0 = a_sp.shape[0]
        batch = self._conv_batch(index)
        m = None
        if self.learned_apply == "factor":
            plan, (rows, cols, valid) = self._learned_plan(index, ell)
            vals = _learned_factor_values(self.model, batch.features,
                                          batch.plans, batch.scales, n0,
                                          dtype=self.dtype)
            apply_m, m_data = factor_normal_apply, (plan, vals)
        else:
            m = _learned_setup_device(self.model, batch.features,
                                      batch.plans, batch.scales, n0,
                                      dtype=self.dtype)
            apply_m, m_data = dense_matvec, m
        self.setup_calls["learned"] += 1
        if timing:
            return apply_m, m_data, None, None
        if m is not None:
            return (apply_m, m_data, *self._dense_stats(m, n0, need_dense))
        if need_dense:  # factor form: M materialized for kappa only
            m = _learned_setup_device(self.model, batch.features,
                                      batch.plans, batch.scales, n0,
                                      dtype=self.dtype)
            return (apply_m, m_data, *self._dense_stats(m, n0, True))
        # else the density of L L^T's pattern
        keep = valid & (rows < n0) & (cols < n0)
        l_pat = sp.csr_matrix((np.ones(int(keep.sum())),
                               (rows[keep], cols[keep])), shape=(n0, n0))
        return apply_m, m_data, 100.0 * (l_pat @ l_pat.T).nnz / (n0 * n0), None

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
        device (``m_data`` is M for fsai / learned, (factor-apply plan, L
        values) for a conv model's factor apply, the diagonal for
        jacobi, the triangular schedules, Neumann operator or AMG
        hierarchy for the IC and AMG techniques, None for vanilla)."""
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
                reps = (1 if name in HOST_BOUND_TECHNIQUES
                        else self.timing_reps)
                if name == "vanilla":
                    setup = 0.0
                else:
                    setup = time_call(
                        lambda: setup_fn(index, a_sp, ell, False,
                                         timing=True),
                        self.device, reps=reps,
                    )
                # statistics pass, outside the timed region
                apply_m, m_data, density, m_sp = setup_fn(
                    index, a_sp, ell, need_dense
                )
                res = self._solve(ell, b_dev, apply_m, m_data)
                duration = time_call(
                    lambda: self._solve(ell, b_dev, apply_m, m_data),
                    self.device, reps=reps, warmup=0,
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

    # -- batched protocol -------------------------------------------------
    def _batched_common(self):
        """The stacked split (host prep, cached): dense scaled A~, scale
        vectors, rhs, n0 on the device, and the raw CSR systems (for the
        host factorizations)."""
        if self._bat_cache is not None:
            return self._bat_cache
        n_cases = len(self.data_set)
        n_pad = self.data_set.dof_pad
        a_tildes = np.zeros((n_cases, n_pad, n_pad), np.float32)
        d_sqrts = np.zeros((n_cases, n_pad), np.float32)
        bs = np.zeros((n_cases, n_pad), np.float32)
        n0s = np.zeros(n_cases, np.int64)
        a_sps = []
        for index in range(n_cases):
            h = self.data_set.host_sample(index)
            a_sp, rhs, n0 = self._reconstruct(index)
            tril = a_tildes[index]
            tril[h.rows, h.cols] = h.vals
            a_tildes[index] += np.tril(tril, -1).T
            d_sqrts[index] = np.sqrt(h.scale.astype(np.float32))
            bs[index, :n0] = rhs
            n0s[index] = n0
            a_sps.append(a_sp)

        def t(x):
            return torch.as_tensor(x, device=self.device).to(self.dtype)

        self._bat_cache = {
            "a_tilde": t(a_tildes), "d_sqrt": t(d_sqrts), "b": t(bs),
            "n0": torch.as_tensor(n0s, device=self.device),
            "n_pad": n_pad, "a_sps": a_sps,
        }
        return self._bat_cache

    def _batched_fsai_inputs(self, power, width):
        """The split's FSAI plans for the batched setups, grouped by kind
        (untimed input prep, cached): a list of ``(idx, plan_group,
        operands, kind)``, range plans with static window starts first
        (operand: the common dense A~), then generic plans (operands:
        their float32 value vectors, zero-padded to one length)."""
        key = (power, width)
        if key in self._bat_fsai:
            return self._bat_fsai[key]
        common = self._batched_common()
        n_pad = common["n_pad"]
        _, range_h, _, _ = self._fsai_meta(n_pad, power)
        prep_start = time.perf_counter()
        sentinel = max(self.data_set.host_sample(i).rows.shape[0]
                       for i in range(len(self.data_set)))
        by_kind = {"range": [], "generic": []}
        for index in range(len(self.data_set)):
            r0, c0, pr, pc = self._case_pattern(index, n_pad, power, width)
            try:
                plan = build_range_fsai_plan(
                    pr, pc, n_pad, width=width,
                    range_h=min(range_h, n_pad), static_lo=True,
                )
                by_kind["range"].append((index, plan, None))
            except ValueError:
                plan = build_fsai_plan(r0, c0, pr, pc, n_pad, width=width,
                                       sentinel=sentinel)
                vals = self.data_set.host_sample(index).vals
                l0 = np.zeros(sentinel, np.float32)
                l0[:vals.shape[0]] = vals
                by_kind["generic"].append((index, plan, l0))
        groups = []
        for kind, items in by_kind.items():
            if not items:
                continue
            idx = torch.tensor([i for i, _, _ in items], device=self.device)
            plans = stack_plans([p for _, p, _ in items]).to(self.device)
            operands = (None if kind == "range" else torch.as_tensor(
                np.stack([o for _, _, o in items]),
                device=self.device).to(self.dtype))
            groups.append((idx, plans, operands, kind))
        self._bat_fsai[key] = groups
        self._add_prep("plan", time.perf_counter() - prep_start)
        return groups

    def _group_chunks(self, groups, chunk):
        """(sel, plan, operands) per chunk of every group."""
        common = self._batched_common()
        for idx, plans, operands, kind in groups:
            for lo in range(0, idx.shape[0], chunk):
                hi = min(lo + chunk, idx.shape[0])
                sel = idx[lo:hi]
                ops = (common["a_tilde"][sel] if kind == "range"
                       else operands[lo:hi])
                yield sel, take_cases(plans, slice(lo, hi)), ops

    def _dense_m_from_groups(self, groups, chunk, setup_fn):
        """A dense-M setup over the plan groups, chunked; the (B, n, n)
        stack in case order."""
        common = self._batched_common()
        n_pad = common["n_pad"]
        out = torch.zeros(len(self.data_set), n_pad, n_pad, dtype=self.dtype,
                          device=self.device)
        for sel, plans, ops in self._group_chunks(groups, chunk):
            out[sel] = setup_fn(plans, ops, common["d_sqrt"][sel] ** 2,
                                common["n0"][sel])
        return out

    def _batched_setup(self, name, setup_reps, chunk, m_dtype=None):
        """One technique's batched ``(apply_fn, m_data, setup_seconds)``.
        ``m_dtype`` torch.bfloat16 rounds a dense M (fsai, AMG, dense
        learned) or the learned bands to bf16 as the last step of the
        timed build."""
        common = self._batched_common()
        n_pad = common["n_pad"]
        groups = None
        if name == "vanilla":
            return _diag_apply, torch.ones_like(common["d_sqrt"]), 0.0
        if name == "jacobi":
            def build():
                return _jacobi_setup_batched(common["d_sqrt"], common["n0"])
            apply_fn = _diag_apply
        elif name == "incomplete_cholesky_neumann":

            def build():
                factors = [ic0_factor(a).tocoo() for a in common["a_sps"]]
                nnz_max = max(f.nnz for f in factors)
                b_cases = len(factors)
                rows = np.full((b_cases, nnz_max), n_pad, np.int64)
                cols = np.full((b_cases, nnz_max), n_pad, np.int64)
                vals = np.zeros((b_cases, nnz_max), np.float32)
                for i, f in enumerate(factors):
                    rows[i, :f.nnz] = f.row
                    cols[i, :f.nnz] = f.col
                    vals[i, :f.nnz] = f.data
                rows_d, cols_d, vals_d = (
                    torch.as_tensor(x, device=self.device)
                    for x in (rows, cols, vals))
                return torch.cat([
                    _neumann_coo_setup(
                        rows_d[lo:lo + chunk], cols_d[lo:lo + chunk],
                        vals_d[lo:lo + chunk], common["n0"][lo:lo + chunk],
                        n_pad, self.ic_neumann_sweeps, self.dtype)
                    for lo in range(0, b_cases, chunk)])
            apply_fn = _dense_apply_batched
        elif name == "algebraic_multigrid":

            def build():
                datas = []
                ncp_max = 8
                for a_sp in common["a_sps"]:
                    csr = a_sp.tocsr()
                    agg, nc = _aggregate(csr, 0.08)
                    p_ = _prolongation(csr, agg, nc, 0.67)
                    inv = np.linalg.inv((p_.T @ csr @ p_).toarray())
                    datas.append((p_, 0.5 * (inv + inv.T)))
                    ncp_max = max(ncp_max, nc)
                b_cases = len(datas)
                p_stack = np.zeros((b_cases, n_pad, ncp_max), np.float32)
                mc_stack = np.zeros((b_cases, ncp_max, ncp_max), np.float32)
                for i, (p_, inv) in enumerate(datas):
                    nc = p_.shape[1]
                    p_stack[i, :p_.shape[0], :nc] = p_.toarray()
                    mc_stack[i, :nc, :nc] = inv
                return _amg_dense_compose(
                    common["a_tilde"], common["d_sqrt"], common["n0"],
                    torch.as_tensor(p_stack, device=self.device).to(
                        self.dtype),
                    torch.as_tensor(mc_stack, device=self.device).to(
                        self.dtype))
            apply_fn = _dense_apply_batched
        elif name == "fsai":
            width = self._fsai_meta(n_pad, self.fsai_power)[0]
            groups = self._batched_fsai_inputs(self.fsai_power, width)

            def build():
                return self._dense_m_from_groups(
                    groups, chunk,
                    lambda p, o, s, n0: _fsai_dense_setup_group(
                        p, o, s, n0, self.dtype))
            apply_fn = _dense_apply_batched
        elif name == "learned":
            if not isinstance(self.model, NeuralFSAI):
                raise ValueError("the batched learned protocol takes the "
                                 "NeuralFSAI flagship (conv families: the "
                                 "per-case protocol)")
            power = self.learned_power or self.fsai_power
            groups = self._batched_fsai_inputs(power, self.model.width)
            spread = None
            if self.batched_learned_apply != "dense":
                spread = max(band_spread(p.out_rows.cpu().numpy(), n_pad)
                             for _, p, _, _ in groups)
                if (self.batched_learned_apply == "banded"
                        or spread <= self.banded_spread_cap):
                    self.batched_routes[name] = ("banded", spread)
                    return self._banded_learned_setup(
                        groups, spread, setup_reps, chunk, m_dtype)
            self.batched_routes[name] = ("dense", spread)
            # the bf16 attempt's products on bf16 inputs; the float32
            # retry rebuilds M with float32 products
            precision = "bf16" if m_dtype == torch.bfloat16 else None

            def build():
                return self._dense_m_from_groups(
                    groups, chunk,
                    lambda p, o, s, n0: neural_fsai_dense_preconditioner(
                        self.model, p, o, s, n0, dtype=self.dtype,
                        precision=precision))
            apply_fn = _dense_apply_batched
        else:
            raise ValueError(f"technique {name} has no batched protocol")

        # bf16 M: fsai, dense learned and AMG; the Neumann G^T G spans too
        # wide a range
        if m_dtype is not None and apply_fn is _dense_apply_batched and (
                name != "incomplete_cholesky_neumann"):
            inner_build = build

            def build():
                return round_bf16(inner_build())
            apply_fn = _dense_apply_batched_bf16
        return (apply_fn, *self._time_build(name, build, groups, chunk,
                                            setup_reps))

    def _time_build(self, name, build, groups, chunk, setup_reps):
        """The warm-up build (what the technique solves with) and the
        setup seconds: the median of ``setup_reps`` builds, one for a
        host-bound technique.  Counts the builds and the B1 launches each
        makes (one per chunk of every plan group)."""
        per_build = 0 if groups is None else sum(
            -(-g[0].shape[0] // chunk) for g in groups)
        reps = 1 if name in HOST_BOUND_TECHNIQUES else setup_reps

        def counted():
            self.batched_builds[name] = self.batched_builds.get(name, 0) + 1
            self.batched_launch_groups[name] = (
                self.batched_launch_groups.get(name, 0) + per_build)
            return build()

        m0 = counted()
        setup_s = time_call(counted, self.device, reps=reps, warmup=0)
        return m0, setup_s

    def _banded_learned_setup(self, groups, d_max, setup_reps, chunk,
                              m_dtype):
        """The batched learned setup in band form: m_data = (bands
        (B, D, n_pad), q (B, degree + 1), a_data) for the banded
        polynomial apply z = C q(B) q(B)^T C^T r.  The bf16 attempt keeps
        bf16 bands and its inner matvec in bf16 (A~ rounded in the build);
        the float32 attempt has no bf16 anywhere."""
        common = self._batched_common()
        n_cases, n_pad = len(self.data_set), common["n_pad"]
        a_data = (common["a_tilde"], common["d_sqrt"])
        model = self.model

        def build():
            bands = torch.zeros(n_cases, d_max, n_pad, dtype=self.dtype,
                                device=self.device)
            qs = torch.zeros(n_cases, model.poly_degree + 1,
                             dtype=self.dtype, device=self.device)
            for sel, plans, ops in self._group_chunks(groups, chunk):
                bands[sel], qs[sel] = _learned_banded_setup_group(
                    model, plans, ops, common["d_sqrt"][sel] ** 2,
                    common["n0"][sel], d_max, self.dtype)
            if m_dtype is None:
                return bands, qs, a_data
            return (bands.to(m_dtype), qs,
                    (round_bf16(common["a_tilde"]), common["d_sqrt"]))

        apply_fn = make_banded_poly_apply(
            _scaled_dense_matvec_fast if m_dtype is not None
            else _scaled_dense_matvec, model.poly_degree)
        return (apply_fn, *self._time_build("learned", build, groups, chunk,
                                            setup_reps))

    @torch.no_grad()
    def run_batched(self, techniques=None, reps: int = 10,
                    setup_reps: int = 20, chunk: int = 100,
                    m_dtype=torch.bfloat16, verbose: bool = False) -> dict:
        """Run the batched protocol; fills ``self.batched`` and returns it.

        Per technique: the batched setup, an untimed warm-up solve
        (chunked, ``_BATCHED_CHECK_EVERY``) that checks convergence
        (bf16 first, float32 if a case fails) and sets the trips to its
        slowest case + 2, then the fixed-trip solve whose counts and
        residuals are recorded, timed over ``reps`` more runs.  ``chunk``
        bounds the cases per setup call (per B1 launch).
        """
        if techniques is None:
            techniques = tuple(
                t for t in self.techniques
                if t in self._BATCHED_CHECK_EVERY
                and (t != "learned" or self.model is not None))
        common = self._batched_common()
        a_data = (common["a_tilde"], common["d_sqrt"])
        n_cases = len(self.data_set)
        for name in techniques:
            ce = self._BATCHED_CHECK_EVERY.get(name, 8)
            attempts = [m_dtype, None] if m_dtype is not None else [None]
            for attempt in attempts:
                apply_fn, m_data, setup_s = self._batched_setup(
                    name, setup_reps, chunk, m_dtype=attempt)
                warm = batched_preconditioned_conjugate_gradient(
                    _scaled_dense_matvec, a_data, common["b"], apply_fn,
                    m_data, rtol=self.rtol, max_iter=self.max_iter,
                    check_every=ce,
                )
                if bool((warm.residual < self.rtol).all()):
                    break
            trips = int(min(int(warm.iterations.max()) + 2, self.max_iter))

            def solve():
                return batched_pcg_fixed_trips(
                    _scaled_dense_matvec, a_data, common["b"], apply_fn,
                    m_data, rtol=self.rtol, max_iter=self.max_iter,
                    trips=trips)

            res_check = solve()
            solve_s = time_call(solve, self.device, reps=reps, warmup=0)
            iters = res_check.iterations.cpu().numpy()
            ok = (res_check.residual < self.rtol).cpu().numpy()
            del m_data
            self.batched[name] = {
                "iterations": float(iters.mean()),
                "iterations_max": int(iters.max()),
                "trips": trips,
                "setup_batch": setup_s,
                "solve_batch": solve_s,
                "total_batch": setup_s + solve_s,
                "per_case_total": (setup_s + solve_s) / n_cases,
                "per_case_solve": solve_s / n_cases,
                "success": 100.0 * float(ok.mean()),
                "cases": n_cases,
                "iterations_per_case": iters.tolist(),
                "m_dtype": "float32" if attempt is None else "bfloat16",
            }
            if verbose:
                s = self.batched[name]
                print(f"batched {name}: iters={s['iterations']:.2f} "
                      f"(max {s['iterations_max']}, trips {trips}, M "
                      f"{s['m_dtype']}) setup={setup_s * 1e3:.3f}ms "
                      f"solve={solve_s * 1e3:.3f}ms "
                      f"success={s['success']:.0f}%", flush=True)
        return self.batched

    def dump_csv_batched(self) -> None:
        """batched.csv in the reference's schema."""
        if not self.batched:
            return
        self.results_directory.mkdir(parents=True, exist_ok=True)
        with (self.results_directory / "batched.csv").open("w") as fio:
            fio.write("technique," + ",".join(BATCHED_KEYS) + "\n")
            for name, stats in self.batched.items():
                fio.write(name + "," + ",".join(
                    str(stats[k]) for k in BATCHED_KEYS) + "\n")

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
