"""The single-system PCG's graphed chunk (``solvers/cg.py``) over the
CUDA-graph seam (``utils/graphs.py``): when it engages, its key, the
seam's static copies of an operand tree, and on a card the graphed solve
against the eager loop, bit for bit.

The CPU tests run the graphed solve's bookkeeping with the capture
replaced by running the captured function again at each replay.  The
card tests use no JAX:
``python -m pytest --noconftest -q -m cuda tests/test_torch_cg_graph.py``.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from deeppreconditioning_tpu_torch import _backend
from deeppreconditioning_tpu_torch.data.datasets import _prepare_sample
from deeppreconditioning_tpu_torch.data.fvm import (
    generate_sludge_case,
    numpy_assembly,
)
from deeppreconditioning_tpu_torch.data.poisson import poisson_coeff_dia
from deeppreconditioning_tpu_torch.models.neural_fsai import (
    neural_fsai_case_plan,
)
from deeppreconditioning_tpu_torch.ops import fsai, gmg, trisolve
from deeppreconditioning_tpu_torch.ops.dia_spmv import dia_matvec
from deeppreconditioning_tpu_torch.ops.structured_fsai import (
    bands_to_dia,
    build_structured_plan,
    make_structured_poly_apply_dia,
    structured_setup,
)
from deeppreconditioning_tpu_torch.solvers import cg
from deeppreconditioning_tpu_torch.sparse.dia import DIAMatrix
from deeppreconditioning_tpu_torch.sparse.ell import ELLMatrix
from deeppreconditioning_tpu_torch.utils import graphs, tracing

ROOT = Path(__file__).resolve().parents[1]


def _sludge_like(seed: int, n: int, n_pad: int, dtype, device=None):
    """(ELL A, b, dense Jacobi M) of a random SPD 2-D five-point system
    of ``n`` live rows in ``n_pad``."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(n)))
    lap1 = sp.diags([-np.ones(side - 1), 2 * np.ones(side),
                     -np.ones(side - 1)], [-1, 0, 1])
    lap = sp.kronsum(lap1, lap1).tocsr()[:n, :n]
    a = (lap + sp.diags(10.0 ** rng.uniform(-1, 1, n))).tocsr()
    ell = ELLMatrix.from_scipy(a, n_pad=n_pad, dtype=dtype, device=device)
    b = torch.zeros(n_pad, dtype=dtype, device=device)
    b[:n] = torch.as_tensor(rng.standard_normal(n), dtype=dtype)
    m = torch.zeros((n_pad, n_pad), dtype=dtype, device=device)
    idx = torch.arange(n, device=device)
    m[idx, idx] = torch.as_tensor(1.0 / a.diagonal(), dtype=dtype,
                                  device=device)
    return ell, b, m


_APPLIES = {d: make_structured_poly_apply_dia(d) for d in (0, 1)}


def _structured(seed: int, shape, dtype, device=None, degree: int = 1):
    """(A, b, m_data, apply) of a structured FSAI solve: the classical
    factor with the wrap q = (1, q1) of degree 1 (q = (1,) at 0); one
    apply a degree, as a caller keeps it."""
    a = poisson_coeff_dia(shape, rng=np.random.default_rng(seed),
                          dtype=dtype, device=device)
    plan = build_structured_plan(shape, power=2)
    bands, _ = structured_setup(a, plan)
    c_up, c_low = bands_to_dia(bands, plan.offsets, a.n)
    q = torch.tensor([1.0, 0.05 + 0.1 * seed][:degree + 1], dtype=dtype,
                     device=device)
    gen = torch.Generator().manual_seed(seed)
    b = torch.zeros(a.n_pad, dtype=dtype)
    b[:a.n] = torch.randn(a.n, generator=gen, dtype=dtype)
    return a, b.to(device), (c_up, c_low, q, a), _APPLIES[degree]


def _multigrid(seed: int, shape, dtype, device=None):
    """(A, b, the V(1,1) damped-Jacobi hierarchy) of a lognormal field."""
    a = poisson_coeff_dia(shape, rng=np.random.default_rng(seed),
                          dtype=dtype, device=device)
    with torch.no_grad():
        m = gmg.build_gmg(a, shape)
    gen = torch.Generator().manual_seed(seed)
    b = torch.zeros(a.n_pad, dtype=dtype)
    b[:a.n] = torch.randn(a.n, generator=gen, dtype=dtype)
    return a, b.to(device), m


def _eager_twin(fn):
    """``fn`` behind a closure not declared capture-safe: the eager loop
    with the same kernels."""
    return lambda operand, v: fn(operand, v)


def _solve(matvec, a, b, apply_m, m, check_every=4):
    return cg.preconditioned_conjugate_gradient(
        matvec, a, b, apply_m, m, rtol=1e-8, max_iter=256,
        check_every=check_every)


def _same(got: cg.CGResult, want: cg.CGResult) -> None:
    assert torch.equal(got.x, want.x)
    assert torch.equal(got.iterations, want.iterations)
    assert torch.equal(got.residual, want.residual)


@pytest.fixture
def fresh_graphs():
    cg._graphs.clear()
    yield cg._graphs
    cg._graphs.clear()


# -- the engagement rule -------------------------------------------------

def _rule_case(name: str):
    ell, b, m = _sludge_like(0, 40, 48, torch.float64)
    if name == "cpu tensor":
        return cg.ell_matvec, ell, b, cg.dense_matvec, m, "device"
    if name == "leaf needs a gradient":
        return (cg.ell_matvec, ell, b, cg.dense_matvec,
                m.requires_grad_(), "grad")
    if name == "leaf needs a gradient, grad mode off":
        return (cg.ell_matvec, ell, b, cg.dense_matvec,
                m.requires_grad_(), "device:no_grad")
    if name == "undeclared ic_apply":
        return cg.ell_matvec, ell, b, trisolve.ic_apply, None, "undeclared"
    if name == "undeclared matvec":
        return (_eager_twin(cg.ell_matvec), ell, b, cg.identity_apply,
                None, "undeclared")
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "cpu tensor", "leaf needs a gradient",
    "leaf needs a gradient, grad mode off", "undeclared ic_apply",
    "undeclared matvec"])
def test_engagement_rule(name):
    matvec, a, b, apply_m, m, want = _rule_case(name)
    want, _, mode = want.partition(":")
    _, leaves = cg._graph_key(matvec, a, b, apply_m, m, 1e-8, 256, 4)
    with torch.set_grad_enabled(mode != "no_grad"):
        assert cg._eager_because(matvec, apply_m, leaves) == want


@pytest.mark.parametrize("fn", [
    cg.ell_matvec, cg.dense_matvec, cg.identity_apply, dia_matvec,
    make_structured_poly_apply_dia(0), make_structured_poly_apply_dia(2),
    gmg.gmg_apply])
def test_declared_pairs(fn):
    """Every declared callable reads capture-safe; a declared pair on a
    CPU tensor still runs eagerly, for the device alone."""
    assert fn.capture_safe is True
    assert cg._eager_because(fn, cg.identity_apply,
                             [torch.zeros(8)]) == "device"


def test_undeclared_callables():
    for fn in (trisolve.ic_apply, _eager_twin(cg.dense_matvec)):
        assert not getattr(fn, "capture_safe", False)


def test_kernel_wrappers_do_not_load_the_solvers():
    """``capture_safe`` comes from the seam: importing the B2 wrapper and
    the structured FSAI loads nothing of ``solvers``."""
    code = ("import sys\n"
            "import deeppreconditioning_tpu_torch.ops.dia_spmv\n"
            "import deeppreconditioning_tpu_torch.ops.structured_fsai\n"
            "print(sorted(m for m in sys.modules if m.startswith("
            "'deeppreconditioning_tpu_torch.solvers')))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    assert cg.capture_safe is graphs.capture_safe


# -- the key -------------------------------------------------------------

def _key(matvec, a, b, apply_m, m, rtol=1e-8, max_iter=256, check_every=4):
    return cg._graph_key(matvec, a, b, apply_m, m, rtol, max_iter,
                         check_every)[0]


def test_key_ignores_ell_n():
    """Two ELL cases of other n and the same shapes share a key."""
    e1, b1, m1 = _sludge_like(1, 40, 48, torch.float32)
    e2, b2, m2 = _sludge_like(2, 44, 48, torch.float32)
    assert e1.n != e2.n and e1.cols.shape == e2.cols.shape
    k1 = _key(cg.ell_matvec, e1, b1, cg.dense_matvec, m1)
    assert k1 == _key(cg.ell_matvec, e2, b2, cg.dense_matvec, m2)
    hash(k1)


def test_key_reads_what_the_chunk_reads():
    e1, b1, m1 = _sludge_like(1, 40, 48, torch.float32)
    base = _key(cg.ell_matvec, e1, b1, cg.dense_matvec, m1)
    wider = ELLMatrix(cols=torch.cat([e1.cols, e1.cols[:, :1]], 1),
                      vals=torch.cat([e1.vals, e1.vals[:, :1]], 1), n=e1.n)
    others = [
        _key(cg.ell_matvec, wider, b1, cg.dense_matvec, m1),
        _key(cg.ell_matvec, e1, b1.double(), cg.dense_matvec, m1),
        _key(cg.ell_matvec, e1, b1, cg.dense_matvec, m1.t()),
        _key(cg.ell_matvec, e1, b1, cg.identity_apply, None),
        _key(cg.ell_matvec, e1, b1, cg.dense_matvec, m1, rtol=1e-6),
        _key(cg.ell_matvec, e1, b1, cg.dense_matvec, m1, max_iter=128),
        _key(cg.ell_matvec, e1, b1, cg.dense_matvec, m1, check_every=8),
    ]
    assert len({base, *others}) == len(others) + 1


def test_key_dia_offsets_and_sharing():
    """Other DIA offsets give another key; so does an operand that is no
    longer the same object as the operator."""
    a, b, m, apply = _structured(0, (6, 5, 4), torch.float64)
    base = _key(dia_matvec, a, b, apply, m)
    shifted = DIAMatrix(vals=a.vals, offsets=tuple(o if o != 1 else 2
                                                   for o in a.offsets),
                        n=a.n)
    assert _key(dia_matvec, shifted, b, apply, m[:3] + (shifted,)) != base
    twin = DIAMatrix(vals=a.vals.clone(), offsets=a.offsets, n=a.n)
    assert _key(dia_matvec, a, b, apply, m[:3] + (twin,)) != base
    assert _key(dia_matvec, a, b, apply, m[:3] + (a,)) == base


def _key_before(tree, tensors: list, memo: dict):
    """The walk as it was before dataclass fields holding dataclasses or
    tuples of them were walked: a dataclass's tensor fields walked, every
    other field by value."""
    from dataclasses import is_dataclass

    if torch.is_tensor(tree) or is_dataclass(tree):
        if id(tree) in memo:
            return ("same", memo[id(tree)])
        memo[id(tree)] = len(memo)
        if torch.is_tensor(tree):
            tensors.append(tree)
            return ("tensor", tree.shape, tree.stride(), tree.dtype,
                    tree.device)
        return (type(tree), *(
            _key_before(value, tensors, memo) if torch.is_tensor(value)
            else value for _, value in graphs._keyed(tree)))
    if isinstance(tree, tuple):
        return ("tuple", *(_key_before(t, tensors, memo) for t in tree))
    if tree is None:
        return None
    raise TypeError(type(tree).__name__)


@pytest.mark.parametrize("kind", ["ell", "dia", "range plan",
                                  "generic plan"])
def test_todays_trees_keep_their_keys(kind):
    """The operand trees of the PCG chunk (ELL A, b, dense M; DIA A, b,
    the structured apply's (C^T, C, q, A)) and of the learned setup (a
    range or generic plan, the operand, the scales) walk to the keys and
    the tensors they walked to before the walk recursed."""
    tree = _operands(kind, 1)
    tensors: list = []
    assert graphs.walk(tree) == (_key_before(tree, tensors, {}), tensors)


def test_gmg_hierarchy_walk_and_copy():
    """A multigrid's levels and root are walked and copied: each tensor
    once (the finest operator is the system's own, so it is walked once),
    the sharing kept, a second field's tensors copied in make the static
    tree equal to it, and another depth gives another key."""
    shape = (32, 32, 32)
    a, b, m = _multigrid(1, shape, torch.float64)
    assert len(m.levels) == 2
    key, leaves = cg._graph_key(dia_matvec, a, b, gmg.gmg_apply, m, 1e-8,
                                256, 4)
    hash(key)
    # A's bands, b, then per level its inverse diagonal (and below the
    # finest its bands), then the root's inverse
    assert len(leaves) == 2 + 1 + 2 * (len(m.levels) - 1) + 1
    assert len({t.data_ptr() for t in leaves}) == len(leaves)
    (a_s, b_s, m_s), statics = graphs.static_copy((a, b, m))
    assert m_s.levels[0].a is a_s and a_s.launch_plan is None
    assert [lev.shape for lev in m_s.levels] == [lev.shape
                                                 for lev in m.levels]
    assert graphs.walk((a_s, b_s, m_s)) == graphs.walk((a, b, m))[:1] + (
        statics,)
    a2, b2, m2 = _multigrid(2, shape, torch.float64)
    key2, leaves2 = cg._graph_key(dia_matvec, a2, b2, gmg.gmg_apply, m2,
                                  1e-8, 256, 4)
    assert key2 == key
    for static, value in zip(statics, leaves2):
        static.copy_(value)
    for lev_s, lev in zip(m_s.levels, m2.levels):
        assert torch.equal(lev_s.a.vals, lev.a.vals)
        assert torch.equal(lev_s.inv_diag, lev.inv_diag)
    assert torch.equal(m_s.coarse_inv, m2.coarse_inv)
    small, b3, m3 = _multigrid(1, (16, 16, 16), torch.float64)
    assert len(m3.levels) == 1
    assert cg._graph_key(dia_matvec, small, b3, gmg.gmg_apply, m3, 1e-8,
                         256, 4)[0] != key


def test_key_refuses_other_operands():
    e1, b1, _ = _sludge_like(1, 40, 48, torch.float32)
    key, leaves = cg._graph_key(cg.ell_matvec, e1, b1, cg.dense_matvec,
                                object(), 1e-8, 256, 4)
    assert key is None and leaves is None
    with pytest.raises(TypeError):
        graphs.walk((e1, b1, [b1]))


# -- static copies -------------------------------------------------------

def _sludge_plan_case(seed: int):
    """(range plan (power 4, w 24, H 128) as tensors, dense A~, scales)
    of a generated sludge case in n_pad 256: the learned setup's
    operands."""
    with numpy_assembly():
        case = generate_sludge_case(np.random.default_rng(seed),
                                    mesh_cells=1)
    m = case.matrix
    h = _prepare_sample(m.row, m.col, m.data, case.solution, case.rhs, 256)
    a = np.zeros((256, 256))
    a[h.rows, h.cols] = h.vals
    pr, pc = fsai.tril_power_pattern(h.rows, h.cols, 256, power=4)
    plan = fsai.build_range_fsai_plan(pr, pc, 256, width=24, range_h=128)
    return (plan.to("cpu"), torch.as_tensor(a + np.tril(a, -1).T),
            torch.as_tensor(h.scale))


def _operands(kind: str, seed: int):
    if kind == "ell":
        ell, b, m = _sludge_like(seed, 40, 48, torch.float32)
        return ell, b, m
    if kind == "dia":
        a, b, m, _ = _structured(seed, (6, 5, 4), torch.float64)
        return a, b, m
    if kind == "range plan":
        return _sludge_plan_case(seed)
    # the generic plan of one raw system; requests differ in its values
    with numpy_assembly():
        raw = generate_sludge_case(np.random.default_rng(0),
                                   mesh_cells=1).matrix
    case = neural_fsai_case_plan(raw, 2, 16, torch.float64, "cpu")
    return case.plan, case.l0_vals * seed, case.scales + seed


@pytest.mark.parametrize("kind", ["ell", "dia", "range plan",
                                  "generic plan"])
def test_static_copy_round_trip(kind):
    """The static tree takes every tensor's layout and the sharing, and
    walks to the same key; a second request's tensors copied in make it
    equal to that request."""
    first = _operands(kind, 1)
    statics, static_leaves = graphs.static_copy(first)
    key, leaves = graphs.walk(first)
    assert graphs.walk(statics) == (key, static_leaves)
    assert len(leaves) == len(static_leaves)
    for s_t, t in zip(static_leaves, leaves):
        assert s_t.shape == t.shape and s_t.stride() == t.stride()
        assert s_t.dtype == t.dtype and s_t.data_ptr() != t.data_ptr()
    a_s, b_s, m_s = statics
    assert type(a_s) is type(first[0])
    if kind == "dia":
        assert m_s[3] is a_s and a_s.offsets == first[0].offsets
        assert a_s.n == first[0].n and a_s.launch_plan is None
        assert len(leaves) == 5  # a, b, c_up, c_low, q: a once
    elif kind == "ell":
        assert a_s.n == first[0].n and len(leaves) == 4
    elif kind == "range plan":
        assert (a_s.h, a_s.lo_static) == (first[0].h, first[0].lo_static)
        assert len(leaves) == 7  # lo, local, pos, diag_pad, out_rows, A~, D
    else:
        assert isinstance(a_s, fsai.FSAIPlan) and len(leaves) == 8
    second = _operands(kind, 2)
    key2, leaves2 = graphs.walk(second)
    assert key2 == key
    for s_t, t in zip(static_leaves, leaves2):
        s_t.copy_(t)
    for s_t, t in zip(static_leaves, leaves2):
        assert torch.equal(s_t, t)
    if kind == "dia":
        assert torch.equal(a_s.vals, second[0].vals)
        assert torch.equal(m_s[2], second[2][2])
    elif kind == "ell":
        assert torch.equal(a_s.cols, second[0].cols)
        assert torch.equal(m_s, second[2])
    else:
        assert torch.equal(a_s.out_rows, second[0].out_rows)
        assert torch.equal(b_s, second[1]) and torch.equal(m_s, second[2])


# -- the graphed solve's bookkeeping, capture replaced -------------------

class _Rerun:
    """A stand-in for a captured graph: a replay runs the function
    again."""

    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


def _rerun_capture(device, warm, *fns):
    """``graphs.capture_graphs`` on the CPU: the warm-up, then stand-ins
    for the graphs."""
    del device
    return warm(), [_Rerun(fn) for fn in fns]


@pytest.fixture
def rerun_graphs(monkeypatch, fresh_graphs):
    """The graphed solve on the CPU: every declared call engages, and a
    replay reruns what would have been captured."""
    rule = graphs.eager_because
    monkeypatch.setattr(graphs, "eager_because", lambda *args: (
        None if rule(*args) == "device" else rule(*args)))
    monkeypatch.setattr(graphs, "capture_graphs", _rerun_capture)
    return fresh_graphs


@pytest.mark.parametrize("kind", ["ell", "dia"])
def test_graphed_flow_matches_eager(kind, rerun_graphs):
    """Three requests in a row, one key: each equals its eager solve, and
    an earlier request's x stays as it was returned."""
    results, kept = [], []
    for seed in (1, 2, 3):
        if kind == "ell":
            a, b, m = _sludge_like(seed, 40, 48, torch.float64)
            matvec, apply = cg.ell_matvec, cg.dense_matvec
        else:
            a, b, m, apply = _structured(seed, (6, 5, 4), torch.float64)
            matvec = dia_matvec
        got = _solve(matvec, a, b, apply, m)
        want = _solve(_eager_twin(matvec), a, b, _eager_twin(apply), m)
        _same(got, want)
        assert 0 < int(got.iterations) < 256
        results.append(got)
        kept.append(got.x.clone())
    assert len(rerun_graphs) == 1
    graph = next(iter(rerun_graphs.values()))
    for got, x in zip(results, kept):
        assert torch.equal(got.x, x)
        assert got.x.data_ptr() != graph.state.x.data_ptr()
        assert got.iterations.data_ptr() != graph.state.k.data_ptr()


def test_graphed_flow_counters(rerun_graphs):
    """Under a profiler: one capture, every chunk a graph chunk, the
    iterations counted as the eager loop counts them."""
    a, b, m = _sludge_like(4, 40, 48, torch.float64)
    tracing.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        got = _solve(cg.ell_matvec, a, b, cg.dense_matvec, m)
        _solve(cg.ell_matvec, a, b, cg.dense_matvec, m)
    snap = tracing.snapshot()
    tracing.reset()
    chunks = snap["spans"]["pcg.chunk"]["calls"]
    assert chunks == 2 * -(-int(got.iterations) // 4)
    assert snap["counters"]["pcg.graph_chunks"] == chunks
    assert snap["counters"]["pcg.graph_captures"] == 1
    assert snap["counters"]["pcg.system_iterations"] == 4 * chunks


def test_graphed_flow_counts_operator_products(rerun_graphs):
    """A replayed start and chunk add the operator products their capture
    enqueued (the replay here runs nothing that counts), as a replay adds
    the ``_backend`` launch counts: the eager loop's count, products of
    the structured apply included."""
    counts = []
    for matvec in (dia_matvec, _eager_twin(dia_matvec)):
        a, b, m, apply = _structured(2, (6, 5, 4), torch.float64)
        tracing.reset()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            got = _solve(matvec, a, b, apply, m)
        snap = tracing.snapshot()
        tracing.reset()
        chunks = -(-int(got.iterations) // 4)
        assert snap["counters"]["pcg.operator_products"] == (
            (4 * chunks + 1) * 3)
        counts.append(snap["counters"].get("pcg.graph_chunks", 0))
    assert counts[0] > 0 and counts[1] == 0  # graphed, then eager
    graph = next(iter(rerun_graphs.values()))
    assert graph.products == 3


def test_graphed_gmg_flow_matches_eager_and_counts_cycles(rerun_graphs):
    """Two fields through one key, each equal to its eager solve (a
    replay over the first field's levels would not be), and under a
    profiler the V-cycles and operator products the eager loop counts:
    one cycle (an apply: the start and each executed iteration, which is
    ``pcg.system_iterations`` plus one a solve) and three products at the
    start and each iteration."""
    counts = []
    for seed in (1, 2):
        a, b, m = _multigrid(seed, (32, 32, 32), torch.float64)
        tracing.reset()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            got = _solve(dia_matvec, a, b, gmg.gmg_apply, m)
        snap = tracing.snapshot()
        tracing.reset()
        want = _solve(_eager_twin(dia_matvec), a, b,
                      _eager_twin(gmg.gmg_apply), m)
        _same(got, want)
        assert 0 < int(got.iterations) < 30
        applies = 4 * -(-int(got.iterations) // 4) + 1
        assert snap["counters"]["pcg.system_iterations"] + 1 == applies
        assert snap["spans"]["pcg.solve"]["calls"] == 1
        assert snap["counters"]["pcg.operator_products"] == 3 * applies
        counts.append(snap["counters"].get("pcg.graph_captures", 0))
    assert counts == [1, 0] and len(rerun_graphs) == 1
    assert cg.operator_products(gmg.gmg_apply) == 3


def _same_hierarchy(got: gmg.GMGPreconditioner,
                    want: gmg.GMGPreconditioner) -> None:
    assert [lev.shape for lev in got.levels] == [
        lev.shape for lev in want.levels]
    for lev, ref_lev in zip(got.levels, want.levels):
        assert lev.a.offsets == ref_lev.a.offsets
        assert torch.equal(lev.a.vals, ref_lev.a.vals)
        assert torch.equal(lev.inv_diag, ref_lev.inv_diag)
    assert torch.equal(got.coarse_inv, want.coarse_inv)


def test_graphed_gmg_setup_matches_eager(monkeypatch):
    """Three fields of one grid through the setup's graphs, the capture
    replaced by a rerun: the first call eager, the second captures, the
    third replays; each equals its eager setup bit for bit, keeps the
    caller's fine operator, and holds its own coarse levels (a replay
    overwrites the graphs' outputs, not an earlier hierarchy)."""
    shape = (32, 32, 32)
    fields = [_multigrid(seed, shape, torch.float64) for seed in (1, 2, 3)]
    rule = graphs.eager_because
    monkeypatch.setattr(graphs, "eager_because", lambda *args: (
        None if rule(*args) == "device" else rule(*args)))
    monkeypatch.setattr(graphs, "capture_graphs", _rerun_capture)
    gmg.SETUP_GRAPHS.clear()
    try:
        got = [gmg.build_gmg(a, shape) for a, _, _ in fields]
        assert len(gmg.SETUP_GRAPHS) == 1
        entry = next(iter(gmg.SETUP_GRAPHS.values()))
    finally:
        gmg.SETUP_GRAPHS.clear()
    for m, (a, _, want) in zip(got, fields):
        _same_hierarchy(m, want)
        assert m.levels[0].a is a
        assert m.levels[1].a.vals.data_ptr() != (
            entry.coarse[0].vals.data_ptr())


def test_no_cycles_counted_without_a_multigrid(rerun_graphs):
    """The solver counts only its own ``pcg.*`` numbers, named after no
    preconditioner: a V-cycle count is one an apply, read from them."""
    a, b, m, apply = _structured(1, (6, 5, 4), torch.float64)
    tracing.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _solve(dia_matvec, a, b, apply, m)
    snap = tracing.snapshot()
    tracing.reset()
    assert snap["counters"]["pcg.system_iterations"] > 0
    assert all(name.startswith("pcg.") for name in snap["counters"])


def test_graph_cache_is_bounded(rerun_graphs):
    for check_every in range(1, graphs.GRAPH_KEYS + 3):
        a, b, m = _sludge_like(5, 40, 48, torch.float64)
        _solve(cg.ell_matvec, a, b, cg.dense_matvec, m, check_every)
    assert len(rerun_graphs) == graphs.GRAPH_KEYS
    assert [key[-1] for key in rerun_graphs] == list(
        range(3, graphs.GRAPH_KEYS + 3))


def test_launch_replay_counts():
    """A capture's counts are taken back out and a replay adds them."""
    before = _backend.launch_counts()["dia_spmv"]
    state = _backend.launch_state()
    _backend.count_launch("dia_spmv")
    _backend.count_launch("gauss_jordan", torch.float64)
    delta = _backend.launches_since(state)
    assert _backend.launch_counts()["dia_spmv"] == before
    assert delta[0] == {"dia_spmv": 1, "gauss_jordan": 1}
    assert delta[1] == {("gauss_jordan", "float64"): 1}
    _backend.add_launches(delta)
    _backend.add_launches(delta)
    assert _backend.launch_counts()["dia_spmv"] == before + 2


# -- on the card ---------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _sludge_case(seed: int, device):
    """A generated sludge case as the per-case cell runs it: ELL A of
    n_pad 1024, b, a dense 1024^2 M (Jacobi, with a symmetric band)."""
    from deeppreconditioning_tpu_torch.data.fvm import (
        generate_sludge_case,
        numpy_assembly,
    )

    with numpy_assembly():
        case = generate_sludge_case(np.random.default_rng(seed))
    a = case.matrix.tocsr()
    n = a.shape[0]
    ell = ELLMatrix.from_scipy(a, n_pad=1024, dtype=torch.float32,
                               device=device)
    b = torch.zeros(1024, dtype=torch.float32, device=device)
    b[:n] = torch.as_tensor(case.rhs, dtype=torch.float32, device=device)
    d = torch.as_tensor(1.0 / a.diagonal(), dtype=torch.float32,
                        device=device)
    m = torch.zeros((1024, 1024), dtype=torch.float32, device=device)
    idx = torch.arange(n, device=device)
    m[idx, idx] = d
    m[idx[1:], idx[:-1]] = m[idx[:-1], idx[1:]] = 0.05 * torch.sqrt(
        d[1:] * d[:-1])
    return ell, b, m


@pytest.mark.cuda
@torch.no_grad()
def test_cuda_graphed_matches_eager(cuda_device, fresh_graphs):
    """Three sludge requests and three structured requests, other
    operators, M and q each: every graphed solve equals its eager one bit
    for bit, an earlier x survives the later requests, and once the key
    is captured B2's launch count equals the eager solve's."""
    kept = []
    for seed in (0, 1, 2):
        a, b, m = _sludge_case(seed, cuda_device)
        assert cg._eager_because(cg.ell_matvec, cg.dense_matvec,
                                 [b, m]) is None
        got = _solve(cg.ell_matvec, a, b, cg.dense_matvec, m, 8)
        want = _solve(_eager_twin(cg.ell_matvec), a, b,
                      _eager_twin(cg.dense_matvec), m, 8)
        _same(got, want)
        assert float(got.residual) < 1e-8
        kept.append((got, got.x.clone()))
    a, b, m, apply = _structured(3, (16, 16, 16), torch.float32,
                                 cuda_device)
    _solve(dia_matvec, a, b, apply, m, 8)  # captures the key
    for seed in (0, 1, 2):  # the key captured: only replays count
        a, b, m, apply = _structured(seed, (16, 16, 16), torch.float32,
                                     cuda_device)
        _backend.reset_launch_counts()
        got = _solve(dia_matvec, a, b, apply, m, 8)
        graphed = _backend.launch_counts()["dia_spmv"]
        _backend.reset_launch_counts()
        want = _solve(_eager_twin(dia_matvec), a, b, _eager_twin(apply), m,
                      8)
        assert graphed == _backend.launch_counts()["dia_spmv"] > 0
        _same(got, want)
        assert float(got.residual) < 1e-8
        kept.append((got, got.x.clone()))
    assert len(fresh_graphs) == 2
    for got, x in kept:
        assert torch.equal(got.x, x)


@pytest.mark.cuda
@torch.no_grad()
def test_cuda_graphed_gmg_matches_eager(cuda_device, fresh_graphs):
    """The multigrid solve on the card: two fields through one key, each
    graphed solve equal to its eager one bit for bit (a replay over the
    first field's levels, not copied in, would give the second field the
    first's cycle), and once the key is captured B2's launch count equal
    to the eager solve's."""
    shape = (64, 64, 64)
    a, b, m = _multigrid(3, shape, torch.float32, cuda_device)
    _solve(dia_matvec, a, b, gmg.gmg_apply, m, 8)  # captures the key
    kept = []
    for seed in (0, 1):
        a, b, m = _multigrid(seed, shape, torch.float32, cuda_device)
        _backend.reset_launch_counts()
        got = _solve(dia_matvec, a, b, gmg.gmg_apply, m, 8)
        graphed = _backend.launch_counts()["dia_spmv"]
        _backend.reset_launch_counts()
        want = _solve(_eager_twin(dia_matvec), a, b,
                      _eager_twin(gmg.gmg_apply), m, 8)
        assert graphed == _backend.launch_counts()["dia_spmv"] > 0
        _same(got, want)
        assert float(got.residual) < 1e-8
        kept.append((got, got.x.clone()))
    assert len(fresh_graphs) == 1
    assert not torch.equal(kept[0][1], kept[1][1])
    for got, x in kept:
        assert torch.equal(got.x, x)


@pytest.mark.cuda
@torch.no_grad()
def test_cuda_graphed_gmg_setup_matches_eager(cuda_device):
    """The setup on the card: a key's first call eager, its second
    captured, the later ones replayed; every hierarchy equal to the eager
    path's bit for bit, the earlier ones unchanged by the later setups."""
    shape = (64, 64, 64)
    lvl_shapes, root_shape = gmg.level_shapes(shape)
    gmg.SETUP_GRAPHS.clear()
    kept = []
    try:
        for seed in (0, 1, 2, 3):
            a, _, m = _multigrid(seed, shape, torch.float32, cuda_device)
            inv_diags, coarse = gmg._galerkin_levels(a, lvl_shapes)
            want = gmg.GMGPreconditioner(
                levels=tuple(gmg.GMGLevel(
                    a=lvl_a, inv_diag=d, c_up=None, c_low=None, shape=s,
                    omega=gmg.OMEGA) for lvl_a, d, s in zip(
                        (a, *coarse), inv_diags, lvl_shapes)),
                coarse_inv=gmg._symmetric_inverse(
                    gmg._dia_to_dense_static(coarse[-1])),
                coarse_shape=root_shape)
            _same_hierarchy(m, want)
            kept.append((m, want))
        assert len(gmg.SETUP_GRAPHS) == 1
    finally:
        gmg.SETUP_GRAPHS.clear()
    for m, want in kept:
        _same_hierarchy(m, want)
