"""The learned setup replayed from CUDA graphs
(``models/neural_fsai.neural_fsai_dense_preconditioner``): its bookkeeping
on the CPU, and on a card the graphed setup against the eager one, bit
for bit.

The CPU tests run the graphed setup with the capture replaced by running
the captured function again at each replay; a CPU thread of its own keeps
the CPU's products deterministic.  A key's first call runs eagerly, its
second captures (returning its warm-up's M), later calls replay.  The card tests use no JAX:
``python -m pytest --noconftest -q -m cuda tests/test_torch_fsai_graph.py``.
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch

from deeppreconditioning_tpu_torch import _backend
from deeppreconditioning_tpu_torch.data.datasets import _prepare_sample
from deeppreconditioning_tpu_torch.data.fvm import (
    generate_sludge_case,
    numpy_assembly,
)
from deeppreconditioning_tpu_torch.models import neural_fsai
from deeppreconditioning_tpu_torch.models.neural_fsai import (
    neural_fsai_case_m,
    neural_fsai_case_plan,
    neural_fsai_dense_preconditioner,
    neural_fsai_from_checkpoint,
)
from deeppreconditioning_tpu_torch.ops import fsai
from deeppreconditioning_tpu_torch.train.checkpoint import load_checkpoint
from deeppreconditioning_tpu_torch.utils import graphs, tracing

BEST = (Path(__file__).resolve().parents[1] / "assets" / "checkpoints_fsai"
        / "best.msgpack")


def _case(seed, n_pad, mesh_cells, static_lo=False, range_h=128):
    """(range plan (power 4, w 24), dense A~, scales, n0) of a sludge
    case, numpy."""
    with numpy_assembly():
        case = generate_sludge_case(np.random.default_rng(seed),
                                    mesh_cells=mesh_cells)
    m = case.matrix
    h = _prepare_sample(m.row, m.col, m.data, case.solution, case.rhs,
                        n_pad)
    a = np.zeros((n_pad, n_pad))
    a[h.rows, h.cols] = h.vals
    a = a + np.tril(a, -1).T
    pr, pc = fsai.tril_power_pattern(h.rows, h.cols, n_pad, power=4)
    plan = fsai.build_range_fsai_plan(pr, pc, n_pad, width=24,
                                      range_h=range_h, static_lo=static_lo)
    return plan, a, h.scale, h.original_size


def _f32(x, device):
    return torch.tensor(np.asarray(x), dtype=torch.float32, device=device)


def _inputs(seed, n_pad, mesh_cells, device):
    """``_case``'s setup inputs in float32 on ``device``, ``n0`` an int."""
    plan, a, scale, n0 = _case(seed, n_pad, mesh_cells)
    return plan.to(device), _f32(a, device), _f32(scale, device), n0


def _group(seeds, n_pad, mesh_cells, device, range_h=128):
    """A group plan of static window starts and its stacked inputs, one
    int64 ``n0`` a case, on ``device``."""
    cases = [_case(s, n_pad, mesh_cells, True, range_h) for s in seeds]
    return (fsai.stack_plans([c[0] for c in cases]).to(device),
            _f32([c[1] for c in cases], device),
            _f32([c[2] for c in cases], device),
            torch.tensor([c[3] for c in cases], device=device))


def _eager(monkeypatch, *args, **kwargs):
    with monkeypatch.context() as patch:
        patch.setattr(graphs, "eager_because", lambda *a: "eager")
        return neural_fsai_dense_preconditioner(*args, **kwargs)


@pytest.fixture
def fresh_graphs():
    neural_fsai.SETUP_GRAPHS.clear()
    yield neural_fsai.SETUP_GRAPHS
    neural_fsai.SETUP_GRAPHS.clear()


# -- the graphed setup's bookkeeping, capture replaced --------------------

class _Rerun:
    """A stand-in for a captured graph: a replay runs the function
    again."""

    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


def _rerun_capture(device, warm, *fns):
    """``graphs.capture_graphs`` on the CPU: the eager run, then
    stand-ins for the graphs."""
    del device
    return warm(), [_Rerun(fn) for fn in fns]


@pytest.fixture
def rerun_graphs(monkeypatch, fresh_graphs):
    """The graphed setup on the CPU, one thread: every call engages but a
    "grad" one, and a replay reruns what would have been captured."""
    rule = graphs.eager_because
    monkeypatch.setattr(graphs, "eager_because", lambda *args: (
        None if rule(*args) == "device" else rule(*args)))
    monkeypatch.setattr(graphs, "capture_graphs", _rerun_capture)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield fresh_graphs
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model():
    return neural_fsai_from_checkpoint(load_checkpoint(BEST)).eval()


@torch.no_grad()
def test_graphed_flow_matches_eager(model, rerun_graphs, monkeypatch):
    """Four cases of other n0 and plan values, one key (eager, capture,
    two replays): each M equals the eager setup's, and an earlier M stays
    as it was returned."""
    kept, n0s = [], set()
    for seed in (0, 1, 2, 3):
        inputs = _inputs(seed, 256, 1, "cpu")
        got = neural_fsai_dense_preconditioner(model, *inputs)
        assert torch.equal(got, _eager(monkeypatch, model, *inputs))
        kept.append((got, got.clone()))
        n0s.add(inputs[3])
    assert len(n0s) == 4
    assert len(rerun_graphs) == 1
    graph = next(iter(rerun_graphs.values()))
    assert graph.n0.dtype == torch.int64 and graph.n0.dim() == 0
    for got, same in kept:
        assert torch.equal(got, same)
        assert got.data_ptr() != graph.m.data_ptr()


@torch.no_grad()
def test_graphed_group_matches_eager(model, rerun_graphs, monkeypatch):
    """A group of 3 (static window starts, one n0 a case, bf16 products)
    takes the graphed route and equals its eager setup, eager, captured
    and replayed."""
    inputs = _group((0, 1, 2), 256, 1, "cpu")
    want = _eager(monkeypatch, model, *inputs, precision="bf16")
    for _ in range(3):
        got = neural_fsai_dense_preconditioner(model, *inputs,
                                               precision="bf16")
        assert torch.equal(got, want)
    graph = next(iter(rerun_graphs.values()))
    assert graph.n0.shape == (3,)


def test_graphed_flow_counters(model, rerun_graphs):
    """Under a profiler, four setups of one key: the first runs eagerly
    inside its spans, the second captures (its warm-up records no child
    span), the other two are replayed, each inside its spans."""
    tracing.reset()
    with torch.no_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for seed in (0, 1, 2, 3):
            neural_fsai_dense_preconditioner(model,
                                             *_inputs(seed, 256, 1, "cpu"))
    snap = tracing.snapshot()
    tracing.reset()
    assert snap["counters"]["fsai.graph_setups"] == 2
    assert snap["counters"]["fsai.graph_captures"] == 1
    assert snap["spans"]["fsai.setup"]["calls"] == 4
    for name in ("fsai.forward", "fsai.wrap"):
        assert snap["spans"][name]["calls"] == 3


@torch.no_grad()
def test_first_call_of_a_key_stays_eager(model, rerun_graphs, monkeypatch):
    """A key seen once is only counted: no capture, no counter, and the
    eager setup's M."""
    inputs = _inputs(0, 256, 1, "cpu")
    tracing.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        got = neural_fsai_dense_preconditioner(model, *inputs)
    snap = tracing.snapshot()
    tracing.reset()
    assert torch.equal(got, _eager(monkeypatch, model, *inputs))
    assert not rerun_graphs and len(rerun_graphs.waiting) == 1
    assert "fsai.graph_captures" not in snap["counters"]
    assert snap["spans"]["fsai.forward"]["calls"] == 1


def test_grad_caller_stays_eager(model, rerun_graphs):
    """Under grad mode with parameters that need a gradient the setup
    runs eagerly: no key, and M carries its graph."""
    m = neural_fsai_dense_preconditioner(model, *_inputs(0, 256, 1, "cpu"))
    assert m.requires_grad and not rerun_graphs


def test_setup_graph_cache_is_bounded(rerun_graphs):
    """More models than ``graphs.GRAPH_KEYS``, each set up twice: the
    oldest keys go."""
    inputs = _inputs(0, 256, 1, "cpu")
    models = [neural_fsai.NeuralFSAI(24, 8, 1).requires_grad_(False)
              for _ in range(graphs.GRAPH_KEYS + 2)]
    for m in models:
        for _ in range(2):
            neural_fsai_dense_preconditioner(m, *inputs)
    assert len(rerun_graphs) == graphs.GRAPH_KEYS
    assert [key[0] for key in rerun_graphs] == models[2:]
    assert not rerun_graphs.waiting


@torch.no_grad()
def test_cpu_setup_takes_no_graph(model, fresh_graphs):
    neural_fsai_dense_preconditioner(model, *_inputs(0, 256, 1, "cpu"))
    assert not fresh_graphs


# -- the cache of captured graphs (``graphs.GraphCache``) -----------------

@pytest.mark.parametrize("capture_on", [1, 2, 3])
def test_graph_cache_captures_on_the_nth_call(capture_on):
    """A key's calls before its ``capture_on``-th get None; that call
    captures once; later calls get the same entry."""
    cache, made = graphs.GraphCache(capture_on), []

    def capture():
        made.append(object())
        return made[-1]

    got = [cache.lookup("k", capture) for _ in range(capture_on + 2)]
    assert got[:capture_on - 1] == [None] * (capture_on - 1)
    assert len(made) == 1 and got[capture_on - 1:] == [made[0]] * 3
    assert list(cache) == ["k"] and not cache.waiting


def test_graph_cache_waiting_is_bounded():
    """Keys seen once are remembered for at most ``GRAPH_KEYS`` keys, the
    least recently seen forgotten first; ``clear`` forgets both."""
    cache = graphs.GraphCache(capture_on=2)
    keys = range(graphs.GRAPH_KEYS + 2)
    for key in keys:
        assert cache.lookup(key, object) is None
    assert list(cache.waiting) == list(keys)[2:]
    assert cache.lookup(0, object) is None  # forgotten: seen once again
    assert cache.lookup(5, object) is not None
    assert 5 in cache and 5 not in cache.waiting
    cache.clear()
    assert not cache and not cache.waiting


# -- on the card -----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _launches(run):
    """The ``_backend`` counts of ``run()`` on the card."""
    _backend.reset_launch_counts()
    run()
    torch.cuda.synchronize()
    return (_backend.launch_counts(), _backend.dtype_launch_counts(),
            _backend.plain_cuda_counts())


@pytest.mark.cuda
@torch.no_grad()
def test_cuda_graphed_setup_matches_eager(cuda_device, fresh_graphs,
                                          monkeypatch):
    """Four cases of the per-case cell's shape (n_pad 1024), other n0
    each: under a profiler the first runs eagerly, the second captures
    the key, the other two are replayed, and B1 counts one launch a
    setup; each M equals the eager setup's bit for bit and survives the
    later calls; a replay's launch counts equal the eager setup's.  Then
    a group of 3 (static window starts at H 256, as the suite's batched
    plans) with bf16 products, and the generic plan of a raw sludge case
    (``neural_fsai_case_m``) in float32 and in float64 (B1's float64
    instance), each eager, captured and replayed, bit for bit."""
    model = neural_fsai_from_checkpoint(load_checkpoint(BEST)).to(
        cuda_device).eval()
    cases = [_inputs(seed, 1024, 2, cuda_device) for seed in (0, 1, 2, 6)]
    assert len({c[3] for c in cases}) == 4
    _, leaves = neural_fsai._setup_key(model, *cases[0], torch.float32, None)
    assert graphs.eager_because(leaves, model.parameters()) is None
    tracing.reset()
    _backend.reset_launch_counts()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        got = [neural_fsai_dense_preconditioner(model, *c) for c in cases]
    snap = tracing.snapshot()
    tracing.reset()
    assert snap["counters"]["fsai.graph_setups"] == 2
    assert snap["counters"]["fsai.graph_captures"] == 1
    assert _backend.launch_counts()["gauss_jordan"] == 4
    kept = [m.clone() for m in got]
    for m, c in zip(got, cases):
        assert torch.equal(m, _eager(monkeypatch, model, *c))
        n0 = c[3]
        assert m[:n0, :n0].abs().max() > 0 and not m[n0:].any()
    for m, same in zip(got, kept):
        assert torch.equal(m, same)
    counts = [_launches(lambda: run(model, *cases[1])) for run in (
        neural_fsai_dense_preconditioner,
        lambda *a: _eager(monkeypatch, *a))]
    assert counts[0] == counts[1]
    assert counts[0][0]["gauss_jordan"] == 1
    assert len(fresh_graphs) == 1

    group = _group((3, 4, 5), 1024, 2, cuda_device, range_h=256)
    want = _eager(monkeypatch, model, *group, precision="bf16")
    for _ in range(3):
        got = neural_fsai_dense_preconditioner(model, *group,
                                               precision="bf16")
        assert torch.equal(got, want)
    assert len(fresh_graphs) == 2

    with numpy_assembly():
        raw = generate_sludge_case(np.random.default_rng(7),
                                   mesh_cells=2).matrix
    for dtype in (torch.float32, torch.float64):
        typed = copy.deepcopy(model).to(dtype)
        case = neural_fsai_case_plan(raw, 4, typed.width, dtype, cuda_device)
        assert isinstance(case.plan, fsai.FSAIPlan)

        def eager():
            return _eager(monkeypatch, typed, case.plan, case.l0_vals,
                          case.scales, case.n, dtype=dtype)

        want = eager()
        got = [neural_fsai_case_m(typed, case) for _ in range(3)]
        for m in got:
            assert m.dtype == dtype and torch.equal(m, want)
        counts = [_launches(run) for run in (
            lambda: neural_fsai_case_m(typed, case), eager)]
        assert counts[0] == counts[1]
        assert counts[0][1][("gauss_jordan", str(dtype)[6:])] == 1
    assert len(fresh_graphs) == 4
