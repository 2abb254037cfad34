"""The port's tracer (``utils/tracing.py``): off unless a
``torch.profiler`` records, then spans with parents, root ids, self time
and counters that also land in the profiler's chrome trace; the chunked
PCG solvers' spans and iteration counter; the setups' and the train
step's spans at tiny sizes."""

import json
import math
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from deeppreconditioning_tpu_torch.data.datasets import _prepare_sample
from deeppreconditioning_tpu_torch.data.fvm import (
    generate_sludge_case,
    numpy_assembly,
)
from deeppreconditioning_tpu_torch.data.poisson import poisson_coeff_dia
from deeppreconditioning_tpu_torch.models.neural_fsai import (
    NeuralFSAI,
    neural_fsai_dense_preconditioner,
    neural_fsai_from_checkpoint,
)
from deeppreconditioning_tpu_torch.ops import fsai
from deeppreconditioning_tpu_torch.ops import structured_fsai as sf
from deeppreconditioning_tpu_torch.ops.dia_spmv import dia_matvec
from deeppreconditioning_tpu_torch.solvers.cg import (
    batched_preconditioned_conjugate_gradient,
    dense_matvec,
    preconditioned_conjugate_gradient,
)
from deeppreconditioning_tpu_torch.train.checkpoint import load_checkpoint
from deeppreconditioning_tpu_torch.train.trainer import adam, fsai_train_step
from deeppreconditioning_tpu_torch.utils import tracing

REPO = Path(__file__).resolve().parents[1]
N_PAD = 256


@pytest.fixture(autouse=True)
def _clean_tracer():
    tracing.reset()
    yield
    tracing.reset()


def _profiled():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _bmv(a, x):
    return (a @ x[..., None])[..., 0]


def _spd(n, seed, batch=None):
    gen = torch.Generator().manual_seed(seed)
    shape = (n, n) if batch is None else (batch, n, n)
    q = torch.randn(shape, generator=gen, dtype=torch.float64)
    a = q @ q.mT / n + 0.05 * torch.eye(n, dtype=torch.float64)
    b = torch.randn(shape[:-1], generator=gen, dtype=torch.float64)
    return a, b


def test_off_records_nothing_and_calls_no_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("called with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert not torch.autograd._profiler_enabled()
    first = tracing.span("t.outer", "cuda")
    assert tracing.span("t.other") is first  # one shared object
    with tracing.span("t.outer", "cuda"):
        with tracing.span("t.inner"):
            tracing.count("t.counter", 3)
    tracing.count("t.counter")
    with pytest.raises(KeyError):
        with tracing.span("t.outer"):
            raise KeyError("an error inside a span goes on")
    assert tracing.snapshot() == {"spans": {}, "counters": {}}


def test_on_spans_nest_with_roots_self_time_and_trace(tmp_path):
    with _profiled() as prof:
        for _ in range(2):
            with tracing.span("t.outer"):
                time.sleep(0.002)
                for _ in range(2):
                    with tracing.span("t.inner", "cpu"):
                        time.sleep(0.003)
                        tracing.count("t.counter", 5)
        tracing.count("t.counter")
    with tracing.span("t.outer"):  # the profiler has stopped
        tracing.count("t.counter", 100)
    snap = tracing.snapshot()
    assert snap["counters"] == {"t.counter": 21}
    outer, inner = snap["spans"]["t.outer"], snap["spans"]["t.inner"]
    assert set(snap["spans"]) == {"t.outer", "t.inner"}
    assert (outer["calls"], inner["calls"]) == (2, 4)
    assert outer["parents"] == {None: 2}
    assert inner["parents"] == {"t.outer": 4}
    assert outer["roots"] == inner["roots"] == 2
    assert inner["host_ms"] >= 4 * 3.0
    assert inner["self_host_ms"] == pytest.approx(inner["host_ms"])
    assert outer["self_host_ms"] == pytest.approx(
        outer["host_ms"] - inner["host_ms"])
    assert outer["self_host_ms"] >= 2 * 2.0
    # on the CPU the host clock stands in for the device's
    for row in (outer, inner):
        assert row["device_ms"] == pytest.approx(row["host_ms"], rel=0.05,
                                                 abs=0.2)

    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    names = [e["name"] for e in events
             if e.get("cat") == "user_annotation"
             and e.get("name", "").startswith("t.")]
    assert sorted(names) == ["t.inner"] * 4 + ["t.outer"] * 2

    tracing.reset()
    assert tracing.snapshot() == {"spans": {}, "counters": {}}


def test_interval_times_the_host_off_the_card():
    interval = tracing.Interval(torch.device("cpu"))
    time.sleep(0.002)
    assert interval.stop().ms() >= 2.0
    assert tracing.Interval().stop().ms() >= 0.0


@pytest.mark.parametrize("check_every", [1, 4, 8])
def test_single_pcg_chunks_reads_and_system_iterations(check_every):
    a, b = _spd(40, seed=check_every)
    with _profiled():
        res = preconditioned_conjugate_gradient(
            dense_matvec, a, b, rtol=1e-10, check_every=check_every)
    snap = tracing.snapshot()
    its = int(res.iterations)
    chunks = math.ceil(its / check_every)
    spans = snap["spans"]
    assert its > 0 and float(res.residual) < 1e-10
    assert spans["pcg.solve"]["calls"] == 1
    assert spans["pcg.solve"]["parents"] == {None: 1}
    assert spans["pcg.chunk"]["calls"] == chunks
    assert spans["pcg.read"]["calls"] == chunks + 1
    assert spans["pcg.chunk"]["parents"] == {"pcg.solve": chunks}
    assert spans["pcg.read"]["roots"] == 1
    executed = snap["counters"]["pcg.system_iterations"]
    assert executed == chunks * check_every >= its


@pytest.mark.parametrize("check_every", [3, 8])
def test_batched_pcg_chunks_reads_and_system_iterations(check_every):
    batch = 5
    a, b = _spd(32, seed=10 + check_every, batch=batch)
    with _profiled():
        res = batched_preconditioned_conjugate_gradient(
            _bmv, a, b, rtol=1e-10, check_every=check_every)
    snap = tracing.snapshot()
    its = res.iterations.tolist()
    chunks = math.ceil(max(its) / check_every)
    spans = snap["spans"]
    assert (res.residual < 1e-10).all()
    assert spans["pcg.solve"]["calls"] == 1
    assert spans["pcg.chunk"]["calls"] == chunks
    assert spans["pcg.read"]["calls"] == chunks + 1
    executed = snap["counters"]["pcg.system_iterations"]
    assert executed == chunks * check_every * batch >= sum(its)


@pytest.mark.parametrize("degree", [0, 1, 2])
def test_pcg_counts_operator_products(degree):
    """``pcg.operator_products``: one product with A at the start and one
    an iteration executed, plus the 2 x degree the structured polynomial
    apply declares (B = C^T A C once per Horner step of each q)."""
    shape = (6, 5, 4)
    a = poisson_coeff_dia(shape, rng=np.random.default_rng(degree),
                          dtype=torch.float64)
    plan = sf.build_structured_plan(shape, power=2, a_offsets=a.offsets)
    bands, _ = sf.structured_setup(a, plan)
    c_up, c_low = sf.bands_to_dia(bands, plan.offsets, a.n)
    q = torch.tensor([1.0, 0.05, 0.01][:degree + 1], dtype=torch.float64)
    apply = sf.make_structured_poly_apply_dia(degree)
    b = torch.zeros(a.n_pad, dtype=torch.float64)
    b[:a.n] = torch.randn(a.n, generator=torch.Generator().manual_seed(1),
                          dtype=torch.float64)
    with _profiled():
        res = preconditioned_conjugate_gradient(
            dia_matvec, a, b, apply, (c_up, c_low, q, a), check_every=4)
    snap = tracing.snapshot()
    chunks = math.ceil(int(res.iterations) / 4)
    assert float(res.residual) < 1e-8
    assert apply.operator_products == 2 * degree
    assert snap["counters"]["pcg.operator_products"] == (
        (4 * chunks + 1) * (1 + 2 * degree))


def test_batched_pcg_counts_operator_products():
    a, b = _spd(24, seed=4, batch=3)
    with _profiled():
        res = batched_preconditioned_conjugate_gradient(
            _bmv, a, b, rtol=1e-10, check_every=5)
    snap = tracing.snapshot()
    chunks = math.ceil(int(res.iterations.max()) / 5)
    assert snap["counters"]["pcg.operator_products"] == 5 * chunks + 1


def test_pcg_without_profiler_counts_nothing():
    a, b = _spd(24, seed=3)
    res = preconditioned_conjugate_gradient(dense_matvec, a, b,
                                            check_every=4)
    assert int(res.iterations) > 0
    assert tracing.snapshot() == {"spans": {}, "counters": {}}


def _sludge_systems(count):
    """[(the scaled tril, dense (n_pad, n_pad); the host sample; its range
    plan)] of ``count`` one-cell sludge cases."""
    out = []
    with numpy_assembly():
        for seed in range(count):
            case = generate_sludge_case(np.random.default_rng(seed),
                                        mesh_cells=1)
            m = case.matrix
            h = _prepare_sample(m.row, m.col, m.data, case.solution,
                                case.rhs, N_PAD)
            a = np.zeros((N_PAD, N_PAD))
            a[h.rows, h.cols] = h.vals
            pr, pc = fsai.tril_power_pattern(h.rows, h.cols, N_PAD, power=2)
            plan = fsai.build_range_fsai_plan(pr, pc, N_PAD, width=16,
                                              range_h=128)
            out.append((a, h, plan))
    return out


def _dense_setup():
    (a_tril, h, plan), = _sludge_systems(1)
    a = a_tril + np.tril(a_tril, -1).T
    model = NeuralFSAI(width=16, hidden=8, poly_degree=2).double()
    with torch.no_grad():
        neural_fsai_dense_preconditioner(
            model, plan.to("cpu"), torch.tensor(a), torch.tensor(h.scale),
            h.original_size, dtype=torch.float64)
    return {"fsai.setup": None, "fsai.forward": "fsai.setup",
            "fsai.wrap": "fsai.setup"}


def _structured_setup():
    shape = (6, 6, 6)
    a = poisson_coeff_dia(shape, np.random.default_rng(4),
                          dtype=torch.float64)
    plan = sf.build_structured_plan(shape, power=2)
    model = neural_fsai_from_checkpoint(load_checkpoint(
        REPO / "assets" / "checkpoints_structured" / "deg1_random.msgpack"))
    with torch.no_grad():
        sf.structured_setup(a, plan, model.double().eval())
    return {"structured.plan": None, "structured.setup": None,
            "structured.columns": "structured.setup",
            "structured.refine": "structured.setup",
            "structured.safeguard": "structured.setup"}


def _train_step():
    systems = _sludge_systems(2)
    plans = fsai.stack_plans([p for _, _, p in systems]).to("cpu")
    a_tril = torch.tensor(np.stack([a for a, _, _ in systems]))
    rhs = torch.tensor(np.stack([h.rhs for _, h, _ in systems]))
    model = NeuralFSAI(width=16, hidden=8, poly_degree=1).double()
    loss = fsai_train_step(model, adam(model, 1e-3), plans,
                           torch.zeros(2, 1, dtype=torch.float64), a_tril,
                           rhs, loss="pcg_loss", pcg_steps=3)
    assert torch.isfinite(loss)
    return {"train.forward": None, "train.backward": None,
            "train.adam": None}


@pytest.mark.parametrize("run", [_dense_setup, _structured_setup,
                                 _train_step],
                         ids=["fsai", "structured", "train"])
def test_setups_and_train_step_emit_their_spans(run):
    with _profiled():
        want = run()
    spans = tracing.snapshot()["spans"]
    assert set(spans) == set(want)
    for name, parent in want.items():
        assert parent in spans[name]["parents"], name
        assert spans[name]["device_ms"] > 0.0, name
    if "train.adam" in want:  # zero_grad, then step
        assert spans["train.adam"]["calls"] == 2
        assert spans["train.forward"]["calls"] == 1
    else:
        assert all(row["calls"] == 1 for row in spans.values())
        assert all(row["roots"] == 1 for row in spans.values())
