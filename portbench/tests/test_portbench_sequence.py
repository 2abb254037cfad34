"""The sequence runner's cells (``poisson128-seq8-learned``,
``hpcg27-256-learned``) at tiny sizes on the CPU, and the readers of the
operator products inside the PCG solves (``harness/operators.py``)."""

import json
import math
import time

import pytest
import torch

from _cells import ROOT
from deeppreconditioning_tpu_torch.utils import tracing
from portbench.conftest import TINY_ADDED
from portbench.harness.loop import Spans, run_cell
from portbench.harness import operators
from portbench.harness.operators import operator_roofline, operator_share
from portbench.harness.spec import load_cell, load_reader, load_runner
from portbench.work import card_peaks, dia_work

CELLS = ("poisson128-seq8-learned", "hpcg27-256-learned")
NEW = ("b2_operator_roofline", "pcg_operator_share")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _run(workload, trace=False, fault=None, seed=2**31 + 7):
    return run_cell(workload, seed, 0.6, trace, time.perf_counter(),
                    device="cpu", sizes=TINY_ADDED["structured_sequence"],
                    fault=fault)


@pytest.mark.parametrize("workload", CELLS)
def test_sequences_and_their_setups(workload, monkeypatch):
    """Request k solves rhs k mod L of sequence k // L (L 2 here, 8 in
    the mixes); the 128^3 cell sets up in each sequence's first request,
    HPCG in set-up only; the check passes; the traced slice counts the
    operator products its solves enqueue (3 an iteration and at the
    start: the degree-1 apply's two)."""
    length = TINY_ADDED["structured_sequence"]["sequence"]
    taken = []
    snapshot = tracing.snapshot
    monkeypatch.setattr(tracing, "snapshot",
                        lambda: taken.append(snapshot()) or taken[-1])
    tracing.reset()
    res = _run(workload, trace=True)
    assert res.line["correct"] is True, res.line["checks"]
    assert res.line["attempted"] > length
    hpcg = workload.startswith("hpcg")
    for rec in res.records:
        assert rec.info["setup"] == (not hpcg and rec.k % length == 0)
        assert rec.info["field"] == (0 if hpcg else (rec.k // length) % 2)
    traced = [r for r in res.records if r.traced]
    products = sum((8 * math.ceil(i / 8) + 1) * 3
                   for r in traced for i in r.iterations)
    assert taken[0]["counters"]["pcg.operator_products"] == products
    assert ("setup_ms" in res.line["metrics"]) == (not hpcg)
    for name in NEW:  # device metrics: none from a CPU run
        assert name not in res.line["metrics"]


def test_rhs_walks_and_restarts():
    spec = load_cell("hpcg27-256-learned")
    config = dict(spec.config, **TINY_ADDED["structured_sequence"])
    cell = load_runner("structured_sequence").Cell(
        config, spec.traffic, 5, torch.device("cpu"), Spans(
            torch.device("cpu")))
    first = [cell.prepare(k)[1].clone() for k in range(9)]
    assert first[8].equal(first[0])  # every sequence starts from A 1
    step = (first[1] - first[0])[:cell.n]
    assert 0.05 < float(step.std()) < 0.2  # a walk of step 0.1
    assert not first[1].equal(first[0]) and first[2].ne(first[1]).any()


def test_declared_metrics():
    declared = {m["name"]: m for m in BENCH["per_layer"]}
    for name in NEW:
        m = declared[name]
        assert m["source"] == "device_trace" and m["unit"] == "%"
        assert m["moves"] == "solves_per_s"
        assert m["workloads"] == list(CELLS)
    assert declared["b2_operator_roofline"]["layer"] == "kernel B2"
    assert declared["pcg_operator_share"]["layer"] == "solver"


# -- the readers on a made-up trace -------------------------------------

OP = "void (anonymous namespace)::dia_spmv_kernel<27, 1>(float const*)"
FACTOR = "void (anonymous namespace)::dia_spmv_kernel<14, 2>(float)"


def _events(solves=((0.0, 100.0),)):
    """Five kernels whose launch calls (host clock) fall at 10, 20, 50, 60
    and 150 us; the card's clock runs 40 us early, so the first kernel
    starts before the solve's span on the card but was launched inside
    it, and the last was launched outside."""
    launches = [(OP, 10.0, 40.0), (FACTOR, 20.0, 20.0), (OP, 50.0, 40.0),
                ("void at::native::reduce_kernel<512>", 60.0, 20.0),
                (OP, 150.0, 40.0)]
    events = [{"ph": "X", "cat": "user_annotation", "name": "pcg.solve",
               "ts": a, "dur": b - a} for a, b in solves]
    for corr, (name, t, dur) in enumerate(launches):
        events.append({"ph": "X", "cat": "cuda_runtime",
                       "name": "cudaGraphLaunch", "ts": t, "dur": 2.0,
                       "args": {"correlation": corr}})
        events.append({"ph": "X", "cat": "kernel", "name": name,
                       "ts": t - 40.0, "dur": dur,
                       "args": {"correlation": corr}})
    return events


class _Cell:
    operator_bands = 27
    n_pad = 1 << 20
    config = {"name": "hpcg27-256"}
    traffic = {"name": "hpcg-seq8"}

    def operator_work(self):
        return dia_work(27, self.n_pad)


class _View:
    def __init__(self, products, events, tmp_path, monkeypatch):
        path = tmp_path / "cell.trace.json"
        path.write_text(json.dumps({"traceEvents": events}))
        monkeypatch.setattr(operators, "trace_path", lambda view: path)
        self.records = [object()]
        self.cell = _Cell()
        self.peaks = card_peaks("NVIDIA H100 80GB HBM3")
        counters = {} if products is None else {
            "pcg.operator_products": products}
        self.program = {"spans": {}, "counters": counters}


def test_solve_kernels_by_launch_time():
    assert operators.solve_kernels(_events(), 27) == pytest.approx(
        (80e-6, 2, 120e-6))
    assert operators.solve_kernels(_events(((0, 100), (140, 200))),
                                   27)[1] == 3
    assert operators.solve_kernels(_events(()), 27) is None
    orphan = [e for e in _events() if e.get("args") != {"correlation": 2}
              or e["cat"] == "kernel"]
    assert operators.solve_kernels(orphan, 27) is None


def test_operator_readers(tmp_path, monkeypatch):
    view = _View(2, _events(), tmp_path, monkeypatch)
    bound = 2 * dia_work(27, 1 << 20).bound_s(view.peaks)
    assert operator_roofline(view) == pytest.approx(100 * bound / 80e-6)
    assert operator_share(view) == pytest.approx(100 * 80 / 120)
    assert load_reader("b2_operator_roofline")(view) == operator_roofline(
        view)
    assert load_reader("pcg_operator_share")(view) == operator_share(view)


@pytest.mark.parametrize("products", [1, 3, 0, None])
def test_operator_readers_refuse_a_count_that_disagrees(
        products, tmp_path, monkeypatch):
    """None where the launches inside the solves are not the port's
    counted operator products, or where the port has no counter."""
    view = _View(products, _events(), tmp_path, monkeypatch)
    assert operator_roofline(view) is None
    assert operator_share(view) is None


def test_operator_readers_need_a_card_and_a_trace(tmp_path, monkeypatch):
    view = _View(2, _events(), tmp_path, monkeypatch)
    view.peaks = None
    assert operator_roofline(view) is None
    view = _View(2, _events(), tmp_path, monkeypatch)
    monkeypatch.setattr(operators, "trace_path",
                        lambda view: tmp_path / "none.json")
    assert operator_share(view) is None


def test_trace_path_names_the_cells_file():
    from portbench.harness.loop import OUT_DIR

    class View:
        cell = _Cell()

    assert operators.trace_path(View()) == (
        OUT_DIR / "hpcg27-256-learned.trace.json")
    View.cell = type("C", (), {"config": {"name": "hpcg27-256"},
                               "traffic": {"name": "nothing"}})()
    assert operators.trace_path(View()) is None
