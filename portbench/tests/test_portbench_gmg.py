"""The multigrid cell (``poisson128-gmg-jacobi``, ``runners/structured_gmg.py``)
at a tiny grid on the CPU: the check passing, each planted fault and the
bf16 control failing it, the counters its traced slice reads; the three
readers it adds on made-up views; its work counts; and its reference's
Galerkin product against the dense one.

The runner's tiny sizes are kept here and registered in the tests'
``TINY`` when this file is collected, so the cells test
(``test_portbench_cells.py``) runs this cell at them too when both files
are collected together.
"""

import json
import math
import time

import pytest
import torch

from _cells import ROOT
from conftest import TINY
from deeppreconditioning_tpu_torch.utils import tracing
from portbench.harness import operators
from portbench.harness.cycles import kernels_per_cycle, solve_kernel_count
from portbench.harness.loop import run_cell
from portbench.harness.spec import load_reader, load_runner
from portbench.reference import gmg as ref
from portbench.work import card_peaks, dia_work, pcg_vector_flops
from portbench.work import gmg as work

CELL = "poisson128-gmg-jacobi"
SIZES = {"grid": [32, 32, 32], "fields": 2, "sample_within": 3,
         "sample_requests": 2, "trace_start_s": 0.2, "trace_slice_s": 0.3}
TINY.setdefault("structured_gmg", SIZES)
NEW = ("setup_galerkin_ms", "setup_root_ms", "kernels_per_cycle")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _run(trace=False, fault=None, seed=2**31 + 11, sizes=SIZES):
    return run_cell(CELL, seed, 0.6, trace, time.perf_counter(),
                    device="cpu", sizes=sizes, fault=fault)


def test_cell_runs_and_counts_its_cycles(monkeypatch):
    """Correct at a tiny grid; the traced slice counts three operator
    products at the start and each iteration, masked ones included, and
    as many V-cycles (``pcg.system_iterations`` plus the solves), and
    reads the setup's spans; no device metric from a CPU run."""
    taken = []
    snapshot = tracing.snapshot
    monkeypatch.setattr(tracing, "snapshot",
                        lambda: taken.append(snapshot()) or taken[-1])
    tracing.reset()
    res = _run(trace=True)
    assert res.line["correct"] is True, res.line["checks"]
    traced = [r for r in res.records if r.traced]
    applies = sum(8 * math.ceil(i / 8) + 1 for r in traced
                  for i in r.iterations)
    counters = taken[0]["counters"]
    assert counters["pcg.system_iterations"] + taken[0]["spans"][
        "pcg.solve"]["calls"] == applies
    assert counters["pcg.operator_products"] == 3 * applies
    assert {"gmg.setup", "gmg.galerkin", "gmg.root"} <= set(
        taken[0]["spans"])
    for name in ("gmg.setup", "gmg.galerkin", "gmg.root"):  # one a request
        assert taken[0]["spans"][name]["calls"] == len(traced)
    metrics = res.line["metrics"]
    for name in ("setup_galerkin_ms", "setup_root_ms", "pcg_iters"):
        assert metrics[name]["value"] > 0
    assert "kernels_per_cycle" not in metrics
    assert all(r.info["field"] == r.k % 2 for r in res.records)


def test_cell_refuses_an_undeclared_cycle(monkeypatch):
    """A port whose ``gmg_apply`` is not declared ``capture_safe`` would
    solve in the eager loop: the cell refuses it before making a field."""
    from deeppreconditioning_tpu_torch.ops import gmg as port_gmg
    from portbench.inputs import poisson

    def undeclared(m, r):
        return port_gmg.gmg_apply(m, r)

    made = []
    monkeypatch.setattr(port_gmg, "gmg_apply", undeclared)
    monkeypatch.setattr(poisson, "generate_fields",
                        lambda *a, **k: made.append(a))
    with pytest.raises(RuntimeError, match="capture_safe"):
        _run()
    assert made == []


@pytest.mark.parametrize("fault", load_runner("structured_gmg").FAULTS)
def test_each_fault_fails_the_check(fault):
    """Stale coarse levels cost 2-3 iterations at 32^3, a margin that the
    CPU's thread count can move by one, and 5 at 64^3: that fault runs
    there."""
    res = _run(fault=fault, sizes=dict(SIZES, grid=[64, 64, 64])
               if fault == "levels_stale" else SIZES)
    assert res.line["correct"] is False
    worst = {name: value / limit for name, value, limit in res.checks}
    if fault == "levels_stale":  # the check is handed a fresh hierarchy
        assert worst["iters_gap"] > 1
        assert max(worst[name] for name in worst if name != "iters_gap") < 1
    else:
        assert worst["true_resid"] > 1000


@pytest.mark.parametrize("broken", ["no_coarse_correction",
                                    "no_post_smoothing", "bf16"])
def test_a_wrong_cycle_fails_the_check(broken, monkeypatch):
    """A cycle that skips its coarse correction or its second sweep, or is
    computed in bf16, in the request's solve and in the cycle the check
    compares: ``cycle_gap`` sees each, as the iterations may not."""
    from deeppreconditioning_tpu_torch.ops import gmg

    right = gmg.gmg_apply

    def wrong(m, r):
        if broken == "bf16":
            z = right(m, r.to(torch.bfloat16).to(r.dtype))
            return z.to(torch.bfloat16).to(r.dtype)
        lev = m.levels[0]
        x = gmg._smooth(lev, r)
        if broken == "no_coarse_correction":
            return x + gmg._smooth(lev, r - gmg.dia_matvec(lev.a, x))
        res = r - gmg.dia_matvec(lev.a, x)
        sub = gmg.replace(m, levels=m.levels[1:])
        xc = right(sub, gmg.restrict_pc(res, lev.shape))
        return x + gmg.prolong_pc(xc, lev.shape)

    wrong.capture_safe = True  # declared as the port's is
    monkeypatch.setattr(gmg, "gmg_apply", wrong)  # the runner loads anew
    res = _run()
    worst = {name: value / limit for name, value, limit in res.checks}
    assert res.line["correct"] is False and worst["cycle_gap"] > 1


def test_control_fails_a_limit():
    res = _run()
    control = res.cell.control(res.kept)
    limits = res.cell.limits
    assert set(control) == set(limits)
    assert any(value > limits[name] for name, value in control.items())


def test_declared_metrics():
    declared = {m["name"]: m for m in BENCH["per_layer"]}
    for name in NEW:
        m = declared[name]
        assert m["workloads"] == [CELL] and m["moves"] == "solves_per_s"
    assert declared["setup_galerkin_ms"]["layer"] == "setups"
    assert declared["setup_root_ms"]["layer"] == "setups"
    assert declared["kernels_per_cycle"]["layer"] == "host dispatch"
    assert declared["kernels_per_cycle"]["source"] == "device_trace"
    for name in ("b2_operator_roofline", "pcg_operator_share",
                 "b1_roofline"):
        assert CELL not in declared[name]["workloads"]
    for name in ("solves_per_s", "solve_p95_ms"):
        e2e = {m["name"]: m for m in BENCH["end_to_end"]}[name]
        assert CELL in e2e["workloads"]


# -- the readers on made-up views ---------------------------------------

def _events():
    """Four kernels launched at 10, 20, 60 (inside the solve, 0-100 us)
    and 150 us, the card's clock 40 us early, one by a graph launch."""
    events = [{"ph": "X", "cat": "user_annotation", "name": "pcg.solve",
               "ts": 0.0, "dur": 100.0}]
    for corr, t in enumerate((10.0, 20.0, 60.0, 150.0)):
        events.append({"ph": "X", "cat": "cuda_runtime",
                       "name": "cudaGraphLaunch" if corr == 1
                       else "cudaLaunchKernel", "ts": t, "dur": 2.0,
                       "args": {"correlation": corr}})
        events.append({"ph": "X", "cat": "kernel", "name": f"k{corr}",
                       "ts": t - 40.0, "dur": 5.0,
                       "args": {"correlation": corr}})
    return events


class _View:
    def __init__(self, counters, spans=None, tmp_path=None,
                 monkeypatch=None):
        if tmp_path is not None:
            path = tmp_path / "cell.trace.json"
            path.write_text(json.dumps({"traceEvents": _events()}))
            monkeypatch.setattr(operators, "trace_path", lambda view: path)
        self.records = [object(), object()]
        self.peaks = card_peaks("NVIDIA H100 80GB HBM3")
        self.program = {"spans": spans or {}, "counters": counters}


def test_solve_kernel_count():
    assert solve_kernel_count(_events()) == 3
    assert solve_kernel_count(_events()[1:]) is None  # no solve span
    orphan = [e for e in _events() if e["cat"] != "cuda_runtime"
              or e["args"]["correlation"] != 2]
    assert solve_kernel_count(orphan) is None


def test_kernels_per_cycle(tmp_path, monkeypatch):
    """Three kernels in one solve of one iteration: two cycles."""
    iterations, solve = {"pcg.system_iterations": 1}, {
        "pcg.solve": {"calls": 1, "device_ms": 0.1}}
    view = _View(iterations, solve, tmp_path=tmp_path,
                 monkeypatch=monkeypatch)
    assert kernels_per_cycle(view) == pytest.approx(1.5)
    assert load_reader("kernels_per_cycle")(view) == pytest.approx(1.5)
    for counters, spans in (({}, solve), (iterations, {})):
        assert kernels_per_cycle(_View(counters, spans, tmp_path=tmp_path,
                                       monkeypatch=monkeypatch)) is None
    view.peaks = None
    assert kernels_per_cycle(view) is None
    monkeypatch.setattr(operators, "trace_path",
                        lambda view: tmp_path / "none.json")
    assert kernels_per_cycle(_View(iterations, solve)) is None


def test_setup_span_readers():
    spans = {"gmg.galerkin": {"calls": 6, "device_ms": 3.0},
             "gmg.root": {"calls": 2, "device_ms": 1.0}}
    view = _View({}, spans)
    assert load_reader("setup_galerkin_ms")(view) == pytest.approx(1.5)
    assert load_reader("setup_root_ms")(view) == pytest.approx(0.5)
    for name in ("setup_galerkin_ms", "setup_root_ms"):  # the parent
        assert load_reader(name)(_View({})) is None


def test_trace_path_of_the_cell():
    from portbench.harness.loop import OUT_DIR

    class View:
        cell = type("C", (), {
            "config": {"name": "poisson3d-128-gmg"},
            "traffic": {"name": "fields8-rhs-gmg"}})()

    assert operators.trace_path(View()) == OUT_DIR / f"{CELL}.trace.json"


# -- work counts and the reference -------------------------------------

def test_work_counts_at_128():
    levels, root = work.hierarchy((128, 128, 128))
    assert [n for n, _ in levels] == [128 ** 3, 64 ** 3, 32 ** 3, 16 ** 3]
    assert root == 512
    got = work.solve_work((128, 128, 128), 18)
    per_apply = dia_work(7, 128 ** 3)  # the PCG's own product
    for side in (128, 64, 32, 16):  # two residuals a level
        per_apply = per_apply + dia_work(7, side ** 3) + dia_work(
            7, side ** 3)
    assert got["b2"].bytes == 19 * per_apply.bytes  # 9 products an apply
    vector = 9 * sum(s ** 3 for s in (128, 64, 32, 16)) + 2 * 512 ** 2
    setup = 8 * sum(s ** 3 for s in (128, 64, 32, 16)) + 2 * 512 ** 3
    assert got["flops"] == setup + 19 * (
        per_apply.flops + vector + pcg_vector_flops(128 ** 3))


def test_reference_galerkin_is_the_dense_product():
    shape = (8, 6, 4)
    gen = torch.Generator().manual_seed(3)
    from portbench.inputs.poisson import poisson_coeff_bands

    op = poisson_coeff_bands(shape, gen, 1.0, "cpu")
    n = op.n
    dense = ref.dense(op.vals, op.offsets, n)
    agg = ref.aggregates(shape, "cpu")
    p = torch.zeros(n, int(agg.max()) + 1, dtype=torch.float64)
    p[torch.arange(n), agg] = 1.0
    vals, offsets = ref.galerkin(op.vals, op.offsets, shape)
    coarse = ref.dense(vals, offsets, p.shape[1])
    assert torch.allclose(coarse, p.T @ dense @ p, rtol=0,
                          atol=1e-12 * float(dense.abs().max()))
    with pytest.raises(ValueError):  # no 7-point operator
        ref.galerkin(op.vals, tuple(o * 2 for o in op.offsets), shape)
