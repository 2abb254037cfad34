"""The per-layer metrics that read the port's own spans and counters
(``harness/program.py``): a traced run of every cell at a tiny size on
the CPU reports each of its metrics of the kind as a finite number, and
the ``pcg.chunk`` calls of the slice are the chunks its requests'
iterations imply."""

import json
import math
import time

import pytest

from _cells import ROOT, cells
from conftest import TINY
from deeppreconditioning_tpu_torch.utils import tracing
from portbench.harness.loop import run_cell

CELLS = cells()
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
PROGRAM_METRICS = (  # the readers of harness/program.py
    "pcg_masked_share", "pcg_masked_share.case", "pcg_chunk_enqueue_us",
    "pcg_chunk_enqueue_us.case", "pcg_read_wait_ms", "pcg_read_wait_ms.case",
    "setup_forward_ms.case", "setup_wrap_ms.case", "setup_columns_ms",
    "setup_refine_ms", "setup_safeguard_ms", "step_forward_ms",
    "step_backward_ms", "step_adam_ms")


def _program_metrics(workload):
    return {m["name"] for m in BENCH["per_layer"]
            if m["name"] in PROGRAM_METRICS
            and workload in m.get("workloads", [workload])}


def test_each_program_metric_is_declared_and_read_by_name():
    declared = {m["name"]: m for m in BENCH["per_layer"]}
    for name in PROGRAM_METRICS:
        assert declared[name]["source"] in ("program_span", "program_counter")
        reader = ROOT / "portbench" / "metrics" / f"{name}.py"
        assert "harness.program import" in reader.read_text(), name


@pytest.mark.parametrize("workload,runner", CELLS)
def test_traced_run_reports_the_ports_spans(workload, runner, monkeypatch):
    taken = []
    snapshot = tracing.snapshot

    def spy():
        taken.append(snapshot())
        return taken[-1]

    monkeypatch.setattr(tracing, "snapshot", spy)
    tracing.reset()
    res = run_cell(workload, 2**31 + 11, 0.6, True, time.perf_counter(),
                   device="cpu", sizes=TINY[runner])
    metrics = res.line["metrics"]
    want = _program_metrics(workload)
    assert want
    for name in want:
        assert name in metrics, name
        assert math.isfinite(metrics[name]["value"]), name
    for name in want & {"pcg_masked_share", "pcg_masked_share.case"}:
        assert 0.0 <= metrics[name]["value"] < 100.0
    assert len(taken) == 1  # one snapshot a view, then the tracer is reset
    assert tracing.snapshot() == {"spans": {}, "counters": {}}

    traced = [r for r in res.records if r.traced]
    spans = taken[0]["spans"]
    if runner == "train_fsai":
        assert "pcg.chunk" not in spans
        assert spans["train.forward"]["calls"] == len(traced)
        return
    check_every = int(json.loads(
        (ROOT / "portbench" / "traffic"
         / f"{_traffic(workload)}.json").read_text())["check_every"])
    if runner == "batched_learned":  # every case until the slowest stops
        chunks = sum(math.ceil(max(r.iterations) / check_every)
                     for r in traced)
        assert res.line["route"].get("float32", 0) == 0
    else:
        chunks = sum(math.ceil(i / check_every)
                     for r in traced for i in r.iterations)
    assert spans["pcg.chunk"]["calls"] == chunks
    assert spans["pcg.solve"]["calls"] == len(traced)
    assert spans["pcg.read"]["calls"] == chunks + len(traced)


def _traffic(workload):
    return {w["name"]: w["traffic"] for w in BENCH["workloads"]}[workload]
