"""Every cell end to end at a tiny size on the CPU: a line with the
contract's keys, the check passing, the traced run's per-layer metrics;
and, with the timed path broken, ``correct`` false."""

import json
import time

import pytest
import torch

from _cells import cells
from conftest import TINY
from portbench.harness.loop import run_cell
from portbench.harness.spec import load_runner
from portbench.run import _finite

CELLS = cells()
KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def _run(workload, runner, trace=False, fault=None, seed=2**31 + 5):
    return run_cell(workload, seed, 0.6, trace, time.perf_counter(),
                    device="cpu", sizes=TINY[runner], fault=fault)


@pytest.mark.parametrize("workload,runner", CELLS)
def test_cell_prints_a_contract_line(workload, runner):
    res = _run(workload, runner)
    line = json.loads(json.dumps(_finite(res.line)))
    assert KEYS <= set(line)
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2
    for name, check in line["checks"].items():
        assert check["value"] <= check["limit"], name


@pytest.mark.parametrize("workload,runner", CELLS)
def test_traced_run_reads_its_spans(workload, runner):
    res = _run(workload, runner, trace=True)
    metrics = res.line["metrics"]
    assert "setup_s" not in metrics
    assert any(name.split(".")[0].endswith("_ms") and m["value"] > 0
               for name, m in metrics.items())
    assert "busy_s" in res.line["device"] and "breakdown" in res.line
    # no card: no device metric is written from a CPU run
    assert not any(word in name for name in metrics
                   for word in ("device_idle", "mfu", "roofline"))


@pytest.mark.parametrize("workload,runner,fault", [
    (w, d, f) for w, d in CELLS for f in load_runner(d).FAULTS])
def test_broken_timed_path_is_not_correct(workload, runner, fault):
    res = _run(workload, runner, fault=fault)
    assert res.line["correct"] is False
    assert res.line["failed"] >= 1 or any(
        value > limit for _, value, limit in res.checks)


@pytest.mark.parametrize("workload,runner", CELLS)
def test_control_is_not_correct(workload, runner):
    """The reference in bfloat16 in the program's place fails one of the
    cell's limits."""
    res = _run(workload, runner)
    control = res.cell.control(res.kept)
    limits = res.cell.limits
    assert any(value > limits[name] for name, value in control.items())


@pytest.mark.cuda
@pytest.mark.parametrize("workload,runner", CELLS)
def test_cell_on_the_card(workload, runner, cuda_device):
    """The cell at its own sizes for two seconds on the card: correct,
    and the control fails a limit."""
    res = run_cell(workload, 2**31 + 9, 2.0, False, time.perf_counter(),
                   device=cuda_device)
    assert res.line["correct"] is True, res.line["checks"]
    control = res.cell.control(res.kept)
    assert any(value > res.cell.limits[name]
               for name, value in control.items())
    torch.cuda.empty_cache()
