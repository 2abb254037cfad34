"""The reader of the port's fused PCG iteration
(``metrics/pcg_fused_share.py``, ``.case.py``): declared as a counter of
the solver, 100 x ``pcg.fused_iterations`` over ``pcg.system_iterations``,
and None where there is nothing to read, a port without the counter
included."""

import json

import pytest

from _cells import ROOT
from portbench.harness.fused import fused_share
from portbench.harness.spec import load_reader

NAMES = {"pcg_fused_share": "solves_per_s",
         "pcg_fused_share.case": "case_solves_per_s"}
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


class _View:
    def __init__(self, records, program):
        self.records, self.program = records, program


def _snap(executed, fused):
    counters = {}
    if executed is not None:
        counters["pcg.system_iterations"] = executed
    if fused is not None:
        counters["pcg.fused_iterations"] = fused
    return {"spans": {}, "counters": counters}


@pytest.mark.parametrize("name", list(NAMES))
def test_declared_and_read_by_name(name):
    declared = {m["name"]: m for m in BENCH["per_layer"]}[name]
    assert declared["source"] == "program_counter"
    assert declared["layer"] == "solver"
    assert declared["moves"] == NAMES[name]
    assert declared["unit"] == "%" and declared["better"] == "higher"
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(declared["workloads"]) <= cells
    view = _View([object()], _snap(16, 8))
    assert load_reader(name)(view) == pytest.approx(50.0)


@pytest.mark.parametrize("records,snap,want", [
    ([1], _snap(24, 24), 100.0),
    ([1], _snap(24, None), None),  # a port without the counter
    ([1], _snap(0, 0), None),
    ([1], _snap(None, None), None),
    ([], _snap(8, 8), None),
    ([1], None, None),
])
def test_fused_share(records, snap, want):
    assert fused_share(_View(records, snap)) == want
