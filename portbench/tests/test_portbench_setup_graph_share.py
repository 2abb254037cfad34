"""The reader of the port's graphed learned setups
(``metrics/setup_graph_share.case.py``): declared as a counter of the host
dispatch, 100 x ``fsai.graph_setups`` over the ``fsai.setup`` calls, and
None where there is nothing to read, a port without graphed setups
included."""

import json

import pytest

from _cells import ROOT
from deeppreconditioning_tpu_torch.models import neural_fsai
from portbench.harness.spec import load_reader

NAME = "setup_graph_share.case"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


class _View:
    def __init__(self, records, program):
        self.records, self.program = records, program


def _snap(setups, graphed):
    spans = {"fsai.setup": {"calls": setups}} if setups is not None else {}
    counters = {"fsai.graph_setups": graphed} if graphed is not None else {}
    return {"spans": spans, "counters": counters}


def test_declared_and_read_by_name():
    declared = {m["name"]: m for m in BENCH["per_layer"]}[NAME]
    assert declared["source"] == "program_counter"
    assert declared["layer"] == "host dispatch"
    assert declared["unit"] == "%" and declared["better"] == "higher"
    assert declared["moves"] == "case_solves_per_s"
    assert declared["workloads"] == ["sludge2d-percase-learned"]
    assert load_reader(NAME)(_View([object()], _snap(4, 3))) == (
        pytest.approx(75.0))


@pytest.mark.parametrize("records,snap,want", [
    ([1], _snap(6, 6), 100.0),
    ([1], _snap(6, None), 0.0),
    ([1], _snap(None, None), None),
    ([1], _snap(0, None), None),
    ([], _snap(6, 6), None),
    ([1], None, None),
])
def test_setup_graph_share(records, snap, want):
    assert load_reader(NAME)(_View(records, snap)) == want


def test_port_without_graphed_setups(monkeypatch):
    monkeypatch.delattr(neural_fsai, "SETUP_GRAPHS")
    assert load_reader(NAME)(_View([1], _snap(6, 6))) is None
