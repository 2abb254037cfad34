"""The readers of the port's graphed PCG chunks (``harness/graphs.py``):
declared as counters of the host dispatch, 100 x ``pcg.graph_chunks``
over the ``pcg.chunk`` calls, and None where there is nothing to read,
a port without graphed chunks included."""

import json
import sys
import types

import pytest

from _cells import ROOT
from portbench.harness.graphs import graph_share
from portbench.harness.spec import load_reader

NAMES = ("pcg_graph_share", "pcg_graph_share.case")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


class _View:
    def __init__(self, records, program):
        self.records, self.program = records, program


def _snap(chunks, graphed):
    spans = {"pcg.chunk": {"calls": chunks}} if chunks is not None else {}
    counters = {"pcg.graph_chunks": graphed} if graphed is not None else {}
    return {"spans": spans, "counters": counters}


@pytest.mark.parametrize("name", NAMES)
def test_declared_and_read_by_name(name):
    declared = {m["name"]: m for m in BENCH["per_layer"]}[name]
    assert declared["source"] == "program_counter"
    assert declared["layer"] == "host dispatch"
    assert declared["unit"] == "%" and declared["better"] == "higher"
    view = _View([object()], _snap(4, 3))
    assert load_reader(name)(view) == pytest.approx(75.0)


@pytest.mark.parametrize("records,snap,want", [
    ([1], _snap(6, 6), 100.0),
    ([1], _snap(6, None), 0.0),
    ([1], _snap(None, None), None),
    ([1], _snap(0, None), None),
    ([], _snap(6, 6), None),
    ([1], None, None),
])
def test_graph_share(records, snap, want):
    assert graph_share(_View(records, snap)) == want


def test_port_without_graphed_chunks(monkeypatch):
    monkeypatch.setitem(sys.modules,
                        "deeppreconditioning_tpu_torch.solvers.cg",
                        types.ModuleType("cg"))
    assert graph_share(_View([1], _snap(6, 6))) is None
