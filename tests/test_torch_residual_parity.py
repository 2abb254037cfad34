"""The port's residual-parity report against the JAX reference's
(``scripts/torch_port_residual_parity_reference.py``'s fixture, numpy
assembly): on the first 2 cases, every technique's float64 iterations
equal and its float64 residual curve within rtol 1e-6 of the
reference's, its float32 iterations within 2; the CSV has the
reference's columns.  Also the generate stage's digests of those cases
against the fixture's."""

import csv
import json
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from deeppreconditioning_tpu_torch import residual_parity
from deeppreconditioning_tpu_torch.data.fvm import (
    case_digests,
    generate_dataset,
    numpy_assembly,
)

FIXTURE = (Path(__file__).resolve().parent / "fixtures" / "torch_port"
           / "residual_parity.json")
CASES = 2
CURVE_RTOL = 1e-6


@pytest.fixture(scope="module")
def runs():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with numpy_assembly():
            rows = residual_parity.run(CASES, device="cpu",
                                       log=lambda _: None)
    finally:
        torch.set_num_threads(saved)
    return {(r["case"], r["technique"], r["dtype"]): r for r in rows}


REF = json.loads(FIXTURE.read_text())
KEYS = [(r["case"], r["technique"], r["dtype"]) for r in REF["rows"]
        if r["case"] < CASES]


def test_fixture_describes_the_report():
    assert (REF["seed"], REF["mesh_cells"]) == (residual_parity.SEED,
                                                residual_parity.MESH_CELLS)
    assert len(KEYS) == CASES * 5 * 2


@pytest.mark.parametrize("key", KEYS, ids=["-".join(map(str, k))
                                           for k in KEYS])
def test_counts_and_curves_match_reference(runs, key):
    ref = next(r for r in REF["rows"]
               if (r["case"], r["technique"], r["dtype"]) == key)
    got = runs[key]
    if key[2] == "f64":
        assert got["iterations"] == ref["iterations"]
        k = min(len(got["curve"]), len(ref["curve"]))
        np.testing.assert_allclose(got["curve"][:k], ref["curve"][:k],
                                   rtol=CURVE_RTOL, atol=0)
    else:
        assert abs(got["iterations"] - ref["iterations"]) <= 2
    assert got["final_sq_rel_residual"] < 1e-8


def test_csv_has_reference_columns(runs, tmp_path):
    path = tmp_path / "residual_parity.csv"
    residual_parity.write_csv(path, list(runs.values()))
    with path.open() as fio:
        rows = list(csv.DictReader(fio))
    assert list(rows[0]) == ["case", "technique", "dtype", "iterations",
                             "final_sq_rel_residual", "curve"]
    assert len(rows[0]["curve"].split(";")) == int(rows[0]["iterations"])
    assert residual_parity.summarize(list(runs.values()),
                                     log=lambda _: None) <= 2


def test_generated_files_match_reference_digests():
    with tempfile.TemporaryDirectory() as tmp, numpy_assembly():
        generate_dataset(Path(tmp), number_samples=CASES,
                         mesh_cells=REF["mesh_cells"], seed=REF["seed"])
        got = [case_digests(Path(tmp) / f"case_{i:04d}")
               for i in range(CASES)]
    assert got == REF["generate"]["digests"][:CASES]
