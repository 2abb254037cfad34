"""The port's generate stage against the reference's: on the numpy
assembly ``python -m deeppreconditioning_tpu_torch.generate_data`` writes
the same files as ``scripts/generate_data.py`` (the archives' arrays and
the text files byte for byte, by sha256), 4 cases in 2-D and 4 in 3-D;
``generate_dataset`` writes what the JAX package's does; the native
assembly route agrees with the numpy one within 1e-13 and with the
reference's native route."""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from deeppreconditioning_tpu import native as jax_native
from deeppreconditioning_tpu.data import fvm as jax_fvm
from deeppreconditioning_tpu_torch import generate_data
from deeppreconditioning_tpu_torch.data import fvm

REPO = Path(__file__).resolve().parents[1]
SAMPLES = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _reference_script():
    spec = importlib.util.spec_from_file_location(
        "reference_generate_data", REPO / "scripts" / "generate_data.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _digests(folder):
    cases = sorted(p for p in folder.iterdir() if p.name.startswith("case_"))
    return [fvm.case_digests(c) for c in cases]


@pytest.mark.parametrize("family", ["2d", "3d"])
def test_generate_data_files_equal_reference(family, tmp_path, monkeypatch):
    monkeypatch.setattr(jax_native, "available", lambda: False)
    argv = ["--samples", str(SAMPLES), "--mesh-cells", "2", "--family",
            family]
    monkeypatch.setattr(sys, "argv", ["generate_data.py", *argv, "--root",
                                      str(tmp_path / "ref")])
    _reference_script().main()
    with fvm.numpy_assembly():
        ours = generate_data.run(generate_data.parse_args(
            [*argv, "--root", str(tmp_path / "port")]), log=lambda _: None)
    suffix = "" if family == "2d" else "_3d"
    ref = _digests(tmp_path / "ref" / f"sludge_patterns{suffix}")
    assert ours == tmp_path / "port" / f"sludge_patterns{suffix}"
    got = _digests(ours)
    assert len(got) == len(ref) == SAMPLES
    assert got == ref
    assert list(got[0]) == [f"matrix.npz/{m}.npy" for m in (
        "row", "col", "format", "shape", "data")] + [
        "right_hand_side.csv", "solution.csv"]


def test_generate_dataset_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(jax_native, "available", lambda: False)
    jax_fvm.generate_dataset(tmp_path / "ref", number_samples=3,
                             mesh_cells=1, seed=5)
    with fvm.numpy_assembly():
        fvm.generate_dataset(tmp_path / "port", number_samples=3,
                             mesh_cells=1, seed=5)
    assert _digests(tmp_path / "port") == _digests(tmp_path / "ref")


def test_native_route_matches_numpy_and_reference():
    """The default route takes the host runtime; A within 1e-13 of the
    numpy route's, equal in pattern; the reference's native route on the
    same draws gives the same matrix."""
    assert fvm.native_assembly()
    for seed in (0, 69420):
        ours = fvm.generate_sludge_case(np.random.default_rng(seed),
                                        mesh_cells=2)
        with fvm.numpy_assembly():
            assert not fvm.native_assembly()
            ref = fvm.generate_sludge_case(np.random.default_rng(seed),
                                           mesh_cells=2)
        assert fvm.native_assembly()
        np.testing.assert_array_equal(ours.matrix.row, ref.matrix.row)
        np.testing.assert_array_equal(ours.matrix.col, ref.matrix.col)
        np.testing.assert_allclose(ours.matrix.data, ref.matrix.data,
                                   rtol=1e-13, atol=0)
        np.testing.assert_array_equal(ours.rhs, ref.rhs)
        jax_case = jax_fvm.generate_sludge_case(np.random.default_rng(seed),
                                                mesh_cells=2)
        np.testing.assert_array_equal(ours.matrix.data, jax_case.matrix.data)
