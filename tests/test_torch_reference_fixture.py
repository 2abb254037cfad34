"""The committed JAX reference counts (``scripts/torch_port_reference.py``,
``scripts/torch_port_frames_reference.py``) describe the splits the port
builds: same seed, case count, ``n_pad``, widths and range height H.  The
card compares the counts themselves (``chip_smoke.py``); on the CPU the
port's frames suite reproduces them on three cases, generic plans
included."""

import json
from pathlib import Path

import pytest
import torch

from deeppreconditioning_tpu_torch.bench.__main__ import generate_cases
from deeppreconditioning_tpu_torch.bench.frames import (
    CHECKPOINT,
    FSAI_POWER,
    SAMPLES,
    SEED,
    frames_suite,
)
from deeppreconditioning_tpu_torch.bench.suite import (
    BANDED_SPREAD_CAP,
    BenchmarkSuite,
)
from deeppreconditioning_tpu_torch.data.datasets import SludgePatternDataSet
from deeppreconditioning_tpu_torch.train.checkpoint import load_checkpoint

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "fixtures" / "torch_port" / "percase_iterations.json"


def test_fixture_describes_the_port_split():
    fixture = json.loads(FIXTURE.read_text())
    payload = load_checkpoint(REPO / "assets" / "checkpoints_fsai"
                              / "best.msgpack")
    assert fixture["learned_power"] == int(payload["power"])

    cases = generate_cases(fixture["samples"], fixture["seed"],
                           fixture["mesh_cells"])
    ds = SludgePatternDataSet(stage="test", cases=cases)
    assert len(ds) == fixture["cases"] == 100
    assert ds.dof_pad == fixture["n_pad"] == 1024

    suite = BenchmarkSuite(ds, techniques=("fsai",), device="cpu")
    assert suite.check_every == fixture["check_every"]
    assert suite.fsai_power == fixture["fsai_power"]
    for power in {fixture["fsai_power"], fixture["learned_power"]}:
        width, range_h, _, _ = suite._fsai_meta(ds.dof_pad, power)
        assert range_h == fixture["range_h"]
        assert width <= int(payload["width"])

    for name in ("vanilla", "jacobi", "fsai", "learned"):
        assert len(fixture["iterations"][name]) == len(ds)
        assert all(fixture["success"][name])


FRAMES_FIXTURE = (REPO / "tests" / "fixtures" / "torch_port"
                  / "frames_iterations.json")


@pytest.fixture(scope="module")
def frames():
    """The frames fixture and the port's frames suite (CPU, float32, as
    the fixture's JAX run) over the same 40-case split."""
    fixture = json.loads(FRAMES_FIXTURE.read_text())
    return fixture, frames_suite("cpu", dtype=torch.float32)


def test_frames_fixture_describes_the_port_split(frames):
    fixture, suite = frames
    payload = load_checkpoint(CHECKPOINT)
    ds = suite.data_set
    assert (fixture["seed"], fixture["samples"], fixture["family"]) == (
        SEED, SAMPLES, "frame_structures")
    assert len(ds) == fixture["cases"] == 40
    assert ds.dof_pad == fixture["n_pad"] == 768
    assert fixture["fsai_power"] == suite.fsai_power == FSAI_POWER
    assert fixture["learned_power"] == suite.learned_power == int(
        payload["power"])
    assert fixture["check_every"] == suite.check_every
    assert (fixture["rtol"], fixture["max_iter"]) == (suite.rtol,
                                                      suite.max_iter)
    width, range_h, _, _ = suite._fsai_meta(ds.dof_pad, FSAI_POWER)
    assert (width, range_h) == (fixture["widths"]["fsai"],
                                fixture["range_h"]) == (41, 256)
    assert fixture["widths"]["learned"] == int(payload["width"]) == 41
    assert len(fixture["generic_cases"]["fsai"]) == 9
    for name in ("vanilla", "jacobi", "fsai", "learned"):
        assert len(fixture["iterations"][name]) == len(ds)
        assert len(fixture["success"][name]) == len(ds)


# Per-case iterations may differ from the JAX CPU float32 run by this
# much: fsai and learned not at all; jacobi by the card's per-case bound;
# unpreconditioned float32 CG drifts on these stiff systems (ROADMAP C).
ALLOWED = {"vanilla": lambda ref: 0.05 * ref, "jacobi": lambda ref: 2,
           "fsai": lambda ref: 0, "learned": lambda ref: 0}


@pytest.mark.parametrize("index", [0, 2, 25])
def test_port_frames_cases_match_the_fixture(frames, index):
    """The port's suite on the CPU in float32 takes the same plan kind as
    the JAX run and converges as it does (0 and 2 are generic cases, 25 a
    range case)."""
    fixture, suite = frames
    _, ell, b = suite._system(index)
    for name, allowed in ALLOWED.items():
        with torch.no_grad():
            res = suite._solve(ell, b, *suite.setup(name, index))
        ref = fixture["iterations"][name][index]
        assert abs(int(res.iterations) - ref) <= allowed(ref), (
            name, int(res.iterations), ref)
        assert bool(float(res.residual) < suite.rtol) == (
            fixture["success"][name][index])
    for name in ("fsai", "learned"):
        generic = index in fixture["generic_cases"][name]
        assert (index in suite.generic_cases[name]) == generic, name


BATCHED_FIXTURE = (REPO / "tests" / "fixtures" / "torch_port"
                   / "batched_iterations.json")
# BENCH_r05 (bench.py's driver record): hardware-independent mean counts
BENCH_R05_BATCHED = {"jacobi": 99.19, "fsai": 23.15, "learned": 7.58}
BENCH_R05_IRREGULAR = {"jacobi": 52.2, "learned": 13.85}


@pytest.fixture(scope="module")
def batched_fixture():
    return json.loads(BATCHED_FIXTURE.read_text())


def test_batched_fixture_describes_the_port_split(batched_fixture):
    from deeppreconditioning_tpu_torch.bench import irregular

    fx = batched_fixture
    assert (fx["seed"], fx["samples"], fx["mesh_cells"]) == (69420, 500, 2)
    assert (fx["cases"], fx["n_pad"]) == (100, 1024)
    suite = BenchmarkSuite(None, techniques=("fsai",), device="cpu")
    assert (fx["check_every"], fx["ic_neumann_sweeps"], fx["rtol"],
            fx["max_iter"]) == (suite.check_every, suite.ic_neumann_sweeps,
                                suite.rtol, suite.max_iter)
    per = fx["percase"]
    for name in ("incomplete_cholesky", "incomplete_cholesky_neumann",
                 "algebraic_multigrid"):
        assert len(per["iterations"][name]) == 100
        assert all(per["success"][name])
    bat = fx["batched"]
    assert bat["techniques"] == list(BenchmarkSuite._BATCHED_CHECK_EVERY)
    assert bat["check_every"] == BenchmarkSuite._BATCHED_CHECK_EVERY
    assert bat["learned_apply"] == "banded"
    assert bat["learned_d_max"] <= BANDED_SPREAD_CAP
    for name in bat["techniques"]:
        iters = bat["iterations"][name]
        assert len(iters) == 100 and bat["success"][name] == 100.0
        assert bat["trips"][name] == max(iters) + 2
        assert bat["m_dtype"][name] in ("bfloat16", "float32")
    irr = fx["irregular"]
    assert (irr["seed"], irr["samples"], irr["cases"]) == (
        irregular.SEED, irregular.SAMPLES, 20)
    assert irr["fsai_power"] == irr["learned_power"] == irregular.POWER
    for name in irregular.TECHNIQUES:
        assert len(irr["iterations"][name]) == 20
        assert len(irr["iterations_f64"][name]) == 20
        assert all(irr["success"][name])
    # the permuted (odd) cases leave the range plan
    for name in ("fsai", "learned"):
        assert set(range(1, 20, 2)) <= set(irr["generic_cases"][name])


@pytest.mark.parametrize("part,name", [
    ("batched", "jacobi"), ("batched", "fsai"), ("batched", "learned"),
    ("irregular", "jacobi"), ("irregular", "learned")])
def test_batched_fixture_against_bench_r05(batched_fixture, part, name):
    """The JAX CPU float32 means against bench.py's driver record
    (BENCH_r05, a TPU v5e): within 1%, except the batched learned mean,
    7.71 against 7.58 (1.7%), a gap ROADMAP C records."""
    record = (BENCH_R05_BATCHED if part == "batched"
              else BENCH_R05_IRREGULAR)[name]
    mean = batched_fixture[part]["mean_iterations"][name]
    limit = 0.02 if (part, name) == ("batched", "learned") else 0.01
    assert abs(mean - record) <= limit * record, (mean, record)
