"""The whole slice against the JAX package on the same saved sludge cases:
the per-case IC(0), IC-Neumann and AMG techniques (f64, counts equal),
``run_batched`` with the float32 M (f64, per-case counts and trips
equal) and with the bf16-first attempt (float32 on both sides, counts
within 2 and the same attempt settled on), and the tables' headers."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppreconditioning_tpu import native as jax_native
from deeppreconditioning_tpu.bench.suite import BenchmarkSuite as JaxSuite
from deeppreconditioning_tpu.data.datasets import (
    SludgePatternDataSet as JaxDataSet,
)
from deeppreconditioning_tpu.models import NeuralFSAI as JaxNeuralFSAI
from deeppreconditioning_tpu.models import plan_builder_for
from deeppreconditioning_tpu.train.trainer import (
    load_checkpoint as jax_load_checkpoint,
)
from deeppreconditioning_tpu_torch.bench.suite import (
    BATCHED_KEYS,
    TECHNIQUES,
    BenchmarkSuite,
)
from deeppreconditioning_tpu_torch.data.datasets import SludgePatternDataSet
from deeppreconditioning_tpu_torch.data.fvm import (
    generate_sludge_case,
    save_case,
)
from deeppreconditioning_tpu_torch.models.neural_fsai import (
    neural_fsai_from_checkpoint,
)
from deeppreconditioning_tpu_torch.train.checkpoint import load_checkpoint
from deeppreconditioning_tpu_torch.data.fvm import numpy_assembly


@pytest.fixture(autouse=True, scope="module")
def _numpy_fvm_assembly():
    """The port's numpy FVM assembly: the route the reference's counts
    and arrays held here were made on."""
    with numpy_assembly():
        yield


CKPT = (Path(__file__).resolve().parents[1] / "assets" / "checkpoints_fsai"
        / "best.msgpack")
NEW = ("incomplete_cholesky", "incomplete_cholesky_neumann",
       "algebraic_multigrid")
BATCHED = ("vanilla", "jacobi", "incomplete_cholesky_neumann",
           "algebraic_multigrid", "fsai", "learned")
# the bf16 attempt's two forms: a rounded dense M (fsai; AMG shares its
# code) and bf16 bands with the bf16 inner matvec (learned)
BF16 = ("fsai", "learned")


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """20 saved cases (4 in the test split), the JAX and port datasets and
    the flagship checkpoint."""
    root = tmp_path_factory.mktemp("raw")
    rng = np.random.default_rng(17)
    for i in range(20):
        save_case(generate_sludge_case(rng, mesh_cells=1),
                  root / "sludge_patterns" / f"case_{i:04d}")
    jax_ds = JaxDataSet(stage="test", batch_size=1,
                        specs=plan_builder_for("NeuralFSAI", None),
                        shuffle=False, root=root)
    ds = SludgePatternDataSet(stage="test", root=root)
    assert len(ds) == len(jax_ds) == 4
    return root, jax_ds, ds, jax_load_checkpoint(CKPT)


def _suites(split, tmp, techniques, jax_dtype, dtype, kappa_cases=0):
    _, jax_ds, ds, payload = split
    power = int(payload["power"])
    ref = JaxSuite(
        jax_ds,
        JaxNeuralFSAI(width=int(payload["width"]),
                      hidden=int(payload["hidden"]),
                      poly_degree=int(payload["poly_degree"])),
        payload["params"], techniques=techniques, dtype=jax_dtype,
        timing_reps=1, kappa_cases=kappa_cases, learned_power=power,
        results_directory=tmp / "jax")
    ours = BenchmarkSuite(
        ds, neural_fsai_from_checkpoint(load_checkpoint(CKPT)),
        techniques=techniques, device="cpu", dtype=dtype, timing_reps=1,
        kappa_cases=kappa_cases, learned_power=power,
        results_directory=tmp / "torch")
    return ref, ours


def test_techniques_are_bench_pys():
    assert TECHNIQUES == ("vanilla", "jacobi", "incomplete_cholesky",
                          "incomplete_cholesky_neumann",
                          "algebraic_multigrid", "fsai", "learned")
    assert tuple(BenchmarkSuite._BATCHED_CHECK_EVERY) == BATCHED


def test_percase_new_techniques_match_jax(split, tmp_path, monkeypatch):
    monkeypatch.setattr(jax_native, "available", lambda: False)
    ref, ours = _suites(split, tmp_path, NEW, jnp.float64, torch.float64,
                        kappa_cases=1)
    ref.run()
    ours.run()
    for name in NEW:
        assert ours.iterations[name] == ref.iterations[name], name
        assert ours.successes[name] == ref.successes[name] == [100.0] * 4
        np.testing.assert_allclose(ours.densities[name],
                                   ref.densities[name], rtol=1e-12)
        np.testing.assert_allclose(ours.kappas[name][:1],
                                   ref.kappas[name][:1], rtol=1e-6)
        assert ours.setup_calls[name] > 0
        # the public per-case setup builds what run() solved with
        for index in range(4):
            _, ell, b = ours._system(index)
            res = ours._solve(ell, b, *ours.setup(name, index))
            assert int(res.iterations) == ours.iterations[name][index]
    ref.dump_csv()
    ours.dump_csv()
    for table in ("table.csv", "totals.csv"):
        assert ((tmp_path / "torch" / table).read_text().splitlines()[0]
                == (tmp_path / "jax" / table).read_text().splitlines()[0])


def test_run_batched_matches_jax(split, tmp_path, monkeypatch):
    monkeypatch.setattr(jax_native, "available", lambda: False)
    ref, ours = _suites(split, tmp_path, TECHNIQUES, jnp.float64,
                        torch.float64)
    want = ref.run_batched(reps=1, setup_reps=1, chunk=4, m_dtype=None)
    got = ours.run_batched(reps=1, setup_reps=1, chunk=4, m_dtype=None)
    assert list(got) == list(want) == list(BATCHED)
    for name in BATCHED:
        assert got[name]["iterations_per_case"] == (
            want[name]["iterations_per_case"]), name
        for key in ("trips", "iterations_max", "success", "cases"):
            assert got[name][key] == want[name][key], (name, key)
        assert got[name]["m_dtype"] == "float32"
    # one B1 launch per plan group and build (the CPU takes B1's plain
    # version, so the count is the suite's own)
    for name in ("fsai", "learned"):
        assert ours.batched_launch_groups[name] == ours.batched_builds[name]
    ref.dump_csv_batched()
    ours.dump_csv_batched()
    header = (tmp_path / "torch" / "batched.csv").read_text().splitlines()[0]
    assert header == (tmp_path / "jax" / "batched.csv").read_text(
        ).splitlines()[0] == "technique," + ",".join(BATCHED_KEYS)


def test_run_batched_bf16_attempt_matches_jax(split, tmp_path, monkeypatch):
    """bf16 M (fsai) and bf16 bands (learned) in float32 runs: counts
    within 2 per case of the JAX run, the same attempt settled on."""
    ref, ours = _suites(split, tmp_path, TECHNIQUES, jnp.float32,
                        torch.float32)
    settled = {}
    inner = ref._batched_setup

    def recording(name, setup_reps, chunk, m_dtype=None):
        settled[name] = "float32" if m_dtype is None else "bfloat16"
        return inner(name, setup_reps, chunk, m_dtype=m_dtype)

    monkeypatch.setattr(ref, "_batched_setup", recording)
    want = ref.run_batched(techniques=BF16, reps=1, setup_reps=1, chunk=4)
    got = ours.run_batched(techniques=BF16, reps=1, setup_reps=1, chunk=4)
    for name in BF16:
        delta = np.abs(np.subtract(got[name]["iterations_per_case"],
                                   want[name]["iterations_per_case"]))
        assert delta.max() <= 2, name
        assert got[name]["m_dtype"] == settled[name] == "bfloat16", name
        assert got[name]["success"] == want[name]["success"] == 100.0
