"""The conv families' learned technique in the port's suite against the
JAX package's, float64 with float64 weights on both sides, on generated
sludge cases: per-case iterations, success, density and kappa equal, the
dense M and the factor values to rtol 1e-10; then the test-stage entry
point on the CPU."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppreconditioning_tpu.bench.suite import BenchmarkSuite as JaxSuite
from deeppreconditioning_tpu.bench.suite import (
    _learned_factor_values as jax_factor_values,
    _learned_setup_device as jax_setup_device,
)
from deeppreconditioning_tpu.data.datasets import (
    SludgePatternDataSet as JaxDataSet,
)
from deeppreconditioning_tpu.models import PreconditionerNet as JaxNet
from deeppreconditioning_tpu.models import (
    PreconditionerSparseUNet as JaxUNet,
)
from deeppreconditioning_tpu.models import plan_builder_for as jax_builder
from deeppreconditioning_tpu.train.trainer import (
    load_checkpoint as jax_load_checkpoint,
)
from deeppreconditioning_tpu_torch import test as test_entry
from deeppreconditioning_tpu_torch.bench.suite import (
    ALL_TECHNIQUES,
    TABLE_PARAMETERS,
    BenchmarkSuite,
)
from deeppreconditioning_tpu_torch.data.datasets import SludgePatternDataSet
from deeppreconditioning_tpu_torch.data.fvm import (
    generate_sludge_case,
    save_case,
)
from deeppreconditioning_tpu_torch.models import (
    conv_model_from_checkpoint,
    plan_builder_for,
)
from deeppreconditioning_tpu_torch.train.checkpoint import load_checkpoint
from deeppreconditioning_tpu_torch.data.fvm import numpy_assembly


@pytest.fixture(autouse=True, scope="module")
def _numpy_fvm_assembly():
    """The port's numpy FVM assembly: the route the reference's counts
    and arrays held here were made on."""
    with numpy_assembly():
        yield


ASSETS = Path(__file__).resolve().parents[1] / "assets"
CHANNELS = (1, 16, 32, 64, 32, 16, 1)
JAX_MODELS = {"PreconditionerNet": JaxNet,
              "PreconditionerSparseUNet": JaxUNet}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small CPU tensors: a pool of eight
    costs more than the work, most of all in a loaded test run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cases():
    rng = np.random.default_rng(31)
    return [generate_sludge_case(rng, mesh_cells=1) for _ in range(10)]


@pytest.mark.parametrize("model_name,ckpt,apply", [
    ("PreconditionerNet", "checkpoints", "dense"),
    ("PreconditionerNet", "checkpoints", "factor"),
    ("PreconditionerSparseUNet", "checkpoints_unet", "dense"),
])
def test_suite_matches_jax(tmp_path, cases, model_name, ckpt, apply):
    root = tmp_path / "raw"
    for i, case in enumerate(cases):
        save_case(case, root / "sludge_patterns" / f"case_{i:04d}")
    path = ASSETS / ckpt / "best.msgpack"
    params = jax.tree.map(lambda x: np.asarray(x, np.float64),
                          jax_load_checkpoint(path)["params"])
    jax_model = JAX_MODELS[model_name](channels=CHANNELS)
    jax_ds = JaxDataSet(stage="test", batch_size=1, shuffle=False,
                        root=root, specs=jax_builder(model_name, CHANNELS))
    kappa_cases = int(apply == "dense")  # one JAX compile less for factor
    ref = JaxSuite(jax_ds, jax_model, params, techniques=("learned",),
                   dtype=jnp.float64, timing_reps=1, kappa_cases=kappa_cases,
                   learned_apply=apply, results_directory=tmp_path / "jax")
    ref.run()

    ds = SludgePatternDataSet(stage="test", root=root,
                              specs=plan_builder_for(model_name, CHANNELS))
    model = conv_model_from_checkpoint(model_name, load_checkpoint(path))
    ours = BenchmarkSuite(ds, model, techniques=("learned",), device="cpu",
                          dtype=torch.float64, timing_reps=1,
                          kappa_cases=kappa_cases,
                          learned_apply=apply,
                          results_directory=tmp_path / "torch")
    ours.run()
    assert len(ds) == 2
    assert ours.iterations["learned"] == ref.iterations["learned"]
    assert ours.successes["learned"] == ref.successes["learned"] == [100.0] * 2
    np.testing.assert_allclose(ours.densities["learned"],
                               ref.densities["learned"], rtol=1e-12)
    np.testing.assert_allclose(ours.kappas["learned"][:1],
                               ref.kappas["learned"][:1], rtol=1e-6)
    for index in range(len(ds)):
        jb = jax_ds[index]
        n0 = jax_ds.host_sample(index).original_size
        args = (jax_model, ref.params, jb.features, jb.plans, jb.scales,
                jnp.int32(n0))
        with torch.no_grad():
            apply_m, m_data = ours.setup("learned", index)
        if apply == "factor":
            got = m_data[1]
            want = jax_factor_values(*args, dtype=jnp.float64)
        else:
            got = m_data
            want = jax_setup_device(*args, dtype=jnp.float64)[0]
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-10, atol=1e-10 * float(
                                       np.abs(np.asarray(want)).max()))
    with pytest.raises(ValueError, match="NeuralFSAI"):
        ours.run_batched(techniques=("learned",))


def test_entry_point_on_cpu(tmp_path, cases, monkeypatch):
    ckpt = str(ASSETS / "checkpoints" / "best.msgpack")
    argv = ["--device", "cpu", "--model", "PreconditionerNet",
            "--checkpoint", ckpt, "--techniques", "vanilla,jacobi,learned",
            "--kappa-cases", "1", "--timing-reps", "1",
            "--results-dir", str(tmp_path)]
    suite = test_entry.run(test_entry.parse_args(argv), cases=cases,
                           learned_apply="factor")
    assert suite.device.type == "cpu" and suite.learned_apply == "factor"
    assert suite.successes["learned"] == [100.0] * 2
    assert suite.prep_seconds["conv_plans"] == suite.data_set.plan_seconds > 0
    # the data set serves host batches; the suite moves each case once
    assert suite.data_set[0].features.device.type == "cpu"
    assert suite._conv_batch(0) is suite._conv_batch(0)
    header = (tmp_path / "table.csv").read_text().splitlines()[0]
    assert header == "technique," + ",".join(TABLE_PARAMETERS)
    assert (tmp_path / "totals.csv").read_text().splitlines()[0] == \
        "vanilla,jacobi,learned"
    assert (tmp_path / "eigenvalues.csv").exists()

    # NeuralFSAI: width, hidden, degree and power from the payload
    fsai = test_entry.run(test_entry.parse_args([
        "--device", "cpu", "--model", "NeuralFSAI", "--techniques",
        "learned", "--kappa-cases", "0", "--timing-reps", "1",
        "--fsai-power", "3", "--results-dir", str(tmp_path / "fsai")]),
        cases=cases)
    assert (fsai.learned_power, fsai.fsai_power) == (3, 3)
    assert fsai.data_set.specs is None and fsai.model.width == 24

    # 'all' runs the reference's eight; the guard refuses an unknown name
    every = test_entry.run(test_entry.parse_args(
        argv[:6] + ["--techniques", "all", "--kappa-cases", "0",
                    "--timing-reps", "1", "--results-dir",
                    str(tmp_path / "all")]), cases=cases)
    assert every.techniques == ALL_TECHNIQUES
    assert all(every.successes[name] == [100.0] * 2
               for name in every.techniques)
    with pytest.raises(ValueError, match="techniques not ported"):
        test_entry.run(test_entry.parse_args(
            argv[:6] + ["--techniques", "vanilla,no_such_technique"]),
            cases=cases)
    with pytest.raises(ValueError, match="not a conv model"):
        conv_model_from_checkpoint("NeuralFSAI", {})
    with pytest.raises(ValueError, match="no PreconditionerNet param"):
        test_entry.run(test_entry.parse_args(argv[:4]), cases=cases)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        test_entry.run(test_entry.parse_args(argv[2:]), cases=cases)

