"""The whole slice: the port's per-case suite against the JAX package's on
the same saved cases, float64, vanilla / jacobi / fsai / learned with the
flagship checkpoint.  Per-case iteration counts must be equal and the
table header identical."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppreconditioning_tpu.bench.suite import BenchmarkSuite as JaxSuite
from deeppreconditioning_tpu.data.datasets import (
    SludgePatternDataSet as JaxDataSet,
)
from deeppreconditioning_tpu.models import NeuralFSAI as JaxNeuralFSAI
from deeppreconditioning_tpu.models import plan_builder_for
from deeppreconditioning_tpu.train.trainer import (
    load_checkpoint as jax_load_checkpoint,
)
from deeppreconditioning_tpu_torch.bench.suite import BenchmarkSuite
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
TECHNIQUES = ("vanilla", "jacobi", "fsai", "learned")


def test_suite_matches_jax_per_case(tmp_path):
    rng = np.random.default_rng(17)
    root = tmp_path / "raw"
    for i in range(20):  # the 80/20 split leaves 4 test cases
        case = generate_sludge_case(rng, mesh_cells=1)
        save_case(case, root / "sludge_patterns" / f"case_{i:04d}")

    payload = jax_load_checkpoint(CKPT)
    power = int(payload["power"])
    jax_ds = JaxDataSet(stage="test", batch_size=1,
                        specs=plan_builder_for("NeuralFSAI", None),
                        shuffle=False, root=root)
    jax_model = JaxNeuralFSAI(width=int(payload["width"]),
                              hidden=int(payload["hidden"]),
                              poly_degree=int(payload["poly_degree"]))
    ref = JaxSuite(jax_ds, jax_model, payload["params"],
                   techniques=TECHNIQUES, dtype=jnp.float64,
                   timing_reps=1, kappa_cases=1, learned_power=power,
                   results_directory=tmp_path / "jax")
    ref.run()
    ref.dump_csv()

    ds = SludgePatternDataSet(stage="test", root=root)
    assert len(ds) == len(jax_ds) == 4
    model = neural_fsai_from_checkpoint(load_checkpoint(CKPT))
    ours = BenchmarkSuite(ds, model, techniques=TECHNIQUES, device="cpu",
                          dtype=torch.float64, timing_reps=1, kappa_cases=1,
                          learned_power=power,
                          results_directory=tmp_path / "torch")
    ours.run()
    ours.dump_csv()

    for name in TECHNIQUES:
        assert ours.iterations[name] == ref.iterations[name], name
        assert ours.successes[name] == ref.successes[name] == [100.0] * 4
        np.testing.assert_allclose(ours.densities[name],
                                   ref.densities[name], rtol=1e-12)
        np.testing.assert_allclose(ours.kappas[name][:1],
                                   ref.kappas[name][:1], rtol=1e-6)
    assert ours.setup_calls["fsai"] > 0 and ours.setup_calls["learned"] > 0
    # the public per-case setup builds the preconditioner run() solved with
    for name in TECHNIQUES:
        for index in range(len(ds)):
            _, ell, b = ours._system(index)
            res = ours._solve(ell, b, *ours.setup(name, index))
            assert int(res.iterations) == ours.iterations[name][index], name
    for table in ("table.csv", "totals.csv"):
        header = (tmp_path / "torch" / table).read_text().splitlines()[0]
        want = (tmp_path / "jax" / table).read_text().splitlines()[0]
        assert header == want
    assert ((tmp_path / "torch" / "eigenvalues.csv").read_text()
            .splitlines()[0]
            == (tmp_path / "jax" / "eigenvalues.csv").read_text()
            .splitlines()[0])
