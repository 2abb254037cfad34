"""The technique incomplete_lu (ICT(1, 0.1) and two level-scheduled
triangular solves): the port's per-case suite against the JAX package's on
the same two saved cases, float64, on each ICT route (the host runtime
against the reference's native library, the dense numpy version against
the reference's numpy version).  Per-case iterations equal, density and
kappa to 1e-10."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppreconditioning_tpu import native as jax_native
from deeppreconditioning_tpu.bench.suite import BenchmarkSuite as JaxSuite
from deeppreconditioning_tpu.data.datasets import (
    SludgePatternDataSet as JaxDataSet,
)
from deeppreconditioning_tpu.models import plan_builder_for
from deeppreconditioning_tpu_torch import _backend, native
from deeppreconditioning_tpu_torch.bench.suite import (
    ALL_TECHNIQUES,
    HOST_BOUND_TECHNIQUES,
    TECHNIQUES,
    BenchmarkSuite,
)
from deeppreconditioning_tpu_torch.data.datasets import SludgePatternDataSet
from deeppreconditioning_tpu_torch.data.fvm import (
    generate_sludge_case,
    save_case,
)
from deeppreconditioning_tpu_torch.data.fvm import numpy_assembly


@pytest.fixture(autouse=True, scope="module")
def _numpy_fvm_assembly():
    """The port's numpy FVM assembly: the route the reference's counts
    and arrays held here were made on."""
    with numpy_assembly():
        yield


ILU = ("incomplete_lu",)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    rng = np.random.default_rng(23)
    root = tmp_path_factory.mktemp("raw")
    for i in range(10):  # the 80/20 split leaves 2 test cases
        case = generate_sludge_case(rng, mesh_cells=1)
        save_case(case, root / "sludge_patterns" / f"case_{i:04d}")
    return root


def test_all_techniques_are_the_references_eight():
    assert ALL_TECHNIQUES == ("vanilla", "jacobi", "incomplete_cholesky",
                              "incomplete_cholesky_neumann", "incomplete_lu",
                              "algebraic_multigrid", "fsai", "learned")
    assert set(ALL_TECHNIQUES) - set(TECHNIQUES) == {"incomplete_lu"}
    assert "incomplete_lu" in HOST_BOUND_TECHNIQUES


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_incomplete_lu_matches_jax(split, tmp_path, monkeypatch, route):
    if route == "native" and not jax_native.available():
        pytest.skip("the reference's native/libdptpu.so does not load")
    if route == "numpy":
        monkeypatch.setattr(jax_native, "available", lambda: False)
        monkeypatch.setattr(native, "available", lambda: False)
    jax_ds = JaxDataSet(stage="test", batch_size=1,
                        specs=plan_builder_for("NeuralFSAI", None),
                        shuffle=False, root=split)
    ref = JaxSuite(jax_ds, None, None, techniques=ILU, dtype=jnp.float64,
                   timing_reps=1, kappa_cases=2,
                   results_directory=tmp_path / "jax")
    ref.run()
    ds = SludgePatternDataSet(stage="test", root=split)
    assert len(ds) == len(jax_ds) == 2
    ours = BenchmarkSuite(ds, None, techniques=ILU, device="cpu",
                          dtype=torch.float64, timing_reps=1, kappa_cases=2,
                          results_directory=tmp_path / "torch")
    _backend.reset_launch_counts()
    ours.run()
    name = ILU[0]
    assert ours.iterations[name] == ref.iterations[name]
    assert ours.successes[name] == ref.successes[name] == [100.0] * 2
    np.testing.assert_allclose(ours.densities[name], ref.densities[name],
                               rtol=1e-10)
    np.testing.assert_allclose(ours.kappas[name], ref.kappas[name],
                               rtol=1e-10)
    counts = (_backend.host_call_counts() if route == "native"
              else _backend.host_fallback_counts())
    assert counts["ict"] == ours.setup_calls[name] > 0
    assert counts["levels"] == 2 * ours.setup_calls[name]
