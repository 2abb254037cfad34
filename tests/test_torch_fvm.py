"""The port's numpy copies of the FVM generator and the host dataset
against the JAX package's originals."""

import numpy as np
import pytest
import torch  # noqa: F401  (the port's modules sit beside torch)

from deeppreconditioning_tpu import native as jax_native
from deeppreconditioning_tpu.data import fvm as jax_fvm
from deeppreconditioning_tpu.data.datasets import (
    SludgePatternDataSet as JaxDataSet,
)
from deeppreconditioning_tpu.models import plan_builder_for
from deeppreconditioning_tpu_torch.data import fvm
from deeppreconditioning_tpu_torch.data.datasets import (
    SludgePatternDataSet,
    round_up,
)


@pytest.fixture(autouse=True, scope="module")
def _numpy_fvm_assembly():
    """The port's numpy FVM assembly: the route the reference's counts
    and arrays held here were made on."""
    with fvm.numpy_assembly():
        yield


@pytest.fixture
def numpy_assembly(monkeypatch):
    """Pin the reference to its numpy assembly, the path the port copies:
    its native C++ assembler agrees to ~1e-14, which the ground-truth CG
    solve then amplifies past 1e-12."""
    monkeypatch.setattr(jax_native, "available", lambda: False)


@pytest.mark.parametrize("seed", [0, 1, 69420])
def test_generate_sludge_case_matches_jax(seed, numpy_assembly):
    ours = fvm.generate_sludge_case(np.random.default_rng(seed),
                                    mesh_cells=1)
    ref = jax_fvm.generate_sludge_case(np.random.default_rng(seed),
                                       mesh_cells=1)
    assert ours.shape_2d == ref.shape_2d
    np.testing.assert_array_equal(ours.matrix.row, ref.matrix.row)
    np.testing.assert_array_equal(ours.matrix.col, ref.matrix.col)
    np.testing.assert_allclose(ours.matrix.data, ref.matrix.data,
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(ours.rhs, ref.rhs, rtol=1e-12, atol=0)
    np.testing.assert_allclose(ours.solution, ref.solution, rtol=1e-12,
                               atol=1e-15)


def test_rng_stream_stays_in_step(numpy_assembly):
    """Consecutive cases from one generator (as the dataset is built)
    consume the same draws as the original."""
    rng_a, rng_b = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(4):
        a = fvm.generate_sludge_case(rng_a, mesh_cells=1)
        b = jax_fvm.generate_sludge_case(rng_b, mesh_cells=1)
        assert a.shape_2d == b.shape_2d
        np.testing.assert_allclose(a.rhs, b.rhs, rtol=1e-12)
    assert rng_a.random() == rng_b.random()


def _save_cases(root, n, seed=3):
    rng = np.random.default_rng(seed)
    cases = [fvm.generate_sludge_case(rng, mesh_cells=1) for _ in range(n)]
    for i, case in enumerate(cases):
        fvm.save_case(case, root / "sludge_patterns" / f"case_{i:04d}")
    return cases


@pytest.mark.parametrize("stage", ["train", "test"])
def test_dataset_host_samples_match_jax(tmp_path, stage):
    cases = _save_cases(tmp_path, 10)
    ref = JaxDataSet(stage=stage, batch_size=1,
                     specs=plan_builder_for("NeuralFSAI", None),
                     shuffle=False, root=tmp_path)
    disk = SludgePatternDataSet(stage=stage, root=tmp_path)
    memory = SludgePatternDataSet(stage=stage, cases=cases)
    assert disk.dof_max == memory.dof_max == ref.dof_max
    assert disk.dof_pad == memory.dof_pad == ref.dof_pad
    assert disk.dof_pad == round_up(max(c.matrix.shape[0] for c in cases),
                                    128)
    assert len(disk) == len(memory) == len(ref)
    for i in range(len(ref)):
        want = ref.host_sample(i)
        for got in (disk.host_sample(i), memory.host_sample(i)):
            assert got.original_size == want.original_size
            for name in ("rows", "cols"):
                np.testing.assert_array_equal(getattr(got, name),
                                              getattr(want, name))
            for name in ("vals", "solution", "rhs", "scale"):
                np.testing.assert_allclose(getattr(got, name),
                                           getattr(want, name),
                                           rtol=1e-12, atol=0)


@pytest.mark.parametrize("seed, kwargs", [
    (0, {"mesh_cells": 1}),
    (1, {"mesh_cells": 2}),
    (2, {"mesh_cells": 2, "permute": True}),
    (3, {"mesh_cells": 1, "castellated": False}),
    (7, {"dims": (12, 10, 9), "max_cells": 12 ** 3, "solve": False}),
])
def test_generate_sludge_case_3d_matches_jax(seed, kwargs):
    rng_a, rng_b = np.random.default_rng(seed), np.random.default_rng(seed)
    ours = fvm.generate_sludge_case_3d(rng_a, **kwargs)
    ref = jax_fvm.generate_sludge_case_3d(rng_b, **kwargs)
    assert ours.shape_2d == ref.shape_2d
    np.testing.assert_array_equal(ours.matrix.row, ref.matrix.row)
    np.testing.assert_array_equal(ours.matrix.col, ref.matrix.col)
    np.testing.assert_array_equal(ours.matrix.data, ref.matrix.data)
    np.testing.assert_array_equal(ours.rhs, ref.rhs)
    np.testing.assert_allclose(ours.solution, ref.solution, rtol=1e-12,
                               atol=1e-15)
    assert rng_a.random() == rng_b.random()  # the streams stay in step
