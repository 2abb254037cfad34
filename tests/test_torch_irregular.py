"""bench.py's irregular split at a small size: the port's irregular suite
against the JAX package's on the same saved 3-D castellated cases (odd
cases permuted, pattern power 2, the flagship checkpoint), f64: per-case
counts equal, and the permuted cases on the generic plan in both."""

import jax.numpy as jnp
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
from deeppreconditioning_tpu_torch.bench import irregular
from deeppreconditioning_tpu_torch.data.fvm import save_case


def test_irregular_split_matches_jax(tmp_path):
    # meshes of ~500 cells (n_pad 512 > the range height 128), so the
    # permuted case's pattern does not fit the range plan
    cases = irregular.generate_irregular_cases(samples=10, mesh_cells=1.6)
    root = tmp_path / "raw"
    for i, case in enumerate(cases):
        save_case(case, root / "sludge_patterns_3d" / f"case_{i:04d}")
    jax_ds = JaxDataSet(stage="test", batch_size=1,
                        specs=plan_builder_for("NeuralFSAI", None),
                        shuffle=False, root=root,
                        family="sludge_patterns_3d")
    payload = jax_load_checkpoint(irregular.CHECKPOINT)
    ref = JaxSuite(
        jax_ds,
        JaxNeuralFSAI(width=int(payload["width"]),
                      hidden=int(payload["hidden"]),
                      poly_degree=int(payload["poly_degree"])),
        payload["params"], techniques=irregular.TECHNIQUES,
        dtype=jnp.float64, timing_reps=1, kappa_cases=0,
        fsai_power=irregular.POWER, learned_power=irregular.POWER,
        results_directory=tmp_path / "jax")
    ref.run()

    ours = irregular.irregular_suite("cpu", tmp_path / "torch",
                                     dtype=torch.float64, cases=cases)
    ours.timing_reps = 1
    assert len(ours.data_set) == len(jax_ds) == 2
    assert (ours.fsai_power, ours.learned_power) == (2, 2)
    ours.run()
    for name in irregular.TECHNIQUES:
        assert ours.iterations[name] == ref.iterations[name], name
        assert ours.successes[name] == ref.successes[name] == [100.0] * 2
    # the test split is cases 8 and 9: 9 is permuted, so its pattern
    # leaves the range plan's window; both sides put the same cases on the
    # generic plan
    assert ours.data_set.dof_pad == jax_ds.dof_pad == 512
    ref_generic = [i for i in range(2)
                   if ref._fsai_plan(i, jax_ds[i], _ell(ref, i))[0]
                   == "generic"]
    assert 1 in ref_generic
    for name in ("fsai", "learned"):
        assert sorted(ours.generic_cases[name]) == ref_generic


def _ell(suite, index):
    from deeppreconditioning_tpu.sparse import ELLMatrix

    a_sp, _, _ = suite._reconstruct(index)
    return ELLMatrix.from_scipy(a_sp, n_pad=suite.data_set.dof_pad)
