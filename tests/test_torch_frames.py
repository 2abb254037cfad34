"""The port's numpy copy of the frame-structure generator against the JAX
package's original: the same matrix (to 1e-12), right-hand side, grid and
random stream, for default-size cases and a fixed small grid, where the
reference's ``np.ix_`` grounding and the port's row-then-column grounding
both fit in memory."""

import numpy as np
import pytest
import torch  # noqa: F401  (the port's modules sit beside torch)

from deeppreconditioning_tpu.data import frames as jax_frames
from deeppreconditioning_tpu_torch.data import frames


def _csr(case):
    m = case.matrix.tocsr()
    m.sort_indices()
    return m


@pytest.mark.parametrize("seed, kwargs", [
    (69422, {}),
    (0, {}),
    (5, {"dims": (3, 3, 3)}),
    (9, {"dims": (4, 3, 5), "solve": False}),
])
def test_generate_frame_case_matches_jax(seed, kwargs):
    rng_a, rng_b = np.random.default_rng(seed), np.random.default_rng(seed)
    ours = frames.generate_frame_case(rng_a, **kwargs)
    ref = jax_frames.generate_frame_case(rng_b, **kwargs)
    assert ours.shape_2d == ref.shape_2d
    got, want = _csr(ours), _csr(ref)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.data, want.data, rtol=1e-12,
                               atol=1e-12 * np.abs(want.data).max())
    np.testing.assert_array_equal(ours.rhs, ref.rhs)
    np.testing.assert_allclose(ours.solution, ref.solution, rtol=1e-9,
                               atol=1e-9 * np.abs(ref.solution).max())
    assert rng_a.random() == rng_b.random()  # the streams stay in step


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_element_stiffness_matches_jax(axis):
    args = (1.3, 210.0, 0.7, 2.1, 3.4)
    np.testing.assert_array_equal(frames.beam_stiffness_local(*args),
                                  jax_frames.beam_stiffness_local(*args))
    np.testing.assert_array_equal(frames._rotation_for_axis(axis),
                                  jax_frames._rotation_for_axis(axis))


def test_frame_case_is_spd_with_six_dof_nodes():
    case = frames.generate_frame_case(np.random.default_rng(1),
                                      dims=(2, 2, 3), solve=False)
    k = case.matrix.toarray()
    assert k.shape == (6 * 2 * 2 * 2,) * 2  # the base layer grounded
    np.testing.assert_allclose(k, k.T, atol=1e-9 * np.abs(k).max())
    assert np.linalg.eigvalsh(k).min() > 0
    assert not case.solution.any()


def test_frames_dataset_matches_jax(tmp_path):
    """The host dataset reads the frame family from disk (``family``) or
    memory and gives the JAX package's host samples."""
    from deeppreconditioning_tpu.data.datasets import (
        SludgePatternDataSet as JaxDataSet,
    )
    from deeppreconditioning_tpu.models import plan_builder_for
    from deeppreconditioning_tpu_torch.data.datasets import (
        SludgePatternDataSet,
    )
    from deeppreconditioning_tpu_torch.data.fvm import save_case

    rng = np.random.default_rng(11)
    cases = [frames.generate_frame_case(rng) for _ in range(5)]
    for i, case in enumerate(cases):
        save_case(case, tmp_path / "frame_structures" / f"case_{i:04d}")
    ref = JaxDataSet(stage="test", batch_size=1,
                     specs=plan_builder_for("NeuralFSAI", None),
                     shuffle=False, root=tmp_path, family="frame_structures")
    disk = SludgePatternDataSet(stage="test", root=tmp_path,
                                family="frame_structures")
    memory = SludgePatternDataSet(stage="test", cases=cases)
    assert disk.dof_pad == memory.dof_pad == ref.dof_pad
    assert len(disk) == len(memory) == len(ref) == 1
    want = ref.host_sample(0)
    for got in (disk.host_sample(0), memory.host_sample(0)):
        assert got.original_size == want.original_size
        np.testing.assert_array_equal(got.rows, want.rows)
        np.testing.assert_array_equal(got.cols, want.cols)
        for name in ("vals", "rhs", "scale"):
            np.testing.assert_allclose(getattr(got, name),
                                       getattr(want, name), rtol=1e-12)
    with pytest.raises(ValueError, match="family"):
        SludgePatternDataSet(stage="test", root=tmp_path, family="stan")
