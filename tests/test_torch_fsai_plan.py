"""The port's host FSAI plan builders (numpy copies) against the JAX
package's: identical arrays on sludge-pattern cases."""

import numpy as np
import pytest
import torch  # noqa: F401  (the port's modules sit beside torch)

from deeppreconditioning_tpu.ops import fsai as jax_fsai
from deeppreconditioning_tpu_torch.data.datasets import _prepare_sample
from deeppreconditioning_tpu_torch.data.fvm import generate_sludge_case
from deeppreconditioning_tpu_torch.ops import fsai
from deeppreconditioning_tpu_torch.data.fvm import numpy_assembly


@pytest.fixture(autouse=True, scope="module")
def _numpy_fvm_assembly():
    """The port's numpy FVM assembly: the route the reference's counts
    and arrays held here were made on."""
    with numpy_assembly():
        yield


N_PAD = 256


def _sample(seed):
    case = generate_sludge_case(np.random.default_rng(seed), mesh_cells=1)
    m = case.matrix
    return _prepare_sample(m.row, m.col, m.data, case.solution, case.rhs,
                           N_PAD)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("power", [2, 4])
def test_patterns_match_jax(seed, power):
    h = _sample(seed)
    ours = fsai.tril_power_pattern(h.rows, h.cols, N_PAD, power=power)
    ref = jax_fsai.tril_power_pattern(h.rows, h.cols, N_PAD, power=power)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    assert fsai.pattern_col_width(*ours) == jax_fsai.pattern_col_width(*ref)

    capped = fsai.cap_pattern_spread(*ours, 20)
    capped_ref = jax_fsai.cap_pattern_spread(*ref, 20)
    for a, b in zip(capped, capped_ref):
        np.testing.assert_array_equal(a, b)

    top = fsai.tril_power_pattern_capped(h.rows, h.cols, h.vals, N_PAD,
                                         power=power, width=8)
    top_ref = jax_fsai.tril_power_pattern_capped(h.rows, h.cols, h.vals,
                                                 N_PAD, power=power, width=8)
    for a, b in zip(top, top_ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("width,range_h,cap", [
    (None, 128, None), (24, 128, None), (24, 128, 60), (32, 256, None),
])
def test_range_plan_matches_jax(seed, width, range_h, cap):
    h = _sample(seed)
    pr, pc = fsai.tril_power_pattern(h.rows, h.cols, N_PAD, power=4)
    if cap is not None:
        pr, pc = fsai.cap_pattern_spread(pr, pc, cap)
    if width is None:  # the pattern's own width
        width = fsai.pattern_col_width(pr, pc)
    plan = fsai.build_range_fsai_plan(pr, pc, N_PAD, width=width,
                                      range_h=range_h)
    ref = jax_fsai.build_range_fsai_plan(pr, pc, N_PAD, width=width,
                                         range_h=range_h)
    assert plan.h == ref.h
    assert plan.n_pad == ref.n_pad and plan.width == ref.width
    assert plan.block_cols == ref.block_cols
    for name in ("lo", "local", "pos", "diag_pad", "out_rows"):
        got, want = getattr(plan, name), np.asarray(getattr(ref, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_range_plan_refusals_match_jax():
    h = _sample(0)
    pr, pc = fsai.tril_power_pattern(h.rows, h.cols, N_PAD, power=4)
    for width, range_h in ((8, 128), (24, 16)):
        with pytest.raises(ValueError):
            fsai.build_range_fsai_plan(pr, pc, N_PAD, width, range_h)
        with pytest.raises(ValueError):
            jax_fsai.build_range_fsai_plan(pr, pc, N_PAD, width, range_h)
