"""The port's training data and plans against the JAX package: the
``PlannedDataSet`` batches against ``SludgePatternDataSet`` with the
NeuralFSAI plan builder on the same case folders (shuffle order,
features, sites, systems, solutions, right-hand sides, scales), the
``FSAIPlanProvider`` plans (range and generic), and the dense builds of
training (``range_dense_factor_slabs``, ``batched_dense_factor``,
``batched_dense_m``) in float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppreconditioning_tpu.data.datasets import (
    SludgePatternDataSet as JaxSludgePatternDataSet,
)
from deeppreconditioning_tpu.models import plan_builder_for
from deeppreconditioning_tpu.models import neural_fsai as jax_nf
from deeppreconditioning_tpu.ops import fsai as jax_fsai
from deeppreconditioning_tpu_torch.data.datasets import PlannedDataSet
from deeppreconditioning_tpu_torch.data.fvm import (
    generate_sludge_case,
    save_case,
)
from deeppreconditioning_tpu_torch.models import neural_fsai as nf
from deeppreconditioning_tpu_torch.ops import fsai
from deeppreconditioning_tpu_torch.data.fvm import numpy_assembly


@pytest.fixture(autouse=True, scope="module")
def _numpy_fvm_assembly():
    """The port's numpy FVM assembly: the route the reference's counts
    and arrays held here were made on."""
    with numpy_assembly():
        yield


CASES, BATCH, SEED = 12, 2, 69
POWER, WIDTH = 3, 16  # tril(|A|^3) of the one-cell cases is 13 wide
RANGE_H, GENERIC_H = 64, 32  # 32 is below their block row spread


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cases")
    rng = np.random.default_rng(11)
    for i in range(CASES):
        save_case(generate_sludge_case(rng, mesh_cells=1),
                  root / "sludge_patterns" / f"case_{i:04d}")
    return root


@pytest.fixture(scope="module")
def both_sets(data_root):
    ref = JaxSludgePatternDataSet(
        stage="train", batch_size=BATCH,
        specs=plan_builder_for("NeuralFSAI", None), root=data_root,
        seed=SEED)
    ours = PlannedDataSet(stage="train", batch_size=BATCH, root=data_root,
                          seed=SEED)
    return ref, ours


def test_batches_match_jax(both_sets):
    """Every float32 batch equals the reference's exactly, the sites
    equal its level-0 plan, and the shuffle is the same."""
    ref, ours = both_sets
    assert [p.name for p in ours.items] == [p.name for p in ref.folders]
    assert [p.name for p in ours.items] != sorted(p.name for p in ours.items)
    assert (len(ours), ours.dof_pad, ours.nnz0_pad) == (
        len(ref), ref.dof_pad, ref.nnz0_pad)
    for i in range(len(ours)):
        got, want = ours[i], ref[i]
        assert got is ours[i]  # cached: one identity per batch
        p0 = want.plans[0]
        np.testing.assert_array_equal(got.features.numpy(),
                                      np.asarray(want.features))
        for name in ("rows", "cols", "valid"):
            np.testing.assert_array_equal(
                getattr(got.sites, name).numpy(),
                np.asarray(getattr(p0, name)), name)
        assert got.systems.nnz_pad == want.systems.nnz_pad
        np.testing.assert_array_equal(got.systems.to_dense().numpy(),
                                      np.asarray(want.systems.to_dense()))
        for name in ("solutions", "right_hand_sides", "scales"):
            g = getattr(got, name)
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(),
                                          np.asarray(getattr(want, name)))
        assert got.original_sizes == want.original_sizes


def test_in_memory_cases_give_the_same_batches(data_root, both_sets):
    _, ours = both_sets
    rng = np.random.default_rng(11)
    cases = [generate_sludge_case(rng, mesh_cells=1) for _ in range(CASES)]
    mem = PlannedDataSet(stage="train", batch_size=BATCH, cases=cases,
                         seed=SEED)
    for i in range(len(ours)):
        a, b = mem[i], ours[i]
        torch.testing.assert_close(a.features, b.features, rtol=0, atol=0)
        torch.testing.assert_close(a.systems.to_dense(),
                                   b.systems.to_dense(), rtol=0, atol=0)
        torch.testing.assert_close(a.right_hand_sides, b.right_hand_sides,
                                   rtol=0, atol=0)


def _assert_plan_equal(got, want):
    assert type(got).__name__ == type(want).__name__
    names = (("lo", "local", "pos", "diag_pad", "out_rows")
             if isinstance(got, fsai.RangeFSAIPlan)
             else ("sub_idx", "pos", "out_rows", "diag_pad", "l0_rows",
                   "l0_cols"))
    if isinstance(got, fsai.RangeFSAIPlan):
        assert got.h == want.h
        assert got.lo_static is None and want.lo_static is None
    for name in names:
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            name)


@pytest.mark.parametrize("range_h,kind,expect", [
    (RANGE_H, "auto", "range"),
    (GENERIC_H, "auto", "generic"),
    (RANGE_H, "generic", "generic"),
])
def test_plan_provider_matches_jax(both_sets, range_h, kind, expect):
    """The group plan of every batch equals the reference's stacked plan,
    and ``auto`` settles on the same kind."""
    ref, ours = both_sets
    p_ref = jax_nf.FSAIPlanProvider(ref, power=POWER, width=WIDTH,
                                    range_h=range_h, kind=kind)
    p_ours = nf.FSAIPlanProvider(ours, power=POWER, width=WIDTH,
                                 range_h=range_h, kind=kind)
    for i in range(len(ours)):
        got = p_ours(i, ours[i])
        assert p_ours(i, ours[i]) is got  # built once per batch
        _assert_plan_equal(got, p_ref(i, ref[i]))
    assert p_ours.kind == p_ref.kind == expect


class _FreshCopies:
    """Batches ``indices`` of a data set, renumbered from 0, each served
    as a new object on every access and dropped after use (as a data set
    whose batch cache evicts them would serve them)."""

    def __init__(self, base, indices):
        self.base, self.indices = base, list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        b = self.base[self.indices[i]]
        return b._replace(features=b.features.clone())


def test_plan_provider_keys_on_the_batch_index(both_sets):
    """Split views renumber batches from 0, and a batch freed after use
    can leave its address to the next one: every batch still gets its own
    plans (keyed on ``batch.index``), on both views and on a second pass,
    equal to plans built for it alone."""
    from deeppreconditioning_tpu_torch.train.__main__ import SubsetView

    _, ours = both_sets
    n = len(ours)
    provider = nf.FSAIPlanProvider(ours, power=POWER, width=WIDTH,
                                   range_h=RANGE_H)
    alone = [nf.FSAIPlanProvider(ours, power=POWER, width=WIDTH,
                                 range_h=RANGE_H)(0, ours[j])
             for j in range(n)]
    assert all((alone[0].out_rows != p.out_rows).any() for p in alone[1:])
    for view in (SubsetView(ours, range(n - 2)),
                 SubsetView(ours, range(n - 2, n))):
        assert all(view[i] is ours[view.indices[i]]
                   for i in range(len(view)))  # kept, not rebuilt
    for _ in range(2):
        for view in (_FreshCopies(ours, range(n - 2)),
                     _FreshCopies(ours, range(n - 2, n))):
            for i in range(len(view)):
                _assert_plan_equal(provider(i, view[i]),
                                   alone[view.indices[i]])
    assert sorted(provider._cache) == list(range(n))


def _c_vals(plan_np, seed):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal(plan_np.out_rows.shape)
    return np.where(plan_np.out_rows < plan_np.out_rows.shape[-2], c, 0.0)


@pytest.mark.parametrize("static_lo", [False, True])
def test_range_dense_factor_slabs_matches_jax(both_sets, static_lo):
    """One case, with per-case and with static window starts: exact."""
    _, ours = both_sets
    h = ours.host_sample(0)
    pr, pc = fsai.tril_power_pattern(h.rows, h.cols, ours.dof_pad, POWER)
    plan = fsai.build_range_fsai_plan(pr, pc, ours.dof_pad, WIDTH, RANGE_H,
                                      static_lo=static_lo)
    ref_plan = jax_fsai.build_range_fsai_plan(pr, pc, ours.dof_pad, WIDTH,
                                              RANGE_H, static_lo=static_lo)
    c = _c_vals(plan, 1)
    want = jax_fsai.range_dense_factor_slabs(ref_plan, jnp.asarray(c))
    got = fsai.range_dense_factor_slabs(plan.to("cpu"), torch.tensor(c))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("range_h", [RANGE_H, GENERIC_H])
def test_batched_dense_factor_and_m_match_jax(both_sets, range_h):
    """A batch's group plan (range without static starts, or generic):
    the dense C of every case exactly, and M~ = C q(B) q(B)^T C^T with
    per-case q to 1e-12 relative (float64)."""
    ref, ours = both_sets
    p_ref = jax_nf.FSAIPlanProvider(ref, power=POWER, width=WIDTH,
                                    range_h=range_h)
    p_ours = nf.FSAIPlanProvider(ours, power=POWER, width=WIDTH,
                                 range_h=range_h)
    plans, ref_plans = p_ours(0, ours[0]), p_ref(0, ref[0])
    c = _c_vals(plans, 2)
    q = np.array([[1.1, -0.3, 0.02], [0.9, 0.1, -0.05]])
    a_full = ours[0].systems.to_dense().double()
    a_full = a_full + torch.tril(a_full, -1).mT
    want_c = jax_nf.batched_dense_factor(ref_plans, jnp.asarray(c))
    got_c = nf.batched_dense_factor(plans, torch.tensor(c))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    out = jax_nf.NeuralFSAIOut(jnp.asarray(c), jnp.asarray(q))
    want_m = np.asarray(jax_nf.batched_dense_m(ref_plans, out,
                                               jnp.asarray(a_full.numpy())))
    got_m = nf.batched_dense_m(plans, nf.NeuralFSAIOut(torch.tensor(c),
                                                       torch.tensor(q)),
                               a_full)
    np.testing.assert_allclose(got_m.numpy(), want_m, rtol=1e-12,
                               atol=1e-12 * np.abs(want_m).max())
    # per case, the batched form is the 2-D one
    one = fsai.poly_preconditioner_dense(got_c[1], a_full[1],
                                         torch.tensor(q[1]))
    torch.testing.assert_close(one, got_m[1], rtol=1e-13, atol=1e-13)


def test_range_group_without_static_starts_has_no_gram_assembly(both_sets):
    _, ours = both_sets
    plans = nf.FSAIPlanProvider(ours, power=POWER, width=WIDTH,
                                range_h=RANGE_H)(0, ours[0])
    strips = fsai.range_strips(plans, torch.zeros(plans.out_rows.shape,
                                                  dtype=torch.float64))
    with pytest.raises(ValueError, match="no Gram assembly"):
        fsai.range_m_from_strips(plans, strips,
                                 torch.ones(2, plans.n_pad,
                                            dtype=torch.float64), 100)
