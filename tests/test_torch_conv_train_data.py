"""The port's conv training data against the JAX package's: the batches
and padded, stacked plans of ``PlannedDataSet(specs=...)`` for the
``ConvSpec`` chain of ``PreconditionerNet`` and for ``UNetPlanBuilder``
(level buckets over the whole split, shared by both split views and by
the serving ``SludgePatternDataSet``), ``RandomSPDDataSet`` and
``StAnDataSet`` samples, ``get_dataset_class`` by name, the StAn download
refusing, and ``init_params``'s bounds and determinism.  Integer plans
and float32 batches are held equal exactly."""

from pathlib import Path

import numpy as np
import pytest
import torch

from deeppreconditioning_tpu.data import datasets as jax_datasets
from deeppreconditioning_tpu.models import plan_builder_for as jax_builder
from deeppreconditioning_tpu_torch import config
from deeppreconditioning_tpu_torch.data import datasets
from deeppreconditioning_tpu_torch.data.fvm import (
    generate_sludge_case,
    save_case,
)
from deeppreconditioning_tpu_torch.models import (
    PreconditionerNet,
    PreconditionerSparseUNet,
    init_params,
    plan_builder_for,
)
from deeppreconditioning_tpu_torch.models.sparse_unet import UNET_TOPOLOGY
from deeppreconditioning_tpu_torch.train.__main__ import SubsetView
from deeppreconditioning_tpu_torch.data.fvm import numpy_assembly


@pytest.fixture(autouse=True, scope="module")
def _numpy_fvm_assembly():
    """The port's numpy FVM assembly: the route the reference's counts
    and arrays held here were made on."""
    with numpy_assembly():
        yield


REPO = Path(__file__).resolve().parents[1]
CASES, BATCH, SEED = 12, 2, 69
CHANNELS = (1, 8, 16, 8, 1)
UNET_CHANNELS = (1, 8, 8, 8, 8, 8, 1)
MODELS = {"PreconditionerNet": CHANNELS,
          "PreconditionerSparseUNet": UNET_CHANNELS}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small CPU tensors."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("conv_train_cases")
    rng = np.random.default_rng(13)
    for i in range(CASES):
        save_case(generate_sludge_case(rng, mesh_cells=1),
                  root / "sludge_patterns" / f"case_{i:04d}")
    return root


def assert_batches_equal(got, want):
    """A port ``DeviceBatch`` against the reference's, exactly: features,
    every layer's gather / rows / cols / valid, the sites (the
    reference's level-0 plan), the systems' entries, solutions,
    right-hand sides, scales and sizes."""
    np.testing.assert_array_equal(got.features.numpy(),
                                  np.asarray(want.features))
    assert len(got.plans) == len(want.plans)
    for li, (g, w) in enumerate(zip(got.plans, want.plans)):
        for name in ("gather", "rows", "cols", "valid"):
            a = getattr(g, name)
            assert a.dtype == (torch.bool if name == "valid"
                               else torch.int64), name
            np.testing.assert_array_equal(
                a.numpy(), np.asarray(getattr(w, name)), f"{li} {name}")
    for name in ("rows", "cols", "valid"):
        np.testing.assert_array_equal(
            getattr(got.sites, name).numpy(),
            np.asarray(getattr(want.plans[0], name)), name)
    assert got.systems.nnz_pad == want.systems.nnz_pad
    np.testing.assert_array_equal(got.systems.indices.numpy(),
                                  np.asarray(want.systems.indices))
    np.testing.assert_array_equal(got.systems.masked_values().numpy(),
                                  np.asarray(want.systems.values))
    for name in ("solutions", "right_hand_sides", "scales"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    assert got.original_sizes == want.original_sizes


@pytest.mark.parametrize("model", sorted(MODELS))
def test_sludge_batches_and_plans_match_jax(data_root, model):
    """Every batch and its padded plans equal the reference's; the buckets
    are the whole split's (the validation view's batch has them too) and
    the serving view of the same split computes the same ones."""
    channels = MODELS[model]
    ref = jax_datasets.SludgePatternDataSet(
        stage="train", batch_size=BATCH, specs=jax_builder(model, channels),
        root=data_root, seed=SEED)
    ours = datasets.PlannedDataSet(
        stage="train", batch_size=BATCH, root=data_root, seed=SEED,
        specs=plan_builder_for(model, channels))
    assert [p.name for p in ours.items] == [p.name for p in ref.folders]
    assert [int(p.name[5:]) for p in ours.items] == ours.order
    assert ours.level_buckets == ref._level_buckets
    assert (len(ours), ours.dof_pad, ours.nnz0_pad) == (
        len(ref), ref.dof_pad, ref.nnz0_pad)
    for i in range(len(ours)):
        assert ours[i] is ours[i]  # built once, kept
        assert_batches_equal(ours[i], ref[i])
    out_levels = (range(1, len(CHANNELS)) if model == "PreconditionerNet"
                  else [t[3] for t in UNET_TOPOLOGY])
    val = SubsetView(ours, [len(ours) - 1])
    assert [p.gather.shape[-1] for p in val[0].plans] == [
        ours.level_buckets[lv] for lv in out_levels]
    serving = datasets.SludgePatternDataSet(
        stage="train", root=data_root,
        specs=plan_builder_for(model, channels))
    assert serving.level_buckets == ours.level_buckets
    assert serving.nnz0_pad == ours.nnz0_pad


def test_random_spd_matches_jax():
    """RandomSPD: A = B B^T + 1e-3 I, x = 1, the 80/20 split and the
    shuffle, drawn in the reference's order; batches equal (both splits,
    with and without shuffling)."""
    specs = plan_builder_for("PreconditionerNet", CHANNELS)
    jspecs = jax_builder("PreconditionerNet", CHANNELS)
    for stage, shuffle in (("train", True), ("test", False)):
        kw = dict(dof=24, batch_size=BATCH, sparsity=0.9, length=10,
                  seed=5, shuffle=shuffle)
        ref = jax_datasets.RandomSPDDataSet(stage, specs=jspecs, **kw)
        ours = datasets.RandomSPDDataSet(stage, specs=specs, **kw)
        assert len(ours) == len(ref) == (4 if stage == "train" else 1)
        assert ours.level_buckets == ref._level_buckets
        for i in range(len(ours)):
            assert_batches_equal(ours[i], ref[i])
        h = ours.host_sample(0)
        assert h.original_size == 24 and ours.dof_pad == 128
    with pytest.raises(ValueError, match="sparsity"):
        datasets.RandomSPDDataSet("train", dof=8, batch_size=1,
                                  sparsity=0.0)


def test_stan_matches_jax():
    """StAn from the committed npz samples (one per split): padded to
    DOF_MAX 5166 (n_pad 5248), batches equal the reference's."""
    specs = plan_builder_for("PreconditionerNet", CHANNELS)
    root = REPO / "tests" / "fixtures"
    for stage in ("train", "test"):
        ref = jax_datasets.StAnDataSet(
            stage, batch_size=1, root=root,
            specs=jax_builder("PreconditionerNet", CHANNELS))
        ours = datasets.StAnDataSet(stage, batch_size=1, root=root,
                                    specs=specs)
        assert (ours.dof_max, ours.dof_pad) == (5166, 5248)
        assert [f.name for f in ours.files] == ["0000.npz"]
        assert ours.level_buckets == ref._level_buckets
        assert_batches_equal(ours[0], ref[0])
    with pytest.raises(FileNotFoundError):
        datasets.StAnDataSet("train", batch_size=1, root=root / "none")
    with pytest.raises(RuntimeError, match="network"):
        datasets.download_from_kaggle()


def test_dataset_classes_by_name():
    for name in ("SludgePatternDataSet", "RandomSPDDataSet", "StAnDataSet"):
        cls = config.get_dataset_class(name)
        assert cls is getattr(datasets, name)
        assert cls.__name__ == getattr(jax_datasets, name).__name__
    assert issubclass(datasets.RandomSPDDataSet, datasets.PlannedDataSet)
    assert issubclass(datasets.StAnDataSet, datasets.PlannedDataSet)


def test_in_memory_cases_give_the_same_plans(data_root):
    rng = np.random.default_rng(13)
    cases = [generate_sludge_case(rng, mesh_cells=1) for _ in range(CASES)]
    specs = plan_builder_for("PreconditionerSparseUNet", UNET_CHANNELS)
    mem = datasets.PlannedDataSet(stage="train", batch_size=BATCH,
                                  cases=cases, seed=SEED, specs=specs)
    disk = datasets.PlannedDataSet(stage="train", batch_size=BATCH,
                                   root=data_root, seed=SEED, specs=specs)
    assert mem.order == disk.order
    for a, b in zip(mem[1].plans, disk[1].plans):
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_init_params_bounds_and_determinism(model):
    """Weights and biases uniform within +-1/sqrt(Cin K) and spread over
    it, PReLU slopes 0.25; one generator seed gives one draw, another
    seed another; the parameter shapes are the reference's."""
    cls = PreconditionerNet if model == "PreconditionerNet" else (
        PreconditionerSparseUNet)
    a, b, c = (cls(channels=MODELS[model]) for _ in range(3))
    init_params(a, torch.Generator().manual_seed(7))
    init_params(b, torch.Generator().manual_seed(7))
    init_params(c, torch.Generator().manual_seed(8))
    params_b, params_c = dict(b.named_parameters()), dict(c.named_parameters())
    for name, p in a.named_parameters():
        p = p.detach()
        torch.testing.assert_close(p, params_b[name], rtol=0, atol=0)
        if name.startswith("prelu"):
            assert bool((p == 0.25).all())
            continue
        assert not torch.equal(p, params_c[name])
        w = getattr(a, "w" + name[1:])
        bound = 1.0 / np.sqrt(w.shape[0] * w.shape[1])
        assert float(p.abs().max()) <= bound
        if p.numel() >= 16:
            assert float(p.abs().max()) > 0.5 * bound
    first = a.w1 if model == "PreconditionerNet" else a.w_down1
    assert first.shape == ((4, 8, 16) if model == "PreconditionerNet"
                           else (9, 8, 8))
