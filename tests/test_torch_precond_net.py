"""PreconditionerNet of the port against the JAX package's, float64, with
the committed checkpoints' weights carried across, on generated sludge
cases through both packages' data sets (plans included); and the port's
``params.yaml`` reading of the conv settings."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppreconditioning_tpu import config as jax_config
from deeppreconditioning_tpu.data.datasets import (
    SludgePatternDataSet as JaxDataSet,
)
from deeppreconditioning_tpu.models import PreconditionerNet as JaxNet
from deeppreconditioning_tpu.models import plan_builder_for as jax_builder
from deeppreconditioning_tpu.models.precond_net import (
    batched_apply,
    output_to_dense as jax_output_to_dense,
    precond_net_specs as jax_specs,
)
from deeppreconditioning_tpu.train.trainer import (
    load_checkpoint as jax_load_checkpoint,
)
from deeppreconditioning_tpu_torch import config
from deeppreconditioning_tpu_torch.data.datasets import SludgePatternDataSet
from deeppreconditioning_tpu_torch.data.fvm import (
    generate_sludge_case,
    save_case,
)
from deeppreconditioning_tpu_torch.models import (
    PreconditionerNet,
    conv_model_from_checkpoint,
    plan_builder_for,
)
from deeppreconditioning_tpu_torch.models.precond_net import (
    output_to_dense,
    precond_net_specs,
)
from deeppreconditioning_tpu_torch.train.checkpoint import load_checkpoint
from deeppreconditioning_tpu_torch.data.fvm import numpy_assembly


@pytest.fixture(autouse=True, scope="module")
def _numpy_fvm_assembly():
    """The port's numpy FVM assembly: the route the reference's counts
    and arrays held here were made on."""
    with numpy_assembly():
        yield


REPO = Path(__file__).resolve().parents[1]
CHANNELS = (1, 16, 32, 64, 32, 16, 1)
CHECKPOINTS = ("checkpoints", "checkpoints_v2")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small CPU tensors: a pool of eight
    costs more than the work, most of all in a loaded test run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data_sets(tmp_path_factory):
    root = tmp_path_factory.mktemp("raw")
    rng = np.random.default_rng(21)
    for i in range(10):  # the 80/20 split leaves 2 test cases
        save_case(generate_sludge_case(rng, mesh_cells=1),
                  root / "sludge_patterns" / f"case_{i:04d}")
    ours = SludgePatternDataSet(
        stage="test", root=root,
        specs=plan_builder_for("PreconditionerNet", CHANNELS))
    ref = JaxDataSet(stage="test", batch_size=1, shuffle=False, root=root,
                     specs=jax_builder("PreconditionerNet", CHANNELS))
    return ours, ref


@pytest.fixture(scope="module")
def jax_forward():
    model = JaxNet(channels=CHANNELS)
    return jax.jit(lambda p, f, pl: batched_apply(model, p, f, pl))


@pytest.mark.parametrize("channels", [(1, 1, 1), (1, 4, 1, 1, 1),
                                      CHANNELS])
def test_specs_match_jax(channels):
    ours = precond_net_specs(channels)
    ref = jax_specs(channels)
    assert [(s.kernel, s.padding, s.stride, s.submanifold) for s in ours] \
        == [(s.kernel, s.padding, s.stride, s.submanifold) for s in ref]


def test_data_set_plans_match_jax(data_sets):
    ours, ref = data_sets
    assert ours.level_buckets == ref._level_buckets
    assert ours.nnz0_pad == ref.nnz0_pad and len(ours) == len(ref) == 2
    for index in range(len(ours)):
        a, b = ours[index], ref[index]
        np.testing.assert_array_equal(a.features.numpy(),
                                      np.asarray(b.features))
        np.testing.assert_array_equal(a.scales.numpy(), np.asarray(b.scales))
        for pa, pb in zip(a.plans, b.plans):
            for field in ("gather", "rows", "cols", "valid"):
                np.testing.assert_array_equal(
                    getattr(pa, field).numpy(),
                    np.asarray(getattr(pb, field)))


@pytest.mark.parametrize("ckpt", CHECKPOINTS)
def test_forward_matches_jax(data_sets, jax_forward, ckpt):
    ours_ds, ref_ds = data_sets
    path = REPO / "assets" / ckpt / "best.msgpack"
    model = conv_model_from_checkpoint(
        "PreconditionerNet", load_checkpoint(path)).double()
    params = jax.tree.map(lambda x: np.asarray(x, np.float64),
                          jax_load_checkpoint(path)["params"])
    n = ours_ds.dof_pad
    for index in range(len(ours_ds)):
        batch, ref_batch = ours_ds[index], ref_ds[index]
        with torch.no_grad():
            vals = model(batch.features.double(), batch.plans)
        want = jax_forward(params, ref_batch.features.astype(jnp.float64),
                           ref_batch.plans)
        np.testing.assert_allclose(vals.numpy(), np.asarray(want),
                                   rtol=1e-10, atol=1e-13)
        final = batch.plans[-1]
        assert not vals[final.rows < final.cols].any()
        diag = (final.rows == final.cols) & final.valid
        assert (vals[diag] > 0).all()
        dense = output_to_dense(vals, final, n)
        np.testing.assert_allclose(
            dense.numpy(),
            np.asarray(jax_output_to_dense(want, ref_batch.plans[-1], n)),
            rtol=1e-10, atol=1e-13)
        assert not torch.triu(dense[0], 1).any()


def test_params_carry_names_and_layouts():
    payload = load_checkpoint(REPO / "assets" / "checkpoints" /
                              "best.msgpack")
    model = conv_model_from_checkpoint("PreconditionerNet", payload)
    tree = payload["params"]["params"]
    assert set(model.state_dict()) == set(tree)
    for name, value in model.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), tree[name])
    assert model.channels == CHANNELS
    with pytest.raises(ValueError, match="odd"):
        PreconditionerNet(channels=(1, 2))


@pytest.mark.parametrize("text", [
    "model: PreconditionerNet\nchannels:  # odd\n- 1\n- 8\n- 1\n"
    "data: SludgePatternDataSet\nresults_dir: out\n",
    "",
])
def test_conv_settings_match_jax(tmp_path, text):
    path = tmp_path / "params.yaml"
    path.write_text(text)
    ours = config.params_show(path)
    ref = jax_config.params_show(path)
    for name in ("model", "data", "channels"):
        assert getattr(ours, name) == getattr(ref, name), name
    assert config.get_model_class(ours.model) is PreconditionerNet
    assert config.get_dataset_class(ours.data) is SludgePatternDataSet
    assert ours.channels is not config.DEFAULT_PARAMS["channels"]
