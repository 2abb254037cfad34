"""PreconditionerSparseUNet of the port against the JAX package's: the
host plans (the reference's native plan builder on and off) and the
forward in float64 with the committed checkpoint's weights, on generated
sludge cases."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppreconditioning_tpu import native
from deeppreconditioning_tpu.models import (
    PreconditionerSparseUNet as JaxUNet,
)
from deeppreconditioning_tpu.models import sparse_unet as jax_unet
from deeppreconditioning_tpu.models.precond_net import batched_apply
from deeppreconditioning_tpu.ops.sparse_conv import (
    pad_sample_plans as jax_pad,
    stack_plans as jax_stack,
)
from deeppreconditioning_tpu.train.trainer import (
    load_checkpoint as jax_load_checkpoint,
)
from deeppreconditioning_tpu_torch.data.datasets import (
    SludgePatternDataSet,
    _prepare_sample,
)
from deeppreconditioning_tpu_torch.data.fvm import generate_sludge_case
from deeppreconditioning_tpu_torch.models import (
    PreconditionerSparseUNet,
    conv_model_from_checkpoint,
)
from deeppreconditioning_tpu_torch.models import sparse_unet
from deeppreconditioning_tpu_torch.ops.sparse_conv import (
    pad_sample_plans,
    stack_plans,
)
from deeppreconditioning_tpu_torch.train.checkpoint import load_checkpoint
from deeppreconditioning_tpu_torch.data.fvm import numpy_assembly


@pytest.fixture(autouse=True, scope="module")
def _numpy_fvm_assembly():
    """The port's numpy FVM assembly: the route the reference's counts
    and arrays held here were made on."""
    with numpy_assembly():
        yield


CKPT = (Path(__file__).resolve().parents[1] / "assets" / "checkpoints_unet"
        / "best.msgpack")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small CPU tensors: a pool of eight
    costs more than the work, most of all in a loaded test run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tril_sites(seed):
    case = generate_sludge_case(np.random.default_rng(seed), mesh_cells=1)
    m = case.matrix
    h = _prepare_sample(m.row, m.col, m.data, case.solution, case.rhs, 256)
    return h, 256


def test_topology_matches_jax():
    assert sparse_unet.UNET_TOPOLOGY == jax_unet.UNET_TOPOLOGY
    assert sparse_unet.UNET_SKIPS == jax_unet.UNET_SKIPS


@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native", "numpy"])
def test_plans_match_jax(monkeypatch, use_native):
    monkeypatch.setattr(native, "available", lambda: use_native)
    hosts = [_tril_sites(seed) for seed in (5, 6)]
    ours = [sparse_unet.UNetPlanBuilder().build(h.rows, h.cols, (n, n))
            for h, n in hosts]
    ref = [jax_unet.UNetPlanBuilder().build(h.rows, h.cols, (n, n))
           for h, n in hosts]
    for a, b in zip(ours, ref):
        assert a.level_nnz == b.level_nnz and a.shapes == b.shapes
        assert (a.in_level, a.out_level) == (b.in_level, b.out_level)
        for la, lb in zip(a.layer_gather, b.layer_gather):
            np.testing.assert_array_equal(la, lb)
    nnz0 = [h.rows.shape[0] for h, _ in hosts]
    for a, b in zip(stack_plans(pad_sample_plans(ours, nnz0)),
                    jax_stack(jax_pad(ref, nnz0))):
        for field in ("gather", "rows", "cols", "valid"):
            np.testing.assert_array_equal(getattr(a, field).numpy(),
                                          np.asarray(getattr(b, field)))


def test_forward_matches_jax(tmp_path):
    from deeppreconditioning_tpu_torch.data.fvm import save_case

    rng = np.random.default_rng(8)
    for i in range(10):  # 2 test cases
        save_case(generate_sludge_case(rng, mesh_cells=1),
                  tmp_path / "sludge_patterns" / f"case_{i:04d}")
    ds = SludgePatternDataSet(stage="test", root=tmp_path,
                              specs=sparse_unet.UNetPlanBuilder())
    model = conv_model_from_checkpoint("PreconditionerSparseUNet",
                                       load_checkpoint(CKPT)).double()
    assert isinstance(model, PreconditionerSparseUNet)
    params = jax.tree.map(lambda x: np.asarray(x, np.float64),
                          jax_load_checkpoint(CKPT)["params"])
    jax_model = JaxUNet(channels=model.channels)
    forward = jax.jit(lambda p, f, pl: batched_apply(jax_model, p, f, pl))
    for index in range(len(ds)):
        batch = ds[index]
        with torch.no_grad():
            vals = model(batch.features.double(), batch.plans)
        jax_plans = tuple(jax_unet.LayerPlan(*(jnp.asarray(t.numpy())
                                               for t in p))
                          for p in batch.plans)
        want = forward(params, jnp.asarray(batch.features.double().numpy()),
                       jax_plans)
        np.testing.assert_allclose(vals.numpy(), np.asarray(want),
                                   rtol=1e-10, atol=1e-13)
        final = batch.plans[-1]
        assert not vals[final.rows < final.cols].any()
        assert (vals[(final.rows == final.cols) & final.valid] > 0).all()
        assert not vals[~final.valid].any()
