"""The port's sparse-conv plans and gather-GEMM against the JAX package's.

The host plan builders must give the reference's integers with its native
plan builder on and off (the port keeps the numpy path only); the
gather-GEMM must agree in float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppreconditioning_tpu import native
from deeppreconditioning_tpu.ops import sparse_conv as jsc
from deeppreconditioning_tpu_torch.ops import sparse_conv as sc

SPECS = {
    "k2_pad_rows": ((2, 2), (1, 0), 1, False),
    "k2_pad_cols": ((2, 2), (0, 1), 1, False),
    "k2_pad_both": ((2, 2), (1, 1), 1, False),
    "k3_stride2": ((3, 3), (1, 1), 2, False),
    "k3_submanifold": ((3, 3), (1, 1), 1, True),
    "k1": ((1, 1), (0, 0), 1, False),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small CPU tensors: a pool of eight
    costs more than the work, most of all in a loaded test run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sorted_sites(rng, h, w, nnz):
    lin = np.sort(rng.choice(h * w, size=nnz, replace=False))
    return (lin // w).astype(np.int32), (lin % w).astype(np.int32)


@pytest.fixture(params=[True, False], ids=["native", "numpy"])
def reference_native(request, monkeypatch):
    if request.param and not native.available():
        pytest.fail("the reference's native runtime did not load")
    monkeypatch.setattr(native, "available", lambda: request.param)
    return request.param


@pytest.mark.parametrize("name", list(SPECS))
def test_conv_maps_match_jax(reference_native, name):
    rng = np.random.default_rng(1)
    rows, cols = _sorted_sites(rng, 23, 19, 90)
    kernel, padding, stride, subm = SPECS[name]
    ours = sc.build_conv_maps(rows, cols, (23, 19),
                              sc.ConvSpec(kernel, padding, stride, subm))
    ref = jsc.build_conv_maps(rows, cols, (23, 19),
                              jsc.ConvSpec(kernel, padding, stride, subm))
    for a, b in zip(ours[:3], ref[:3]):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype == np.int32
    assert ours[3] == ref[3]


def test_inverse_conv_maps_match_jax():
    rng = np.random.default_rng(2)
    rows, cols = _sorted_sites(rng, 30, 30, 150)
    spec, jspec = (m.ConvSpec((3, 3), (1, 1), stride=2) for m in (sc, jsc))
    d_rows, d_cols, _, hw_down = sc.build_conv_maps(rows, cols, (30, 30),
                                                    spec)
    ours = sc.build_inverse_conv_maps(d_rows, d_cols, hw_down, rows, cols,
                                      spec)
    ref = jsc.build_inverse_conv_maps(d_rows, d_cols, hw_down, rows, cols,
                                      jspec)
    np.testing.assert_array_equal(ours, ref)
    assert (ours >= 0).any(axis=0).all()  # every site hears one parent


def test_sample_plans_padded_and_stacked_match_jax(reference_native):
    rng = np.random.default_rng(3)
    names = ("k1", "k2_pad_rows", "k2_pad_cols", "k1")
    ours_p, ref_p = [], []
    for nnz in (40, 55):
        rows, cols = _sorted_sites(rng, 16, 16, nnz)
        ours_p.append(sc.build_sample_plan(
            rows, cols, (16, 16), [sc.ConvSpec(*SPECS[n]) for n in names]))
        ref_p.append(jsc.build_sample_plan(
            rows, cols, (16, 16), [jsc.ConvSpec(*SPECS[n]) for n in names]))
    assert [p.level_nnz for p in ours_p] == [p.level_nnz for p in ref_p]
    ours = sc.stack_plans(sc.pad_sample_plans(ours_p, [40, 55], bucket=32))
    ref = jsc.stack_plans(jsc.pad_sample_plans(ref_p, [40, 55], bucket=32))
    for a, b in zip(ours, ref):
        for field in ("gather", "rows", "cols", "valid"):
            np.testing.assert_array_equal(getattr(a, field).numpy(),
                                          np.asarray(getattr(b, field)))


def test_apply_sparse_conv_matches_jax():
    rng = np.random.default_rng(4)
    rows, cols = _sorted_sites(rng, 20, 20, 60)
    specs = [sc.ConvSpec((2, 2), (1, 0))]
    jspecs = [jsc.ConvSpec((2, 2), (1, 0))]
    [ours] = sc.pad_sample_plans(
        [sc.build_sample_plan(rows, cols, (20, 20), specs)], [60], bucket=64)
    [ref] = jsc.pad_sample_plans(
        [jsc.build_sample_plan(rows, cols, (20, 20), jspecs)], [60],
        bucket=64)
    feats = np.zeros((64, 3))
    feats[:60] = rng.standard_normal((60, 3))
    w = rng.standard_normal((4, 3, 5))
    b = rng.standard_normal(5)
    got = sc.apply_sparse_conv(
        torch.from_numpy(feats)[None], sc.stack_plans([ours])[0],
        torch.from_numpy(w), torch.from_numpy(b))[0].numpy()
    want = np.asarray(jsc.apply_sparse_conv(
        jnp.asarray(feats), ref[0], jnp.asarray(w), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    valid = ours[0].valid.numpy()
    assert not got[~valid].any()  # padded rows stay zero
