"""The port's host runtime (``csrc/host_runtime.cpp`` through
``deeppreconditioning_tpu_torch.native``): it builds with g++ here, each
entry point equals the port's numpy version (ic0 to rtol 1e-12, levels and
conv_plan exactly, fvm_assemble to rtol 1e-14) and the reference's
``deeppreconditioning_tpu.native`` on the same numpy inputs (skipped only
where the reference's library does not load), the callers take the native
route and count it, and a failed build raises with the compiler's
output."""

import numpy as np
import pytest
import scipy.sparse as sp

from deeppreconditioning_tpu import native as jax_native
from deeppreconditioning_tpu_torch import _backend, native
from deeppreconditioning_tpu_torch.data.fvm import (
    DT,
    assemble_pressure_poisson,
    generate_sludge_case,
)
from deeppreconditioning_tpu_torch.ops import ic0
from deeppreconditioning_tpu_torch.ops.sparse_conv import (
    ConvSpec,
    build_conv_maps,
)
from deeppreconditioning_tpu_torch.ops.trisolve import compute_levels
from deeppreconditioning_tpu_torch.data.fvm import numpy_assembly


@pytest.fixture(autouse=True, scope="module")
def _numpy_fvm_assembly():
    """The port's numpy FVM assembly: the route the reference's counts
    and arrays held here were made on."""
    with numpy_assembly():
        yield


CONV_LAYERS = [((2, 2), (1, 0)), ((2, 2), (0, 1)), ((1, 1), (0, 0)),
               ((3, 3), (1, 1)), ((5, 5), (2, 2))]


def _sludge(seed, mesh_cells=1):
    return generate_sludge_case(np.random.default_rng(seed),
                                mesh_cells=mesh_cells).matrix.tocsr()


def _sites(seed=0, h=40, w=40, nnz=200):
    rng = np.random.default_rng(seed)
    lin = np.sort(rng.choice(h * w, size=nnz, replace=False))
    return (lin // w).astype(np.int32), (lin % w).astype(np.int32), h, w


def _rho(seed=0, ny=12, nx=9):
    return 1.0 + 999.0 * np.random.default_rng(seed).random((ny, nx))


@pytest.fixture
def numpy_route(monkeypatch):
    """The port's callers on their numpy versions."""
    monkeypatch.setattr(native, "available", lambda: False)


def test_host_library_builds_with_gxx():
    assert _backend.host_compiler() is not None
    lib = _backend.host_library()
    assert native.available() and native.require() is lib
    built = sorted(_backend.HOST_BUILD_DIR.glob("libdp_host_*.so"))
    assert any(p.name in lib._name for p in built)
    # the reference's prebuilt library is never the one loaded
    assert "native/libdptpu.so" not in lib._name


@pytest.mark.parametrize("seed,mesh_cells", [(0, 1), (5, 1), (3, 2)])
def test_ic0_equals_numpy(seed, mesh_cells):
    tril = sp.tril(_sludge(seed, mesh_cells), format="csr")
    ours = tril.data.astype(np.float64).copy()
    want = ours.copy()
    assert native.ic0(tril.indptr, tril.indices, ours) == 0
    assert ic0._ic0_inplace(tril.shape[0], tril.indptr, tril.indices, want)
    np.testing.assert_allclose(ours, want, rtol=1e-12, atol=0)


def test_ic0_reports_the_breakdown_row():
    # rows 0 and 1 factor; row 2's pivot is 1 - 0.5 - 4 / 3 < 0
    a = sp.csr_matrix(np.array([[4.0, 0.0, 2.0], [0.0, 3.0, 2.0],
                                [2.0, 2.0, 1.0]]))
    tril = sp.tril(a, format="csr")
    data = tril.data.astype(np.float64).copy()
    assert native.ic0(tril.indptr, tril.indices, data) == 3
    assert not ic0._ic0_inplace(3, tril.indptr, tril.indices,
                                tril.data.astype(np.float64).copy())


@pytest.mark.parametrize("seed,mesh_cells", [(0, 1), (3, 2)])
def test_levels_equal_numpy(seed, mesh_cells, monkeypatch):
    lf = ic0.ic0_factor(_sludge(seed, mesh_cells))
    ours = native.levels(lf.indptr, lf.indices)
    monkeypatch.setattr(native, "available", lambda: False)
    want = compute_levels(lf)
    assert ours.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(ours, want)


@pytest.mark.parametrize("kernel,padding", CONV_LAYERS)
def test_conv_plan_equals_numpy(kernel, padding, monkeypatch):
    rows, cols, h, w = _sites()
    spec = ConvSpec(kernel=kernel, padding=padding)
    ours = native.conv_plan(rows, cols, h, w, *kernel, *padding)
    monkeypatch.setattr(native, "available", lambda: False)
    want = build_conv_maps(rows, cols, (h, w), spec)
    for got, ref in zip(ours, want[:3]):
        assert got.dtype == ref.dtype == np.int32
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_fvm_assemble_equals_numpy(seed):
    rho = _rho(seed)
    ny, nx = rho.shape
    rows, cols, vals, diag_extra = native.fvm_assemble(
        ny, nx, rho, 1.0, 1.0, DT, True)
    ours = sp.coo_matrix((vals, (rows, cols)), shape=(ny * nx,) * 2).tocsr()
    want = assemble_pressure_poisson(ny, nx, rho).tocsr()
    ours.sort_indices()
    want.sort_indices()
    np.testing.assert_array_equal(ours.indptr, want.indptr)
    np.testing.assert_array_equal(ours.indices, want.indices)
    np.testing.assert_allclose(ours.data, want.data, rtol=1e-14, atol=0)
    top = np.zeros((ny, nx))
    top[-1] = DT / rho[-1] * 2.0
    np.testing.assert_allclose(diag_extra, top.ravel(), rtol=1e-14)


def _entry_calls():
    """entry point -> (args) on numpy inputs, for both libraries."""
    a = _sludge(0)
    tril = sp.tril(a, format="csr")
    full = a.tocsr()
    full.sort_indices()
    rows, cols, h, w = _sites(1)
    rho = _rho(2)
    return {
        "ic0": (tril.indptr.astype(np.int64), tril.indices,
                tril.data.astype(np.float64)),
        "ict": (full.indptr.astype(np.int64), full.indices,
                full.data.astype(np.float64), 1, 0.1),
        "levels": (tril.indptr.astype(np.int64), tril.indices),
        "conv_plan": (rows, cols, h, w, 3, 3, 1, 1),
        "fvm_assemble": (*rho.shape, rho, 1.0, 1.0, DT, True),
    }


@pytest.mark.parametrize("entry", _backend.HOST_ENTRIES)
def test_entry_equals_the_reference(entry):
    if not jax_native.available():
        pytest.skip("the reference's native/libdptpu.so does not load")
    args = _entry_calls()[entry]
    ours_args = [x.copy() if isinstance(x, np.ndarray) else x for x in args]
    ref_args = [x.copy() if isinstance(x, np.ndarray) else x for x in args]
    ours = getattr(native, entry)(*ours_args)
    ref = getattr(jax_native, entry)(*ref_args)
    if entry == "ic0":  # in place: the return code and the data
        assert ours == ref == 0
        ours, ref = ours_args[2], ref_args[2]
    ours = ours if isinstance(ours, tuple) else (ours,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(ours) == len(ref)
    for got, want in zip(ours, ref):
        assert got.dtype == want.dtype and got.shape == want.shape
        if got.dtype == np.float64:
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
        else:
            np.testing.assert_array_equal(got, want)


def test_callers_take_the_native_route_and_count_it():
    a = _sludge(5)
    rows, cols, h, w = _sites(2)
    _backend.reset_launch_counts()
    lf = ic0.ic0_factor(a)
    compute_levels(lf)
    ic0.ict_factor(a)
    build_conv_maps(rows, cols, (h, w), ConvSpec((3, 3), (1, 1)))
    # strided and submanifold layers are numpy by design, not a fallback
    build_conv_maps(rows, cols, (h, w), ConvSpec((2, 2), (0, 0), stride=2))
    build_conv_maps(rows, cols, (h, w), ConvSpec((3, 3), (1, 1),
                                                 submanifold=True))
    calls = _backend.host_call_counts()
    assert calls == {"conv_plan": 1, "ic0": 1, "ict": 1, "levels": 1,
                     "fvm_assemble": 0}
    assert not any(_backend.host_fallback_counts().values())


def test_numpy_route_is_counted_as_fallback(numpy_route):
    a = _sludge(5)
    rows, cols, h, w = _sites(2)
    _backend.reset_launch_counts()
    compute_levels(ic0.ic0_factor(a))
    build_conv_maps(rows, cols, (h, w), ConvSpec((3, 3), (1, 1)))
    assert _backend.host_fallback_counts() == {
        "conv_plan": 1, "ic0": 1, "ict": 0, "levels": 1, "fvm_assemble": 0}
    assert not any(_backend.host_call_counts().values())


@pytest.mark.parametrize("seed", [0, 5])
def test_ict_keeps_the_ic0_factor_on_sludge_cases(seed):
    """ICT(1, 0.1) of a sludge system drops every fill entry: its factor
    is IC(0)'s, pattern and values."""
    a = _sludge(seed)
    l_ict, l_ic0 = ic0.ict_factor(a), ic0.ic0_factor(a)
    np.testing.assert_array_equal(l_ict.indptr, l_ic0.indptr)
    np.testing.assert_array_equal(l_ict.indices, l_ic0.indices)
    np.testing.assert_allclose(l_ict.data, l_ic0.data, rtol=1e-12)


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    broken = tmp_path / "host_runtime.cpp"
    broken.write_text("extern \"C\" int dptpu_broken( { return 0; }\n")
    monkeypatch.setattr(_backend, "HOST_SOURCE", broken)
    monkeypatch.setattr(_backend, "HOST_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_backend, "_host", None)
    monkeypatch.setattr(native, "_configured", None)
    with pytest.raises(RuntimeError, match="dptpu_broken") as err:
        native.available()
    assert "failed to build the host runtime" in str(err.value)
    assert not list((tmp_path / "build").glob("*.so"))
    assert not list((tmp_path / "build").glob("*.tmp"))
