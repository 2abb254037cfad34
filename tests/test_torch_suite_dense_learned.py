"""The batched protocol's dense learned route against the JAX package's.

On three saved cases of a sludge split (range plans) and of a small
irregular split (one permuted case, on the generic plan), in float64: the
suite's dense build with ``batched_learned_apply="dense"`` against the JAX
``_learned_dense_setup_chunk`` on the JAX suite's own plan groups, the
bf16 attempt's on the sludge split and the float32 attempt's on the
irregular one (1e-9 of max |M|: the forwards' local solves differ in
rounding); the bf16 attempt's M the bf16 rounding of that build and its
apply the bf16 one; ``run_batched`` through the dense route with the same
per-case counts and trips as the JAX run; ``"auto"`` choosing as the
reference does (band form up to ``banded_spread_cap``); and
``__post_init__`` refusing an unknown route."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppreconditioning_tpu.bench.suite import BenchmarkSuite as JaxSuite
from deeppreconditioning_tpu.bench.suite import _learned_dense_setup_chunk
from deeppreconditioning_tpu.data.datasets import (
    SludgePatternDataSet as JaxDataSet,
)
from deeppreconditioning_tpu.models import NeuralFSAI as JaxNeuralFSAI
from deeppreconditioning_tpu.models import plan_builder_for
from deeppreconditioning_tpu.train.trainer import (
    load_checkpoint as jax_load_checkpoint,
)
from deeppreconditioning_tpu.utils import profiling as jax_profiling
from deeppreconditioning_tpu_torch.bench import irregular
from deeppreconditioning_tpu_torch.bench.suite import (
    BenchmarkSuite,
    _dense_apply_batched,
    _dense_apply_batched_bf16,
)
from deeppreconditioning_tpu_torch.data.datasets import SludgePatternDataSet
from deeppreconditioning_tpu_torch.data.fvm import (
    generate_sludge_case,
    save_case,
)
from deeppreconditioning_tpu_torch.ops.banded_factor import band_spread
from deeppreconditioning_tpu_torch.models.neural_fsai import (
    neural_fsai_dense_preconditioner,
    neural_fsai_from_checkpoint,
)
from deeppreconditioning_tpu_torch.ops.fsai import round_bf16
from deeppreconditioning_tpu_torch.train.checkpoint import load_checkpoint
from deeppreconditioning_tpu_torch.data.fvm import numpy_assembly


@pytest.fixture(autouse=True, scope="module")
def _numpy_fvm_assembly():
    """The port's numpy FVM assembly: the route the reference's counts
    and arrays held here were made on."""
    with numpy_assembly():
        yield


CKPT = irregular.CHECKPOINT
RTOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the parallel test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _saved(kind, tmp_path_factory):
    """15 saved cases (3 in the test split), the family and the power: the
    sludge split at mesh_cells 1 (power 4), or the irregular one at 1.2
    (n_pad 256, power 2; case 13 of 15 is permuted)."""
    root = tmp_path_factory.mktemp("raw")
    if kind == "sludge":
        rng = np.random.default_rng(23)
        cases = [generate_sludge_case(rng, mesh_cells=1) for _ in range(15)]
        family, power = "sludge_patterns", 4
    else:
        cases = irregular.generate_irregular_cases(samples=15,
                                                   mesh_cells=1.2)
        family, power = "sludge_patterns_3d", irregular.POWER
    for i, case in enumerate(cases):
        save_case(case, root / family / f"case_{i:04d}")
    return kind, root, family, power


@pytest.fixture(scope="module", params=["sludge", "irregular"])
def split(request, tmp_path_factory):
    return _saved(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def sludge(tmp_path_factory):
    return _saved("sludge", tmp_path_factory)


def _suites(split, **kwargs):
    _, root, family, power = split
    jax_ds = JaxDataSet(stage="test", batch_size=1,
                        specs=plan_builder_for("NeuralFSAI", None),
                        shuffle=False, root=root, family=family)
    payload = jax_load_checkpoint(CKPT)
    jax_model = JaxNeuralFSAI(width=int(payload["width"]),
                              hidden=int(payload["hidden"]),
                              poly_degree=int(payload["poly_degree"]))
    ref = JaxSuite(jax_ds, jax_model, payload["params"],
                   techniques=("learned",), dtype=jnp.float64,
                   kappa_cases=0, fsai_power=power, learned_power=power,
                   batched_learned_apply="dense")
    ours = BenchmarkSuite(
        SludgePatternDataSet(stage="test", root=root, family=family),
        neural_fsai_from_checkpoint(load_checkpoint(CKPT)),
        techniques=("learned",), device="cpu", dtype=torch.float64,
        kappa_cases=0, fsai_power=power, learned_power=power,
        batched_learned_apply="dense", **kwargs)
    assert len(ours.data_set) == len(jax_ds) == 3
    return ref, ours


@torch.no_grad()
def test_dense_learned_build_matches_jax(split):
    """The bf16 attempt's build on the sludge split's range plans, the
    float32 attempt's on both plan kinds of the irregular split (the
    generic group's bf16 wrap: ``test_torch_fsai_precision.py``)."""
    precision = "bf16" if split[0] == "sludge" else None
    ref, ours = _suites(split)
    power = ours.learned_power
    groups = ref._batched_fsai_inputs(power, ref.model.width)
    kinds = sorted(g[3] for g in groups)
    assert kinds == (["generic", "range"] if split[0] == "irregular"
                     else ["range"])
    want = ref._dense_m_from_groups(groups, 3, functools.partial(
        _learned_dense_setup_chunk, ref.model.clone(gather="lookup"),
        ref.params, dtype=jnp.float64, precision=precision))
    attempt = torch.bfloat16 if precision == "bf16" else None
    apply_fn, got, _ = ours._batched_setup("learned", 1, 3, m_dtype=attempt)
    want = np.asarray(want)
    if precision == "bf16":
        # the bf16 attempt rounds the bf16-product build as its last step
        assert apply_fn is _dense_apply_batched_bf16
        np.testing.assert_array_equal(got.numpy(),
                                      round_bf16(got).numpy())
        unrounded = ours._dense_m_from_groups(
            ours._batched_fsai_inputs(power, ours.model.width), 3,
            lambda p, o, s, n0: neural_fsai_dense_preconditioner(
                ours.model, p, o, s, n0, dtype=torch.float64,
                precision="bf16"))
        np.testing.assert_array_equal(round_bf16(unrounded).numpy(),
                                      got.numpy())
        got = unrounded
    else:
        assert apply_fn is _dense_apply_batched
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())
    # one B1 launch per chunk of every plan group and build
    assert ours.batched_launch_groups["learned"] == len(groups) * (
        ours.batched_builds["learned"])


def test_run_batched_dense_learned_matches_jax(split, monkeypatch):
    """The whole protocol through the dense route, float32 M: per-case
    counts, trips and success equal to the JAX run's."""
    monkeypatch.setattr(jax_profiling, "time_dispatch_chain",
                        lambda step, reps=(3, 12), blocks=2: 0.0)
    ref, ours = _suites(split)
    want = ref.run_batched(reps=1, setup_reps=1, chunk=3, m_dtype=None)
    got = ours.run_batched(reps=1, setup_reps=1, chunk=3, m_dtype=None)
    for key in ("iterations_per_case", "trips", "success"):
        assert got["learned"][key] == want["learned"][key], key
    assert got["learned"]["m_dtype"] == "float32"


@torch.no_grad()
def test_auto_picks_the_route_as_the_reference(sludge):
    """"auto" takes band form while the split's band spread fits the cap,
    the dense M past it; "banded" takes band form whatever the spread."""
    _, ours = _suites(sludge)
    n_pad = ours.data_set.dof_pad
    spread = max(band_spread(p.out_rows.numpy(), n_pad) for _, p, _, _ in
                 ours._batched_fsai_inputs(ours.learned_power,
                                           ours.model.width))
    assert 1 < spread <= n_pad
    for route, cap, banded in (
            ("auto", spread, True), ("auto", spread - 1, False),
            ("banded", spread - 1, True), ("dense", spread, False)):
        ours.batched_learned_apply, ours.banded_spread_cap = route, cap
        _, m_data, _ = ours._batched_setup("learned", 1, 3)
        assert isinstance(m_data, tuple) == banded, (route, cap)
        if banded:  # (bands (B, spread, n_pad), q, a_data)
            assert m_data[0].shape[1] == spread


def test_unknown_batched_learned_apply_is_refused():
    with pytest.raises(ValueError, match="batched_learned_apply"):
        BenchmarkSuite(None, techniques=("fsai",), device="cpu",
                       batched_learned_apply="factor")
