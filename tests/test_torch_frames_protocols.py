"""The frames family's new rows and the batched protocols' fixtures.

* The JAX CPU float32 fixtures of ``scripts/torch_port_protocols_
  reference.py`` describe what the port runs: the frames split, its IC
  row and batched techniques, ``batched_probe``'s irregular split,
  techniques and chunk, and the learned route each took.
* The port's frames suite on the CPU in float32 reproduces the fixture's
  IC(0) counts on four cases (within 2 of the span of its float32 and
  float64 counts, success equal) and case 0's
  kappa (1e-6); the host runtime's IC(0) equals the numpy one bit for bit
  on the split's first cases.
* On a small saved frames split with a generic case, in float64 against
  the JAX suite: the band-form learned setup over both plan groups (the
  generic group's bands from ``extract_bands`` with per-case n0) to 1e-9,
  and bands cut below the spread.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
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
from deeppreconditioning_tpu.utils import profiling as jax_profiling
from deeppreconditioning_tpu_torch import native
from deeppreconditioning_tpu_torch.bench import batched_probe, frames
from deeppreconditioning_tpu_torch.bench import irregular
from deeppreconditioning_tpu_torch.bench.suite import BenchmarkSuite
from deeppreconditioning_tpu_torch.data.datasets import SludgePatternDataSet
from deeppreconditioning_tpu_torch.data.frames import generate_frame_case
from deeppreconditioning_tpu_torch.data.fvm import save_case
from deeppreconditioning_tpu_torch.models.neural_fsai import (
    neural_fsai_from_checkpoint,
)
from deeppreconditioning_tpu_torch.ops.ic0 import ic0_factor
from deeppreconditioning_tpu_torch.train.checkpoint import load_checkpoint

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "torch_port"
IC = "incomplete_cholesky"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the parallel test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fixture(name):
    return json.loads((FIXTURES / f"{name}.json").read_text())


def test_fixtures_describe_the_port_protocols():
    cap = BenchmarkSuite(None, techniques=("fsai",),
                         device="cpu").banded_spread_cap
    ic = _fixture("frames_ic_iterations")
    assert (ic["seed"], ic["samples"], ic["cases"], ic["n_pad"]) == (
        frames.SEED, frames.SAMPLES, 40, 768)
    assert ic["technique"] == IC and IC in frames.TECHNIQUES
    assert len(ic["iterations"]) == len(ic["iterations_f64"]) == 40
    assert all(ic["success"])
    bat = _fixture("frames_batched_iterations")
    assert (bat["seed"], bat["cases"], bat["n_pad"]) == (frames.SEED, 40, 768)
    assert bat["techniques"] == [t for t in frames.TECHNIQUES
                                 if t in BenchmarkSuite._BATCHED_CHECK_EVERY]
    assert bat["learned_apply"] == "banded" and bat["learned_d_max"] <= cap
    assert bat["plan_groups"]["learned"] == [["range", 31], ["generic", 9]]
    assert len(bat["vanilla_f64"]) == 40
    probe = _fixture("irregular_batched_iterations")
    assert (probe["seed"], probe["samples"], probe["cases"],
            probe["n_pad"]) == (irregular.SEED, irregular.SAMPLES, 20, 1408)
    assert probe["techniques"] == list(batched_probe.TECHNIQUES)
    assert probe["chunk"] == batched_probe.CHUNK
    assert probe["learned_apply"] == "dense"
    assert probe["learned_d_max"] > cap
    assert probe["plan_groups"]["learned"] == [["range", 10],
                                               ["generic", 10]]
    for record in (bat, probe):
        for name in record["techniques"]:
            iters = record["iterations"][name]
            assert len(iters) == record["cases"]
            assert record["trips"][name] == max(iters) + 2
            assert record["m_dtype"][name] in ("bfloat16", "float32")


@pytest.fixture(scope="module")
def frames_split():
    """The port's frames suite (CPU, float32, as the fixture's JAX run),
    its cases drawn without the ground-truth solutions no technique
    reads."""
    return frames.frames_suite(
        "cpu", dtype=torch.float32,
        cases=frames.generate_frame_cases(solve=False))


@pytest.mark.parametrize("index", [0, 2, 19, 25])
def test_port_frames_ic_matches_the_fixture(frames_split, index):
    """Within 2 of the span of the JAX float32 and float64 counts (case
    19's float32 run stops at 9.997e-9 of the 1e-8 tolerance, three
    iterations before its float64 run and the port's)."""
    ref = _fixture("frames_ic_iterations")
    suite = frames_split
    _, ell, b = suite._system(index)
    with torch.no_grad():
        res = suite._solve(ell, b, *suite.setup(IC, index))
    span = sorted((ref["iterations"][index], ref["iterations_f64"][index]))
    assert span[0] - 2 <= int(res.iterations) <= span[1] + 2
    assert bool(float(res.residual) < suite.rtol) == ref["success"][index]


def test_port_frames_ic_kappa_and_native_factor(frames_split):
    ref = _fixture("frames_ic_iterations")
    suite = frames_split
    a, ell, _ = suite._system(0)
    _, _, density, m_sp = suite._setup_incomplete_cholesky(0, a, ell, True)
    kappa = float(np.linalg.cond((m_sp @ a).toarray()))
    assert kappa == pytest.approx(ref["kappa_case0"], rel=1e-6)
    assert density == pytest.approx(ref["density_case0"], rel=1e-12)
    saved = native.available
    for index in range(4):
        a = suite._reconstruct(index)[0]
        ours = ic0_factor(a)
        try:
            native.available = lambda: False
            want = ic0_factor(a)
        finally:
            native.available = saved
        np.testing.assert_array_equal(ours.data, want.data)


@pytest.fixture(scope="module")
def small_frames(tmp_path_factory):
    """15 saved frame cases (3 in the test split, n_pad 640, one on the
    generic plan), the JAX suite and the port's in float64, learned
    only."""
    root = tmp_path_factory.mktemp("raw")
    rng = np.random.default_rng(20)
    for i in range(15):
        save_case(generate_frame_case(rng, max_dof=600, solve=False),
                  root / "frame_structures" / f"case_{i:04d}")
    payload = jax_load_checkpoint(frames.CHECKPOINT)
    ref = JaxSuite(
        JaxDataSet(stage="test", batch_size=1,
                   specs=plan_builder_for("NeuralFSAI", None),
                   shuffle=False, root=root, family="frame_structures"),
        JaxNeuralFSAI(width=int(payload["width"]),
                      hidden=int(payload["hidden"]),
                      poly_degree=int(payload["poly_degree"])),
        payload["params"], techniques=("learned",), dtype=jnp.float64,
        kappa_cases=0, fsai_power=frames.FSAI_POWER,
        learned_power=frames.FSAI_POWER)
    ours = BenchmarkSuite(
        SludgePatternDataSet(stage="test", root=root,
                             family="frame_structures"),
        neural_fsai_from_checkpoint(load_checkpoint(frames.CHECKPOINT)),
        techniques=("learned",), device="cpu", dtype=torch.float64,
        kappa_cases=0, fsai_power=frames.FSAI_POWER,
        learned_power=frames.FSAI_POWER)
    return ref, ours


@torch.no_grad()
def test_frames_band_route_over_both_groups_matches_jax(small_frames,
                                                        monkeypatch):
    """The route "auto" takes at the split's spread: bands and q over the
    range and the generic group against the JAX setup (float32 attempt,
    no bf16; 1e-9 of max |bands|); the generic case's bands stop at its
    n0; and bands cut to a d_max below the spread are the full bands'
    first d_max rows (offsets past d_max dropped, as the reference's
    one-hot drops them)."""
    monkeypatch.setattr(jax_profiling, "time_dispatch_chain",
                        lambda step, reps=(3, 12), blocks=2: 0.0)
    ref, ours = small_frames
    groups = ours._batched_fsai_inputs(ours.learned_power, ours.model.width)
    assert sorted(g[3] for g in groups) == ["generic", "range"]
    _, m_data, _ = ours._batched_setup("learned", 1, 3)
    route, spread = ours.batched_routes["learned"]
    assert route == "banded" and m_data[0].shape[1] == spread
    _, ref_m, _ = ref._batched_setup("learned", 1, 3)
    for got, want in zip(m_data[:2], ref_m[:2]):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-9,
                                   atol=1e-9 * np.abs(want).max())
    n0s = ours._batched_common()["n0"].numpy()
    idx = next(g[0] for g in groups if g[3] == "generic")
    assert not m_data[0][idx[0], :, n0s[idx[0]]:].any()
    d_max = 64
    assert spread > d_max
    _, cut, _ = ours._banded_learned_setup(groups, d_max, 1, 3, None)
    np.testing.assert_array_equal(cut[0].numpy(),
                                  m_data[0][:, :d_max].numpy())
