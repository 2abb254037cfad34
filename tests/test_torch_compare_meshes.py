"""The one-off deployed setup and the mesh-generalization study against the
JAX package's: ``neural_fsai_case_setup`` on a ``mesh_cells=3`` case in
float64 (M to 1e-9 of max |M|) and its plan at a width below the
pattern's (capped as the reference caps it); the
study's first resolution on the CPU in float32 (the host kappas of the
larger ones take minutes here; the card runs all five) against the JAX
CPU float32 fixture (``tests/fixtures/torch_port/compare_meshes.json``: dof
equal, kappa(A) to 1e-12, kappa(M A) to 1e-4); its conv branch against
``scripts/compare_meshes.py``'s on one case (float32, 1e-4); the
csv in the script's schema."""

import dataclasses
import json
import sys
from pathlib import Path

import flax.serialization
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppreconditioning_tpu.models import NeuralFSAI as JaxNeuralFSAI
from deeppreconditioning_tpu.models.neural_fsai import (
    neural_fsai_case_setup as jax_case_setup,
)
from deeppreconditioning_tpu_torch import compare_meshes
from deeppreconditioning_tpu_torch.config import params_show
from deeppreconditioning_tpu_torch.data.fvm import generate_sludge_case
from deeppreconditioning_tpu_torch.models.neural_fsai import (
    neural_fsai_case_plan,
    neural_fsai_case_setup,
    neural_fsai_from_checkpoint,
)
from deeppreconditioning_tpu_torch.ops.fsai import (
    pattern_col_width,
    tril_power_pattern,
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
CKPT = REPO / "assets" / "checkpoints_fsai" / "best.msgpack"
FIXTURE = REPO / "tests" / "fixtures" / "torch_port" / "compare_meshes.json"
KAPPA_POST_RTOL = 1e-4  # float32 M on the CPU, both sides


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the parallel test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_case_setup_matches_jax():
    case = generate_sludge_case(np.random.default_rng(5), mesh_cells=3)
    a = case.matrix.tocsr()
    payload = flax.serialization.msgpack_restore(CKPT.read_bytes())
    jax_model = JaxNeuralFSAI(width=int(payload["width"]),
                              hidden=int(payload["hidden"]),
                              poly_degree=int(payload["poly_degree"]))
    power = int(payload["power"])
    want, n_pad_ref = jax_case_setup(jax_model, payload["params"], a, power,
                                     dtype=jnp.float64)
    model = neural_fsai_from_checkpoint(load_checkpoint(CKPT))
    got, n_pad = neural_fsai_case_setup(model, a, power,
                                        dtype=torch.float64, device="cpu")
    assert n_pad == n_pad_ref == ((a.shape[0] + 127) // 128) * 128
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9,
                               atol=1e-9 * np.abs(want).max())
    n = a.shape[0]
    assert not got[n:].any() and not got[:, n:].any()
    # a width below the pattern's takes the reference's capped pattern
    from deeppreconditioning_tpu.ops import fsai as jax_fsai

    capped = neural_fsai_case_plan(a, power, width=12, dtype=torch.float64,
                                   device="cpu")
    l0 = capped.plan
    keep = l0.l0_rows < capped.n_pad
    r0, c0 = l0.l0_rows[keep].numpy(), l0.l0_cols[keep].numpy()
    assert pattern_col_width(*tril_power_pattern(
        r0, c0, capped.n_pad, power=power)) > 12
    pr, pc = jax_fsai.tril_power_pattern_capped(
        r0, c0, capped.l0_vals.double().numpy(), capped.n_pad, power=power,
        width=12)
    ref_plan = jax_fsai.build_fsai_plan(r0, c0, pr, pc, capped.n_pad,
                                        width=12)
    np.testing.assert_array_equal(l0.out_rows.numpy(), ref_plan.out_rows)
    np.testing.assert_array_equal(l0.sub_idx.numpy(), ref_plan.sub_idx)


def test_study_matches_the_jax_fixture(monkeypatch):
    """The study's first row (the rng stream starts the same), its
    resolutions cut to mesh_cells 2 here."""
    fixture = json.loads(FIXTURE.read_text())
    assert (fixture["seed"], fixture["cases_per_resolution"]) == (
        compare_meshes.SEED, 1)
    assert [r["mesh_cells"] for r in fixture["rows"]] == list(
        compare_meshes.MESH_CELLS)
    monkeypatch.setattr(compare_meshes, "MESH_CELLS", (2,))
    rows = compare_meshes.run("cpu", 1)
    assert len(rows) == 1 and rows[0]["setups"] == (
        compare_meshes.TIMING_REPS + 2)
    for got, want in zip(rows, fixture["rows"]):
        assert (got["mesh_cells"], got["dof"]) == (want["mesh_cells"],
                                                   want["dof"])
        assert got["kappa_pre"] == pytest.approx(want["kappa_pre"],
                                                 rel=1e-12)
        assert got["kappa_post"] == pytest.approx(want["kappa_post"],
                                                  rel=KAPPA_POST_RTOL)
        assert got["kappa_post"] < got["kappa_pre"] / 100


def test_conv_branch_matches_the_script(tmp_path, monkeypatch):
    """params.yaml's model swapped for PreconditionerNet: the script's
    ``_kappa_for_case`` and the port's conv branch on the study's first
    case, drawn at mesh_cells 1 here (n ~ 180) to keep the host kappas
    short."""
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        from compare_meshes import _kappa_for_case
    finally:
        sys.path.remove(str(REPO / "scripts"))
    from deeppreconditioning_tpu.config import get_model_class
    from deeppreconditioning_tpu.models import plan_builder_for
    from deeppreconditioning_tpu.train.trainer import load_checkpoint as jl

    params = dataclasses.replace(params_show(REPO / "params.yaml"),
                                 model="PreconditionerNet",
                                 checkpoint_dir="assets/checkpoints")
    monkeypatch.setattr(compare_meshes, "MESH_CELLS", (1,))
    [got] = compare_meshes.run("cpu", 1, params=params)
    case = generate_sludge_case(np.random.default_rng(compare_meshes.SEED),
                                mesh_cells=1)
    payload = jl(REPO / "assets" / "checkpoints" / "best.msgpack")
    model = get_model_class("PreconditionerNet")(
        channels=tuple(params.channels))
    pre, post = _kappa_for_case(
        case, model, payload["params"],
        plan_builder_for("PreconditionerNet", params.channels))
    assert got["dof"] == case.matrix.shape[0]
    assert got["kappa_pre"] == pytest.approx(pre, rel=1e-12)
    assert got["kappa_post"] == pytest.approx(post, rel=KAPPA_POST_RTOL)
    assert got["setup_s"] is None and got["setups"] == 0
    compare_meshes.write_csv([got], tmp_path / "compare_meshes.csv")
    header, line = (tmp_path / "compare_meshes.csv").read_text().split()
    assert header == "mesh_cells,dof,kappa_pre,kappa_post"
    assert line.split(",")[:2] == ["1", str(got["dof"])]
