"""The structured-grid trainer (``train/structured.py``) against the JAX
package, f64 on the CPU: the offset-form factor halves and both apply
factories, ``structured_setup`` with the safeguard on and off, the batched
setup against one setup per sample (one B1 call for all samples),
batched B2's plain version and its autograd backward on an unsymmetric
DIA, the script's ``case_loss`` and its gradients against
``jax.value_and_grad`` of the transcription in
``scripts/torch_port_structured_train_reference.py`` (w 13 and w 4),
Adam steps with the best-loss pairing, and the written payload as Flax
and the JAX setup read it; the committed fixture describes the
entry point's run."""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from deeppreconditioning_tpu.ops import structured_fsai as jsf
from deeppreconditioning_tpu.sparse.dia import DIAMatrix as JaxDIA
from deeppreconditioning_tpu_torch.models.neural_fsai import (
    NeuralFSAI,
    params_from_jax,
    params_to_jax,
)
from deeppreconditioning_tpu_torch.ops import dia_spmv
from deeppreconditioning_tpu_torch.ops import structured_fsai as sf
from deeppreconditioning_tpu_torch.sparse.dia import DIAMatrix
from deeppreconditioning_tpu_torch.train import structured as st
from deeppreconditioning_tpu_torch.train.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "torch_port"
CKPT = REPO / "assets" / "checkpoints_structured" / "deg1_random.msgpack"
SHAPE, SAMPLES, PCG_STEPS, HIDDEN = (6, 6, 6), 3, 3, 16
CONFIGS = {"w13": (2, 1), "w4": (1, 0)}  # (power, degree)


def _reference():
    spec = importlib.util.spec_from_file_location(
        "torch_port_structured_train_reference",
        REPO / "scripts" / "torch_port_structured_train_reference.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


REF = _reference()


def _port_model(params, width, degree):
    hidden = np.asarray(params["dense0"]["kernel"]).shape[1]
    model = NeuralFSAI(width, hidden, degree).double()
    model.load_state_dict(params_from_jax(
        {"params": jax.tree.map(np.asarray, params)}))
    return model


def _jax_params(width, degree):
    """The script's init at HIDDEN with nonzero heads and q, so every
    parameter carries a gradient."""
    params = REF.init_params(width, HIDDEN, degree, 69, jnp.float64)
    return jax.tree.map(
        lambda x: x + 0.01 * jnp.sin(jnp.arange(x.size).reshape(x.shape)),
        params)


def _operator(sigma, seed, shape=(8, 8, 8)) -> DIAMatrix:
    """One sorted operator of the training family, from the reference's
    data path."""
    vals, _, offsets, n = REF.make_data(shape, 1, (sigma, sigma), "random",
                                        seed, jnp.float64)
    return DIAMatrix(vals=torch.tensor(np.asarray(vals[0])), offsets=offsets,
                     n=n)


def _jax_dia(a: DIAMatrix) -> JaxDIA:
    return JaxDIA(vals=jnp.asarray(a.vals.numpy()), offsets=a.offsets, n=a.n)


@pytest.fixture(scope="module")
def problems():
    """Per configuration: the data in both packages, the plans, the JAX
    params and its value and gradient of the batch mean."""
    out = {}
    for tag, (power, degree) in CONFIGS.items():
        plan = jsf.build_structured_plan(SHAPE, power)
        vals, b, offsets, n = REF.make_data(SHAPE, SAMPLES, (1.0, 1.0),
                                            "random", 69, jnp.float64)
        params = _jax_params(plan.width, degree)
        loss_fn = REF.make_loss_fn(REF.make_case_loss(plan, offsets, n,
                                                      degree, PCG_STEPS))
        value_and_grad = jax.jit(jax.value_and_grad(loss_fn))
        loss, grads = value_and_grad(params, vals, b)
        out[tag] = dict(plan=plan, vals=vals, b=b, params=params,
                        loss=float(loss), grads=grads, degree=degree,
                        value_and_grad=value_and_grad)
    return out


@pytest.mark.parametrize("batched", [False, True])
def test_offset_matvecs_match_jax(batched):
    plan = sf.build_structured_plan((6, 5, 4), power=2)
    rng = np.random.default_rng(0)
    lead = (3,) if batched else ()
    bands = rng.standard_normal(lead + (plan.width, 1024))
    r = rng.standard_normal(lead + (1024,))
    for name in ("offset_upper_matvec", "offset_lower_matvec"):
        got = getattr(sf, name)(torch.tensor(bands), torch.tensor(r),
                                plan.offsets).numpy()
        ref = getattr(jsf, name)
        if batched:
            want = np.stack([ref(jnp.asarray(bands[i]), jnp.asarray(r[i]),
                                 plan.offsets) for i in range(3)])
        else:
            want = ref(jnp.asarray(bands), jnp.asarray(r), plan.offsets)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-10,
                                   atol=1e-12)


@pytest.mark.parametrize("safeguard", [True, False])
def test_setup_and_both_applies_match_jax(safeguard):
    """``structured_setup`` with the w-13 checkpoint, safeguard on and
    off, and both apply factories on its factor."""
    payload = serialization.msgpack_restore(CKPT.read_bytes())
    params = jax.tree.map(lambda v: jnp.asarray(v, jnp.float64),
                          payload["params"])
    model = _port_model(params["params"], 13, 1)
    a = _operator(2.0, 5)
    ref_a = _jax_dia(a)
    plan = sf.build_structured_plan((8, 8, 8), power=2)
    ref_plan = jsf.build_structured_plan((8, 8, 8), power=2)
    want_bands, want_q = jsf.structured_setup(ref_a, ref_plan, params,
                                              safeguard=safeguard)
    with torch.no_grad():
        bands, q = sf.structured_setup(a, plan, model, safeguard=safeguard)
    np.testing.assert_allclose(bands.numpy(), np.asarray(want_bands),
                               rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(q.numpy(), np.asarray(want_q), rtol=1e-10)
    r = np.random.default_rng(6).standard_normal(a.n_pad)
    want = jsf.make_structured_poly_apply(ref_plan.offsets, 1)(
        (want_bands, want_q, ref_a), jnp.asarray(r))
    got = sf.make_structured_poly_apply(plan.offsets, 1)(
        (bands, q, a), torch.tensor(r))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                               atol=1e-12 * np.abs(np.asarray(want)).max())
    c_up, c_low = sf.bands_to_dia(bands, plan.offsets, a.n)
    got_dia = sf.make_structured_poly_apply_dia(1)((c_up, c_low, q, a),
                                                   torch.tensor(r))
    np.testing.assert_allclose(got_dia.numpy(), np.asarray(want),
                               rtol=1e-10,
                               atol=1e-12 * np.abs(np.asarray(want)).max())


def test_batched_setup_is_one_b1_call(monkeypatch):
    """S samples' setup equals one setup per sample, with every sample's
    local systems in one call of B1 (N = S * n_pad)."""
    a, _ = st.make_data(SHAPE, SAMPLES, (0.5, 1.5), "random", 3,
                        torch.float64)
    plan = sf.build_structured_plan(SHAPE, power=2)
    model = NeuralFSAI(plan.width, HIDDEN, 1).double()
    calls = []
    solve = sf.masked_gauss_jordan

    def counted(sub, e):
        calls.append(sub.shape[0])
        return solve(sub, e)

    monkeypatch.setattr(sf, "masked_gauss_jordan", counted)
    bands, q = sf.structured_setup(a, plan, model, safeguard=False)
    assert calls == [SAMPLES * a.n_pad]
    assert bands.shape == (SAMPLES, plan.width, a.n_pad)
    assert bands.requires_grad and q.requires_grad
    with torch.no_grad():
        for i in range(SAMPLES):
            one = DIAMatrix(vals=a.vals[i], offsets=a.offsets, n=a.n)
            b_i, q_i = sf.structured_setup(one, plan, model, safeguard=False)
            np.testing.assert_allclose(bands[i].detach().numpy(),
                                       b_i.numpy(), rtol=1e-13, atol=1e-15)
            np.testing.assert_array_equal(q.detach().numpy(), q_i.numpy())
    with pytest.raises(ValueError, match="safeguard"):
        sf.structured_setup(a, plan, NeuralFSAI(plan.width, HIDDEN, 1)
                            .double())


def _unsymmetric_dia(batch, n_pad=1024):
    """Five bands with values everywhere, pad rows and the reads past the
    ends included: no symmetry for the transpose to lean on."""
    rng = np.random.default_rng(11)
    vals = rng.standard_normal((batch, 5, n_pad))
    return DIAMatrix(vals=torch.tensor(vals), offsets=(-37, -1, 0, 2, 300),
                     n=n_pad - 24)


def test_batched_plain_product_and_transpose():
    a = _unsymmetric_dia(3)
    x = torch.tensor(np.random.default_rng(12).standard_normal((3, 1024)))
    y = dia_spmv.dia_matvec(a, x)
    for i in range(3):
        dense = np.zeros((1024, 1024))
        for d, off in enumerate(a.offsets):
            rows = np.arange(1024)
            ok = (rows + off >= 0) & (rows + off < 1024)
            dense[rows[ok], rows[ok] + off] = a.vals[i, d].numpy()[ok]
        np.testing.assert_allclose(y[i].numpy(), dense @ x[i].numpy(),
                                   rtol=1e-12, atol=1e-12)
        at = a.transpose()
        assert at.offsets == tuple(-o for o in a.offsets)
        one = DIAMatrix(vals=at.vals[i], offsets=at.offsets, n=a.n)
        np.testing.assert_allclose(one.matvec(x[i]).numpy(),
                                   dense.T @ x[i].numpy(), rtol=1e-12,
                                   atol=1e-12)


def test_autograd_backward_is_the_transposed_product():
    """``DIAMatvec``'s backward (the dispatch on A^T) against autograd of
    the plain product; values that need a gradient are refused."""
    a = _unsymmetric_dia(2)
    rng = np.random.default_rng(13)
    x0 = torch.tensor(rng.standard_normal((2, 1024)))
    g = torch.tensor(rng.standard_normal((2, 1024)))
    x = x0.clone().requires_grad_(True)
    y = dia_spmv.dia_matvec(a, x)
    assert y.grad_fn.name().startswith("DIAMatvec")
    y.backward(g)
    ref_x = x0.clone().requires_grad_(True)
    a.matvec(ref_x).backward(g)
    np.testing.assert_allclose(y.detach().numpy(), a.matvec(x0).numpy(),
                               rtol=0, atol=0)
    np.testing.assert_allclose(x.grad.numpy(), ref_x.grad.numpy(),
                               rtol=1e-12, atol=1e-12)
    x.grad = None
    dia_spmv.dia_matvec(a, x, a.transpose()).backward(g)
    np.testing.assert_allclose(x.grad.numpy(), ref_x.grad.numpy(),
                               rtol=1e-12, atol=1e-12)
    needs = DIAMatrix(vals=a.vals.clone().requires_grad_(True),
                      offsets=a.offsets, n=a.n)
    with pytest.raises(ValueError, match="no gradient"):
        dia_spmv.DIAMatvec.apply(x, needs, None)


@pytest.mark.parametrize("tag", list(CONFIGS))
def test_case_loss_and_gradients_match_jax(problems, tag):
    ref = problems[tag]
    plan = sf.build_structured_plan(SHAPE, power=CONFIGS[tag][0])
    a, b = st.make_data(SHAPE, SAMPLES, (1.0, 1.0), "random", 69,
                        torch.float64)
    np.testing.assert_array_equal(a.vals.numpy(), np.asarray(ref["vals"]))
    np.testing.assert_array_equal(b.numpy(), np.asarray(ref["b"]))
    model = _port_model(ref["params"], plan.width, ref["degree"])
    loss = st.batch_loss(model, plan, a, a.transpose(), b, PCG_STEPS)
    loss.backward()
    assert np.isfinite(float(loss.detach()))
    np.testing.assert_allclose(float(loss.detach()), ref["loss"], rtol=1e-8)
    grads = params_to_jax({f"{k}": p.grad for k, p in
                           model.named_parameters()})["params"]
    want = jax.tree.map(np.asarray, ref["grads"])
    for layer, leaves in grads.items():
        for leaf, got in (leaves.items() if isinstance(leaves, dict)
                          else [(None, leaves)]):
            w = want[layer] if leaf is None else want[layer][leaf]
            np.testing.assert_allclose(got, w, rtol=1e-8,
                                       atol=1e-10 * np.abs(w).max() + 1e-14,
                                       err_msg=f"{layer} {leaf}")


def test_adam_steps_and_best_pairing(problems, tmp_path):
    """Three steps of the entry point's run (w 4, from the JAX params)
    against optax Adam on the transcription: equal losses, and the payload
    holds the parameters from before the best step's update."""
    ref = problems["w4"]
    init = tmp_path / "init.msgpack"
    save_checkpoint(init, {"params": {"params": jax.tree.map(
        np.asarray, ref["params"])}, "width": 4, "hidden": HIDDEN,
        "poly_degree": 0, "power": 1})
    args = st.parse_args([
        "--shape", ",".join(map(str, SHAPE)), "--samples", str(SAMPLES),
        "--steps", "3", "--power", "1", "--degree", "0", "--hidden",
        str(HIDDEN), "--pcg-steps", str(PCG_STEPS), "--init-from", str(init),
        "--out", str(tmp_path / "best.msgpack"), "--device", "cpu"])
    run = st.run(args, dtype=torch.float64, log=lambda line: None)

    tx = optax.adam(2e-3)
    params, opt_state = ref["params"], tx.init(ref["params"])
    step = ref["value_and_grad"]
    history, losses = [], []
    for _ in range(3):
        loss, grads = step(params, ref["vals"], ref["b"])
        history.append(params)
        losses.append(float(loss))
        updates, opt_state = tx.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
    np.testing.assert_allclose(run.losses, losses, rtol=1e-8)
    best = int(np.argmin(losses))
    assert run.best_step == best and run.best_loss == min(run.losses)
    got = run.payload["params"]["params"]
    want = jax.tree.map(np.asarray, history[best])
    for layer in ("dense0", "dense1", "alpha", "beta"):
        for leaf in ("kernel", "bias"):
            np.testing.assert_allclose(got[layer][leaf],
                                       want[layer][leaf].astype(np.float32),
                                       rtol=1e-6, atol=1e-9)
    assert run.payload["final_loss"] == run.best_loss


def test_payload_read_by_flax_and_the_jax_setup(tmp_path):
    """The written payload is what ``flax.serialization.msgpack_restore``
    and ``scripts/scaling_learned.py`` read, and the JAX setup on it equals
    the port's."""
    args = st.parse_args([
        "--shape", "6,6,6", "--samples", "2", "--steps", "2", "--hidden",
        str(HIDDEN), "--pcg-steps", "2", "--sigma", "0.5:1.5", "--rhs", "ax",
        "--out", str(tmp_path / "best.msgpack"), "--device", "cpu"])
    run = st.run(args, dtype=torch.float64, log=lambda line: None)
    payload = serialization.msgpack_restore(run.out.read_bytes())
    assert {k: payload[k] for k in ("width", "hidden", "poly_degree",
                                    "power", "family", "train_shape",
                                    "sigma", "rhs")} == {
        "width": 13, "hidden": HIDDEN, "poly_degree": 1, "power": 2,
        "family": "structured_poisson", "train_shape": [6, 6, 6],
        "sigma": [0.5, 1.5], "rhs": "ax"}
    assert payload["final_loss"] == run.best_loss
    assert payload["params"]["params"]["dense0"]["kernel"].dtype == np.float32
    a = _operator(1.0, 4)
    params = jax.tree.map(lambda v: jnp.asarray(v, jnp.float64),
                          payload["params"])
    want, want_q = jsf.structured_setup(
        _jax_dia(a), jsf.build_structured_plan((8, 8, 8), 2), params)
    model = _port_model(params["params"], 13, 1)
    model.load_state_dict(params_from_jax(load_checkpoint(run.out)["params"]))
    with torch.no_grad():
        got, q = sf.structured_setup(
            a, sf.build_structured_plan((8, 8, 8), 2), model.double())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                               atol=1e-13)
    np.testing.assert_allclose(q.numpy(), np.asarray(want_q), rtol=1e-10)


def test_fixture_describes_the_entry_point():
    fixture = json.loads((FIXTURES / "structured_train.json").read_text())
    defaults = st.parse_args([])
    for tag, (power, degree) in CONFIGS.items():
        run = fixture["runs"][tag]
        cfg = run["config"]
        assert (cfg["shape"], cfg["samples"], cfg["lr"], cfg["hidden"],
                cfg["pcg_steps"], cfg["rhs"], cfg["seed"]) == (
            [int(s) for s in defaults.shape.split(",")], defaults.samples,
            defaults.lr, defaults.hidden, defaults.pcg_steps, defaults.rhs,
            defaults.seed)
        assert tuple(cfg["sigma"]) == st.parse_sigma(defaults.sigma)
        assert (cfg["power"], cfg["degree"]) == (power, degree)
        assert run["width"] == {"w13": 13, "w4": 4}[tag]
        assert len(run["losses"]) == cfg["steps"]
        assert np.isfinite(run["losses"]).all()
        payload = load_checkpoint(
            FIXTURES / f"structured_train_init_{tag}.msgpack")
        assert (payload["width"], payload["poly_degree"], payload["power"]) \
            == (run["width"], degree, power)
    printed = fixture["script"]["printed_losses"]
    for step, loss in printed.items():
        assert f"{fixture['runs']['w13']['losses'][int(step)]:+.4f}" == \
            f"{loss:+.4f}"
