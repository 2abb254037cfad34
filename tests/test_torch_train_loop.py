"""The port's NeuralFSAI trainer against the JAX package's, on small
sludge cases (one cell per pattern, batch 2, width 16, hidden 16): the
train step's loss and every parameter gradient for ``pcg_loss``,
``inverse_loss`` and ``kaporin_loss`` against ``jax.value_and_grad`` of
the same objective (float64, 1e-9 relative), the validation loss and
per-case iterations, two epochs of ``train_neural_fsai`` (the
``metrics.jsonl`` series), and checkpoints read both ways: JAX's
``load_checkpoint`` / ``resume_state`` on the port's ``latest.msgpack``,
and the port resuming from JAX's.

Both sides take the same float64 batches (the float32 batches of each
dataset, widened).  In the JAX trainer the Dense kernels stay float32
(Flax's ``param_dtype``), so its weights round to float32 after every
update; its epoch metrics are held to 1e-5 relative for that reason."""

import json

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeppreconditioning_tpu import metrics as jax_metrics
from deeppreconditioning_tpu.data.datasets import (
    SludgePatternDataSet as JaxSludgePatternDataSet,
)
from deeppreconditioning_tpu.models import plan_builder_for
from deeppreconditioning_tpu.models import neural_fsai as jax_nf
from deeppreconditioning_tpu.train import trainer as jax_trainer
from deeppreconditioning_tpu_torch.data.datasets import PlannedDataSet
from deeppreconditioning_tpu_torch.data.fvm import (
    generate_sludge_case,
    save_case,
)
from deeppreconditioning_tpu_torch.models import neural_fsai as nf
from deeppreconditioning_tpu_torch.sparse.coo import BatchedCOO
from deeppreconditioning_tpu_torch.train import trainer
from deeppreconditioning_tpu_torch.train.checkpoint import load_checkpoint
from deeppreconditioning_tpu_torch.data.fvm import numpy_assembly


@pytest.fixture(autouse=True, scope="module")
def _numpy_fvm_assembly():
    """The port's numpy FVM assembly: the route the reference's counts
    and arrays held here were made on."""
    with numpy_assembly():
        yield


CASES, BATCH, SEED = 12, 2, 69
POWER, WIDTH, HIDDEN, DEGREE = 3, 16, 16, 2
RANGE_H, GENERIC_H = 64, 32
PCG_STEPS = 4  # the one-cell systems converge in ~10 iterations
LR, EPOCHS = 1e-3, 2


class _Widened:
    """Batches of a split view with every float leaf in float64, built
    once per batch (the reference's plan provider keys on the batch's
    identity)."""

    def __init__(self, base, indices, widen):
        self.base, self.indices, self.widen = base, list(indices), widen
        self.batch_size = base.batch_size
        self._cache = {}

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        if i not in self._cache:
            self._cache[i] = self.widen(self.base[self.indices[i]])
        return self._cache[i]


def _widen_jax(b):
    f64 = jnp.float64
    return b._replace(
        features=b.features.astype(f64),
        systems=b.systems.replace(values=b.systems.values.astype(f64)),
        solutions=b.solutions.astype(f64),
        right_hand_sides=b.right_hand_sides.astype(f64),
        scales=b.scales.astype(f64))


def _widen_torch(b):
    s = b.systems
    return b._replace(
        features=b.features.double(),
        systems=BatchedCOO(s.indices, s.values.double(), s.valid,
                           s.batch_size, s.spatial_shape),
        solutions=b.solutions.double(),
        right_hand_sides=b.right_hand_sides.double(),
        scales=b.scales.double())


def _random_params(seed):
    """Float32-representable params with nonzero heads (so every
    gradient is nonzero), as a Flax variables tree of float64."""
    rng = np.random.default_rng(seed)
    shapes = {"dense0": (4 * WIDTH, HIDDEN), "dense1": (HIDDEN, HIDDEN),
              "alpha": (HIDDEN, WIDTH), "beta": (HIDDEN, WIDTH)}
    tree = {name: {"bias": rng.standard_normal(s[1]) * 0.05,
                   "kernel": rng.standard_normal(s) * 0.1}
            for name, s in sorted(shapes.items())}
    tree["q_coeffs"] = rng.standard_normal(DEGREE + 1) * 0.05
    return jax.tree.map(lambda x: x.astype(np.float32).astype(np.float64),
                        {"params": tree})


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("loop_cases")
    rng = np.random.default_rng(12)
    for i in range(CASES):
        save_case(generate_sludge_case(rng, mesh_cells=1),
                  root / "sludge_patterns" / f"case_{i:04d}")
    ref = JaxSludgePatternDataSet(
        stage="train", batch_size=BATCH,
        specs=plan_builder_for("NeuralFSAI", None), root=root, seed=SEED)
    ours = PlannedDataSet(stage="train", batch_size=BATCH, root=root,
                          seed=SEED)
    n = len(ours)
    n_val = max(1, n * 5 // 100)
    views = {}
    for side, base, widen in (("jax", ref, _widen_jax),
                              ("torch", ours, _widen_torch)):
        views[side] = (_Widened(base, range(n - n_val), widen),
                       _Widened(base, range(n - n_val, n), widen))
    return {"root": root, "ref": ref, "ours": ours, "views": views}


def _providers(setup, range_h=RANGE_H):
    return (jax_nf.FSAIPlanProvider(setup["ref"], power=POWER, width=WIDTH,
                                    range_h=range_h),
            nf.FSAIPlanProvider(setup["ours"], power=POWER, width=WIDTH,
                                range_h=range_h))


def _torch_model(params):
    model = nf.NeuralFSAI(WIDTH, HIDDEN, DEGREE).double()
    model.load_state_dict(nf.params_from_jax(params))
    return model


def _jax_loss_fn(model, plans, operands, a_tril, rhs, loss):
    """The objective of ``trainer.fsai_train_step`` (its ``loss_fn``)."""
    def loss_fn(p):
        out = jax_nf.batched_apply_fsai(model, p, plans, operands)
        if loss == "pcg_loss":
            a_full = jax_metrics.symmetrize_tril(a_tril)
            m = jax_nf.batched_dense_m(plans, out, a_full)
            return jax_metrics.pcg_residual_loss(a_tril, m, rhs,
                                                 k_steps=PCG_STEPS)
        c_dense = jax_nf.batched_dense_factor(plans, out.c_vals)
        if loss == "kaporin_loss":
            return jax_metrics.kaporin_loss(a_tril, c_dense)
        return jax_metrics.inverse_loss(a_tril, c_dense)
    return loss_fn


@pytest.mark.parametrize("loss,range_h", [
    ("pcg_loss", RANGE_H), ("pcg_loss", GENERIC_H),
    ("inverse_loss", RANGE_H), ("kaporin_loss", RANGE_H),
])
def test_train_step_loss_and_gradients_match_jax(setup, loss, range_h):
    params = _random_params(1)
    p_ref, p_ours = _providers(setup, range_h)
    jb = setup["views"]["jax"][0][0]
    tb = setup["views"]["torch"][0][0]
    plans, ref_plans = p_ours(0, tb), p_ref(0, jb)
    a_tril = jb.systems.to_dense()
    operands = jax_trainer._fsai_operands(ref_plans, jb.features[:, :, 0],
                                          a_tril)
    jmodel = jax_nf.NeuralFSAI(width=WIDTH, hidden=HIDDEN,
                               poly_degree=DEGREE, gather="lookup")
    want, want_grads = jax.jit(jax.value_and_grad(_jax_loss_fn(
        jmodel, ref_plans, operands, a_tril, jb.right_hand_sides, loss)))(
        jax.tree.map(jnp.asarray, params))

    model = _torch_model(params)
    t_tril = tb.systems.to_dense()
    got = trainer.fsai_loss(
        model, plans, trainer._fsai_operands(plans, tb.features[:, :, 0],
                                             t_tril),
        t_tril, tb.right_hand_sides, loss, PCG_STEPS)
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-10)
    # q enters only pcg_loss (through M); elsewhere its gradient is zero
    grads = nf.params_to_jax({
        n: torch.zeros_like(p) if p.grad is None else p.grad
        for n, p in model.named_parameters()})
    flat_want = jax.tree_util.tree_leaves_with_path(want_grads)
    for (path, g_want), g in zip(flat_want, jax.tree.leaves(grads)):
        g_want = np.asarray(g_want)
        if loss == "pcg_loss" or "q_coeffs" not in str(path):
            assert np.abs(g_want).max() > 0, path
        np.testing.assert_allclose(g, g_want, rtol=1e-9,
                                   atol=1e-9 * np.abs(g_want).max(),
                                   err_msg=str(path))


def test_validation_matches_jax(setup):
    """``_fsai_validate_device``: loss to 1e-10 relative, per-case
    iterations equal (float64)."""
    params = _random_params(2)
    p_ref, p_ours = _providers(setup)
    jb = setup["views"]["jax"][1][0]
    tb = setup["views"]["torch"][1][0]
    jmodel = jax_nf.NeuralFSAI(width=WIDTH, hidden=HIDDEN,
                               poly_degree=DEGREE)
    want_loss, want_iters = jax_trainer._fsai_validate_device(
        jmodel, jax.tree.map(jnp.asarray, params), p_ref(0, jb),
        jb.features[:, :, 0], jb.systems.to_dense(), jb.right_hand_sides)
    loss, iters = trainer._fsai_validate_device(
        _torch_model(params), p_ours(0, tb), tb.features[:, :, 0],
        tb.systems.to_dense(), tb.right_hand_sides)
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-10)
    assert iters.tolist() == np.asarray(want_iters).tolist()
    assert min(iters.tolist()) > PCG_STEPS


@pytest.fixture(scope="module")
def two_epochs(setup, tmp_path_factory):
    """Both trainers for two epochs from the same params (``init_from``)."""
    out = tmp_path_factory.mktemp("two_epochs")
    init = out / "init.msgpack"
    init.write_bytes(flax.serialization.to_bytes(
        {"params": jax.tree.map(lambda x: x.astype(np.float32),
                                _random_params(3))}))
    kw = dict(learning_rate=LR, max_epochs=EPOCHS, loss="pcg_loss",
              pcg_steps=PCG_STEPS, select_by="iterations", init_from=init,
              seed=SEED)
    p_ref, p_ours = _providers(setup)
    jmodel = jax_nf.NeuralFSAI(width=WIDTH, hidden=HIDDEN,
                               poly_degree=DEGREE)
    jax_state = jax_trainer.train_neural_fsai(
        jmodel, *setup["views"]["jax"], p_ref,
        checkpoint_dir=out / "jax", metrics_dir=out / "jax_metrics", **kw)
    model = nf.NeuralFSAI(WIDTH, HIDDEN, DEGREE).double()
    state = trainer.train_neural_fsai(
        model, *setup["views"]["torch"], p_ours,
        checkpoint_dir=out / "torch", metrics_dir=out / "torch_metrics", **kw)
    return {"out": out, "jax_state": jax_state, "state": state,
            "jmodel": jmodel, "providers": (p_ref, p_ours)}


def _records(directory):
    return [json.loads(line) for line in
            (directory / "metrics.jsonl").read_text().splitlines()]


def test_two_epochs_match_jax(two_epochs):
    """The metrics.jsonl series: the same records in the same order, the
    losses to 1e-5 relative, the mean validation iterations equal; the
    summary and the report are written."""
    out = two_epochs["out"]
    want, got = _records(out / "jax_metrics"), _records(out / "torch_metrics")
    assert [(r["step"], r["name"]) for r in got] == [
        (r["step"], r["name"]) for r in want]
    assert len(got) == 4 * EPOCHS
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"step", "name", "value", "time"}
        if w["name"] == "val/metric/iterations":
            assert g["value"] == w["value"]
        elif w["name"] != "val/metric/durations":
            assert g["value"] == pytest.approx(w["value"], rel=1e-5), w
    summary = json.loads((out / "torch_metrics" / "metrics.json").read_text())
    assert set(summary) == set(json.loads(
        (out / "jax_metrics" / "metrics.json").read_text()))
    assert (out / "torch_metrics" / "report.html").exists()
    state = two_epochs["state"]
    assert state.step == int(two_epochs["jax_state"].step)
    assert [r["train_loss"] for r in state.epochs] == [
        r["value"] for r in got if r["name"] == "train/loss/inverse"]
    assert all(len(r["step_losses"]) == state.step // EPOCHS
               for r in state.epochs)


def test_jax_reads_the_ports_checkpoint(two_epochs):
    """JAX's ``load_checkpoint`` and ``resume_state`` on the port's
    ``latest.msgpack``: params, Adam moments and step equal the port's
    model and optimizer; the file is what ``flax.serialization.to_bytes``
    writes for that payload; ``best.msgpack`` holds the same params after
    an improving last epoch."""
    path = two_epochs["out"] / "torch" / "latest.msgpack"
    state = two_epochs["state"]
    payload = jax_trainer.load_checkpoint(path)
    assert flax.serialization.to_bytes(payload) == path.read_bytes()
    assert payload["step"] == state.step
    assert (payload["width"], payload["hidden"], payload["poly_degree"],
            payload["power"]) == (WIDTH, HIDDEN, DEGREE, POWER)
    mine = nf.params_to_jax(state.model.state_dict())
    for a, b in zip(jax.tree.leaves(payload["params"]),
                    jax.tree.leaves(mine)):
        np.testing.assert_array_equal(a, b)
    resumed = jax_trainer.resume_state(path, optax.adam(LR))
    adam_state = resumed.opt_state[0]
    assert int(adam_state.count) == state.step == int(resumed.step)
    names = {p: n for n, p in state.model.named_parameters()}
    for moment, key in ((adam_state.mu, "exp_avg"),
                        (adam_state.nu, "exp_avg_sq")):
        mine = nf.params_to_jax({n: state.optimizer.state[p][key]
                                 for p, n in names.items()})
        for a, b in zip(jax.tree.leaves(moment), jax.tree.leaves(mine)):
            np.testing.assert_array_equal(np.asarray(a), b)
    assert load_checkpoint(path)["step"] == state.step


def test_port_resumes_from_a_jax_checkpoint(setup, two_epochs):
    """The port's next step from JAX's ``latest.msgpack`` equals JAX's
    next step: the loss to 1e-10, params and Adam moments to 1e-6
    relative (params 1e-5 of the learning rate, moments 1e-6 of their
    largest entry absolute), since JAX rounds its Dense kernels'
    gradients and updates to float32."""
    path = two_epochs["out"] / "jax" / "latest.msgpack"
    p_ref, p_ours = two_epochs["providers"]
    tx = optax.adam(LR)
    jstate = jax_trainer.resume_state(path, tx)
    jb = setup["views"]["jax"][0][0]
    tb = setup["views"]["torch"][0][0]
    jstate, want = jax_trainer.fsai_train_step(
        two_epochs["jmodel"], tx, jstate, p_ref(0, jb), jb.features[:, :, 0],
        jb.systems.to_dense(), jb.right_hand_sides, "pcg_loss", PCG_STEPS)

    model = nf.NeuralFSAI(WIDTH, HIDDEN, DEGREE).double()
    optimizer = trainer.adam(model, LR)
    step = trainer.resume_state(path, model, optimizer)
    assert step == int(jstate.step) - 1
    got = trainer.fsai_train_step(
        model, optimizer, p_ours(0, tb), tb.features[:, :, 0],
        tb.systems.to_dense(), tb.right_hand_sides, "pcg_loss", PCG_STEPS)
    assert float(got) == pytest.approx(float(want), rel=1e-10)
    mine = nf.params_to_jax(model.state_dict())
    for a, b in zip(jax.tree.leaves(jstate.params), jax.tree.leaves(mine)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-6,
                                   atol=1e-5 * LR)
    names = {p: n for n, p in model.named_parameters()}
    mu = nf.params_to_jax({n: optimizer.state[p]["exp_avg"]
                           for p, n in names.items()})
    for a, b in zip(jax.tree.leaves(jstate.opt_state[0].mu),
                    jax.tree.leaves(mu)):
        a = np.asarray(a)
        np.testing.assert_allclose(b, a, rtol=1e-6,
                                   atol=1e-6 * np.abs(a).max())


def test_entry_point_trains_on_the_cpu_only_when_asked(setup, tmp_path,
                                                       capsys):
    """``python -m deeppreconditioning_tpu_torch.train``: without a card
    it raises unless ``--device cpu``; on the CPU it reads the case
    folders, prints one line per epoch and writes both checkpoints where
    it is told (JAX reads them)."""
    from deeppreconditioning_tpu_torch.train import __main__ as entry

    argv = ["--data-root", str(setup["root"]), "--width", str(WIDTH),
            "--power", str(POWER), "--hidden", str(HIDDEN),
            "--pcg-steps", str(PCG_STEPS), "--checkpoint-dir",
            str(tmp_path / "ck"), "--metrics-dir", str(tmp_path / "m")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry.run(entry.parse_args(argv))
    run = entry.run(entry.parse_args(argv + ["--device", "cpu"]))
    assert "epoch 0: train loss" in capsys.readouterr().out
    assert run.state.step == len(run.data_set) - 1  # one validation batch
    for name in ("latest", "best"):
        payload = jax_trainer.load_checkpoint(tmp_path / "ck"
                                              / f"{name}.msgpack")
        assert payload["step"] == run.state.step
        assert payload["width"] == WIDTH and payload["power"] == POWER
