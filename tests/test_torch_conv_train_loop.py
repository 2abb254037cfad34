"""The port's conv trainer against the JAX package's, on small
sludge-pattern batches (one cell per pattern, batch 2, n_pad 256),
``PreconditionerNet`` at channels (1, 8, 16, 8, 1) and a reduced
``PreconditionerSparseUNet`` (1, 8, 8, 8, 8, 8, 1; not 4 wide: XLA's CPU
float64 program of the reference U-Net at width 4 moves its output by up
to 2e-2 from the op-by-op float64 evaluation, which numpy and the port
match to 1e-16):

- for both models, each of the five losses, its parameter gradients and
  the parameters after one ``train_step`` from the same float64
  parameters, against the reference's ``_loss_from_batch`` through the
  model's compiled pullback and optax's Adam (``hutchinson_trace`` with
  the reference's probes): loss to 1e-10 relative, gradients to 1e-9
  relative (of the largest entry), parameters to 1e-9 of the learning
  rate; the reference's jitted ``train_step`` itself runs in the epochs
  and resume tests;
- ``_validate_device`` / ``validate``: loss to 1e-10 relative, iterations
  equal per case;
- three epochs of ``train`` (PreconditionerNet (1, 8, 1)) at the
  warmup-cosine rate, from the same
  float32 init checkpoint: the ``metrics.jsonl`` series (losses to 1e-5
  relative, since the reference's float32 parameters round after every
  update; iterations equal), ``best`` and ``latest`` from the same epochs
  with the same params (1e-6 relative);
- the cosine rates against optax's schedule to 1e-12 relative;
- checkpoints both ways: the reference's ``load_checkpoint`` /
  ``resume_state`` on the port's ``latest.msgpack`` and the port's on
  the reference's, each side's next step from it equal (loss 1e-10,
  parameters 1e-6 relative and 1e-5 of the learning rate);
- the entry point: ``--device cpu`` needed without a card, and its
  ``best.msgpack`` served by ``conv_model_from_checkpoint``;
- the shared epoch loop times a step without its batch's preparation
  (NeuralFSAI's plan build).
"""

import json

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeppreconditioning_tpu.data.datasets import (
    SludgePatternDataSet as JaxSludgePatternDataSet,
)
from deeppreconditioning_tpu.models import (
    PreconditionerNet as JaxNet,
    PreconditionerSparseUNet as JaxUNet,
    plan_builder_for as jax_builder,
)
from deeppreconditioning_tpu.models.precond_net import batched_apply
from deeppreconditioning_tpu.train import trainer as jax_trainer
from deeppreconditioning_tpu_torch.data.datasets import PlannedDataSet
from deeppreconditioning_tpu_torch.data.fvm import (
    generate_sludge_case,
    save_case,
)
from deeppreconditioning_tpu_torch.models import (
    PreconditionerNet,
    PreconditionerSparseUNet,
    conv_model_from_checkpoint,
    conv_params_to_jax,
    init_params,
    plan_builder_for,
)
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
LR, EPOCHS, WARMUP = 1e-3, 3, 1
# The epochs run a two-layer PreconditionerNet: the loop does not depend
# on depth, and the reference's eager Flax init and its compiles grow
# with it (the conv layers are held by the per-loss tests).
EPOCH_CHANNELS = (1, 8, 1)
MODELS = {
    "PreconditionerNet": ((1, 8, 16, 8, 1), JaxNet, PreconditionerNet),
    "PreconditionerSparseUNet": ((1, 8, 8, 8, 8, 8, 1), JaxUNet,
                                 PreconditionerSparseUNet),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small CPU tensors."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Widened:
    """Batches of a split view with every float leaf in float64, built
    once per batch."""

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


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("conv_loop_cases")
    rng = np.random.default_rng(12)
    for i in range(CASES):
        save_case(generate_sludge_case(rng, mesh_cells=1),
                  root / "sludge_patterns" / f"case_{i:04d}")
    return root


@pytest.fixture(scope="module")
def views(root):
    """Per model, and for the epochs ("epochs"): (JAX train, JAX val,
    port train, port val) views."""
    out = {}
    runs = [(name, name, channels) for name, (channels, _, _)
            in MODELS.items()]
    for key, name, channels in runs + [
            ("epochs", "PreconditionerNet", EPOCH_CHANNELS)]:
        ref = JaxSludgePatternDataSet(
            stage="train", batch_size=BATCH, root=root, seed=SEED,
            specs=jax_builder(name, channels))
        ours = PlannedDataSet(stage="train", batch_size=BATCH, root=root,
                              seed=SEED, specs=plan_builder_for(name,
                                                                channels))
        n = len(ours)
        n_val = max(1, n * 5 // 100)
        parts = (range(n - n_val), range(n - n_val, n))
        out[key] = tuple(_Widened(ref, p, _widen_jax) for p in parts) + (
            tuple(_Widened(ours, p, _widen_torch) for p in parts))
    return out


def _models(name, seed=1, out_scale=1.0, channels=None):
    """The reference's module and a float64 port model with the same
    random float64 parameters (the port's ``init_params``, the last
    layer's weight and bias times ``out_scale``), and their Flax tree."""
    default, jax_cls, cls = MODELS[name]
    channels = channels or default
    model = cls(channels=channels).double()
    init_params(model, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for p in list(model.parameters())[-2:]:
            p.mul_(out_scale)
    # copies: a CPU jax array may share the numpy buffer, which the
    # port's in-place updates would change under it
    tree = jax.tree.map(lambda x: jnp.array(x, copy=True),
                        conv_params_to_jax(model.state_dict()))
    return jax_cls(channels=channels), model, tree


def _grads(model):
    return conv_params_to_jax({n: p.grad for n, p in
                               model.named_parameters()})


@jax.jit
def _adam_step(params, grads):
    """optax ``adam(LR)``'s first update from a fresh state."""
    tx = optax.adam(LR)
    updates, _ = tx.update(grads, tx.init(params), params)
    return optax.apply_updates(params, updates)


@pytest.fixture(scope="module", params=sorted(MODELS))
def pullback(request, views):
    """A model's name, the reference's float64 params, its forward values
    on the first training batch and its compiled pullback (values
    cotangent -> parameter gradients): one compile per model serves all
    five losses."""
    name = request.param
    jb = views[name][0][0]
    jmodel, _, params = _models(name)

    def forward(p):
        return batched_apply(jmodel, p, jb.features, jb.plans)

    @jax.jit
    def values_and_grads(p, cotangent):
        values, pull = jax.vjp(forward, p)
        return values, pull(cotangent)[0]

    zeros = jnp.zeros(jb.plans[-1].rows.shape, jnp.float64)
    values, _ = values_and_grads(params, zeros)
    return name, params, values, lambda ct: values_and_grads(params, ct)[1]


@pytest.mark.parametrize("loss", trainer.CONV_LOSSES)
def test_train_step_matches_jax(views, pullback, loss, monkeypatch):
    """One step of each loss: the reference's ``_loss_from_batch`` on its
    forward's values (``batched_apply`` replaced by those values, so its
    dispatch and losses run as written), its gradients through the
    model's pullback, then optax's Adam update, against the port's
    ``train_step``."""
    name, params, values, grads_of = pullback
    jb, tb = views[name][0][0], views[name][2][0]
    monkeypatch.setattr(jax_trainer, "batched_apply",
                        lambda model, v, features, plans: v)
    want, cotangent = jax.jit(jax.value_and_grad(
        lambda v: jax_trainer._loss_from_batch(None, v, jb, loss, 0)))(values)
    grads = grads_of(cotangent)
    new_params = _adam_step(params, grads)

    _, model, _ = _models(name)
    optimizer = trainer.adam(model, LR)
    probes = None
    if loss == "hutchinson_trace":  # the reference's step-0 draws
        key = jax.random.fold_in(jax.random.PRNGKey(0), jnp.int32(0))
        probes = torch.tensor(np.asarray(jax.random.normal(
            key, tb.solutions.shape, jnp.float64)))
    got = trainer.train_step(model, optimizer, tb, loss, probes=probes)
    assert float(got) == pytest.approx(float(want), rel=1e-10)
    for g, w in zip(jax.tree.leaves(_grads(model)), jax.tree.leaves(grads)):
        w = np.asarray(w)
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(g, w, rtol=1e-9,
                                   atol=1e-9 * np.abs(w).max())
    mine = conv_params_to_jax(model.state_dict())
    for a, b in zip(jax.tree.leaves(new_params), jax.tree.leaves(mine)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=1e-9 * LR)


def test_validation_matches_jax(views):
    """PreconditionerNet (validation is the same code for either model).
    With the output layer scaled by 0.1, L is near a multiple of the
    identity and PCG takes tens of iterations, where the float64 counts
    of the two packages are comparable one for one (from a raw random
    init they run to hundreds, which rounding moves)."""
    name = "PreconditionerNet"
    jmodel, model, params = _models(name, seed=2, out_scale=0.1)
    jval, tval = views[name][1], views[name][3]
    want_loss, want_iters = jax_trainer._validate_device(jmodel, params,
                                                         jval[0])
    loss, iters = trainer._validate_device(model, tval[0])
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-10)
    assert iters.tolist() == np.asarray(want_iters).tolist()
    assert min(iters.tolist()) > 5
    want = jax_trainer.validate(jmodel, params, jval)
    got = trainer.validate(model, tval)
    assert got[0] == pytest.approx(want[0], rel=1e-10)
    assert got[1] == want[1]


def _optax_schedule(steps):
    return optax.warmup_cosine_decay_schedule(
        init_value=LR / 10, peak_value=LR, warmup_steps=WARMUP * steps,
        decay_steps=EPOCHS * steps, end_value=LR / 100)


@pytest.mark.parametrize("warmup,decay", [(3, 9), (1, 40), (0, 5)])
def test_cosine_rates_match_optax(warmup, decay):
    ours = trainer.warmup_cosine_decay(LR / 10, LR, warmup, decay, LR / 100)
    want = optax.warmup_cosine_decay_schedule(LR / 10, LR, warmup, decay,
                                              LR / 100)
    for count in range(decay + 3):
        assert ours(count) == pytest.approx(float(want(count)), rel=1e-12)
    with pytest.raises(ValueError, match="decay_steps"):
        trainer.warmup_cosine_decay(LR / 10, LR, 5, 5, LR / 100)


@pytest.fixture(scope="module")
def epochs(views, tmp_path_factory):
    """Both trainers for three epochs of PreconditionerNet
    (``EPOCH_CHANNELS``) at the cosine rate from the same float32 params
    (``init_from``; the output layer scaled by 0.1, so that validation
    takes tens of PCG iterations, as in ``test_validation_matches_jax``)."""
    name = "PreconditionerNet"
    out = tmp_path_factory.mktemp("conv_epochs")
    init = out / "init.msgpack"
    jmodel, _, params = _models(name, seed=3, out_scale=0.1,
                                channels=EPOCH_CHANNELS)
    init.write_bytes(flax.serialization.to_bytes(
        {"params": jax.tree.map(lambda x: np.asarray(x, np.float32),
                                params)}))
    kw = dict(learning_rate=LR, max_epochs=EPOCHS, schedule="cosine",
              warmup_epochs=WARMUP, select_by="iterations", init_from=init,
              seed=SEED)
    jtrain, jval, ttrain, tval = views["epochs"]
    jax_state = jax_trainer.train(
        jmodel, jtrain, jval, checkpoint_dir=out / "jax",
        metrics_dir=out / "jax_metrics", **kw)
    model = PreconditionerNet(channels=EPOCH_CHANNELS).double()
    state = trainer.train(
        model, ttrain, tval, checkpoint_dir=out / "torch",
        metrics_dir=out / "torch_metrics", **kw)
    return {"out": out, "jax_state": jax_state, "state": state,
            "jmodel": jmodel, "views": views["epochs"],
            "schedule": _optax_schedule(len(ttrain))}


def _records(directory):
    return [json.loads(line) for line in
            (directory / "metrics.jsonl").read_text().splitlines()]


def test_epochs_match_jax(epochs):
    """The metrics.jsonl series record for record, the step counts, and
    ``best`` / ``latest`` written after the same epochs with the same
    params."""
    out = epochs["out"]
    want, got = _records(out / "jax_metrics"), _records(out / "torch_metrics")
    assert [(r["step"], r["name"]) for r in got] == [
        (r["step"], r["name"]) for r in want]
    assert len(got) == 4 * EPOCHS
    for g, w in zip(got, want):
        if w["name"] == "val/metric/iterations":
            assert g["value"] == w["value"]
        elif w["name"] != "val/metric/durations":
            assert g["value"] == pytest.approx(w["value"], rel=1e-5), w
    state = epochs["state"]
    assert state.step == int(epochs["jax_state"].step) == EPOCHS * len(
        epochs["views"][2])
    assert [r["train_loss"] for r in state.epochs] == [
        r["value"] for r in got if r["name"] == "train/loss/inverse"]
    for kind in ("best", "latest"):
        mine = load_checkpoint(out / "torch" / f"{kind}.msgpack")
        ref = jax_trainer.load_checkpoint(out / "jax" / f"{kind}.msgpack")
        assert mine["step"] == ref["step"]
        assert mine["channels"] == ref["channels"]
        for a, b in zip(jax.tree.leaves(ref["params"]),
                        jax.tree.leaves(mine["params"])):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-5 * LR)


def _next_steps(epochs, path):
    """The reference's and the port's next step from checkpoint ``path``
    on the first training batch: (JAX state, JAX loss, port model, port
    loss)."""
    jtrain, _, ttrain, _ = epochs["views"]
    tx = optax.adam(epochs["schedule"])
    jstate = jax_trainer.resume_state(path, tx)
    jstate, want = jax_trainer.train_step(epochs["jmodel"], tx, jstate,
                                          jtrain[0])
    model = PreconditionerNet(channels=EPOCH_CHANNELS).double()
    optimizer = trainer.adam(model, LR)
    step = trainer.resume_state(path, model, optimizer)
    assert step == int(jstate.step) - 1
    for group in optimizer.param_groups:
        group["lr"] = trainer.warmup_cosine_decay(
            LR / 10, LR, WARMUP * len(ttrain), EPOCHS * len(ttrain),
            LR / 100)(step)
    got = trainer.train_step(model, optimizer, ttrain[0])
    return jstate, want, model, got


def _assert_next_steps_equal(epochs, path):
    jstate, want, model, got = _next_steps(epochs, path)
    assert float(got) == pytest.approx(float(want), rel=1e-10)
    mine = conv_params_to_jax(model.state_dict())
    for a, b in zip(jax.tree.leaves(jstate.params), jax.tree.leaves(mine)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-6,
                                   atol=1e-5 * LR)


def test_jax_reads_the_ports_checkpoint(epochs):
    """The reference's ``load_checkpoint`` / ``resume_state`` on the
    port's ``latest.msgpack``: the file is what Flax writes for that
    payload (params, the scheduled Adam state, step, channels); params,
    moments and counts equal the port's; the next steps agree."""
    path = epochs["out"] / "torch" / "latest.msgpack"
    state = epochs["state"]
    payload = jax_trainer.load_checkpoint(path)
    assert flax.serialization.to_bytes(payload) == path.read_bytes()
    assert payload["step"] == state.step
    assert payload["channels"] == {str(i): c for i, c in
                                   enumerate(EPOCH_CHANNELS)}
    mine = conv_params_to_jax(state.model.state_dict())
    for a, b in zip(jax.tree.leaves(payload["params"]),
                    jax.tree.leaves(mine)):
        np.testing.assert_array_equal(a, b)
    resumed = jax_trainer.resume_state(path, optax.adam(epochs["schedule"]))
    adam_state, schedule_state = resumed.opt_state
    assert int(adam_state.count) == int(schedule_state.count) == state.step
    names = {p: n for n, p in state.model.named_parameters()}
    for moment, key in ((adam_state.mu, "exp_avg"),
                        (adam_state.nu, "exp_avg_sq")):
        mine = conv_params_to_jax({n: state.optimizer.state[p][key]
                                   for p, n in names.items()})
        for a, b in zip(jax.tree.leaves(moment), jax.tree.leaves(mine)):
            np.testing.assert_array_equal(np.asarray(a), b)
    _assert_next_steps_equal(epochs, path)


def test_port_resumes_from_a_jax_checkpoint(epochs):
    _assert_next_steps_equal(epochs, epochs["out"] / "jax" / "latest.msgpack")


def test_entry_point_trains_on_the_cpu_only_when_asked(root, tmp_path,
                                                       capsys, monkeypatch):
    """``python -m deeppreconditioning_tpu_torch.train --model
    PreconditionerSparseUNet``: without a card it raises unless
    ``--device cpu``; on the CPU it trains params.yaml's channels on the
    case folders, writes where it is told (never to the committed
    checkpoints by default), and the serving path loads its
    ``best.msgpack`` as the trained model."""
    from deeppreconditioning_tpu_torch.train import __main__ as entry

    name = "PreconditionerSparseUNet"
    argv = ["--model", name, "--data-root", str(root), "--checkpoint-dir",
            str(tmp_path / "ck"), "--metrics-dir", str(tmp_path / "m")]
    assert entry.parse_args(argv[:2]).checkpoint_dir == (
        entry.RESULTS / name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.run(entry.parse_args(argv))
    run = entry.run(entry.parse_args(argv + ["--device", "cpu"]))
    printed = capsys.readouterr().out
    assert "epoch 0: train loss" in printed and "level buckets" in printed
    assert run.state.step == len(run.data_set) - 1  # one validation batch
    assert run.plan_provider is None
    payload = load_checkpoint(tmp_path / "ck" / "best.msgpack")
    assert payload["step"] == run.state.step
    served = conv_model_from_checkpoint(name, payload)
    batch = run.data_set[0]
    with torch.no_grad():
        torch.testing.assert_close(
            served(batch.features, batch.plans),
            run.state.model(batch.features, batch.plans), rtol=0, atol=0)
    records = _records(tmp_path / "m")
    assert [r["name"] for r in records] == [
        "train/loss/inverse", "val/loss/inverse", "val/metric/durations",
        "val/metric/iterations"]


def test_fit_times_the_step_without_its_preparation(tmp_path):
    """``_fit`` runs ``prepare_fn`` (NeuralFSAI's first plan build of a
    batch) before a step's timer starts: a 0.2 s preparation is outside
    every recorded step time, and the step gets what it made."""
    import time

    model = torch.nn.Linear(1, 1)
    optimizer = trainer.adam(model, LR)
    seen = []

    def prepare(i, batch):
        time.sleep(0.2)
        return batch, i

    def step(inputs, step):
        seen.append(inputs)
        return 0.0

    state = trainer._fit(
        model, optimizer, ["a", "b"], [], step,
        lambda val: ([1.0], [3], 0.0), lambda step: {"step": step},
        patience=1, max_epochs=1, checkpoint_dir=tmp_path / "ck",
        metrics_dir=tmp_path / "m", select_by="loss", validate_init=False,
        on_epoch=None, prepare_fn=prepare)
    assert seen == [("a", 0), ("b", 1)]
    assert max(state.epochs[0]["step_seconds"]) < 0.1
    assert state.epochs[0]["prepare_seconds"] >= 0.4
