"""The port's data-parallel trainer (``parallel/data_parallel``, the
``world`` of ``train`` / ``train_neural_fsai``, ``train --dp``, the
multichip dry run) against the JAX package's mesh trainer and against
its own single-device step, on the CPU.

The ranks are processes over gloo (``tests/_torch_dp_worker.py``),
spawned once for this file: a world of 2 and a world of 3 ranks, started
together (batch 8 on 3 ranks is the uneven split 3/3/2).

Against the JAX package, per family, at ``tests/test_dp_training.py``'s
sizes (RandomSPD dof 24, batch 8, one train and one validation batch,
three epochs; ``PreconditionerNet`` (1, 4, 4, 4, 1) with
``inverse_loss``, ``NeuralFSAI`` width 24, hidden 8 with ``pcg_loss``
over 4 steps): the reference's ``train`` / ``train_neural_fsai`` with
``mesh=Mesh(jax.devices()[:k], ("dp",))`` for k = 2 and 3 on the
conftest's virtual devices, run by ``scripts/torch_port_dp_reference.py``
(``dp_train.json``: its mesh compiles take about a minute), from the JAX
init both sides start from (``dp_<family>_init.msgpack``).  Both sides
take float64 batches; the reference's parameters stay float32 (Flax's
``param_dtype``: its weights round to float32 after every update), so the
float32 bars of the reference test hold: step and validation losses
within rtol 2e-4 / atol 1e-6, the final parameters within rtol 2e-4 and
2e-2 of the learning rate (the port's float64 weights against float32
ones after three Adam steps: the NeuralFSAI heads, within three learning
rates of zero, differ by up to 1.35e-2 of it), the NeuralFSAI mean
validation iterations equal and the conv family's within 1 (its
A = B B^T + 1e-3 I systems are so ill-conditioned that the reference's
own validation of its final parameters reads 0.875 above the port's on
the same parameters).  The plan kind is the reference's.

Against the port's single-device step (float64), for each of the six
losses (the conv family's five, and NeuralFSAI's ``kaporin_loss`` with
its ``pcg_loss`` and ``inverse_loss``) at 2 and 3 ranks: the step loss
within rtol 1e-10, the all-reduced gradients within 1e-10 of each
tensor's largest entry, the parameters after Adam within 1e-10 of each
tensor's largest entry plus 1e-3 of the learning rate (Adam divides by
|g| + 1e-8, so a gradient that is zero but for rounding, as pcg_loss's
q_0 is since PCG does not see the scale of M, moves by up to that), the
NeuralFSAI mean validation iterations equal and the conv family's within
0.25 (two iterations over the 8 cases: there a weight moved by 1e-13
moves a case by one iteration; set after condition_loss at 2 ranks read
60.875 against 60.75).  The conv family takes two steps, so the second
shows the generator state ``hutchinson_trace`` leaves.  An
empty share (batch 2 on 3 ranks) joins with zeros and the step is still
the batch's.  Every rank logs the global loss; rank 0 alone writes
checkpoints and metrics.  In process: ``case_span``, the rank shares of a
batch put back together, the plan kind of a share, ``--dp 1`` against
``--dp 0`` bit for bit, the ``--dp`` errors, and the dry run at 2 ranks.
"""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from deeppreconditioning_tpu_torch.data.datasets import RandomSPDDataSet
from deeppreconditioning_tpu_torch.data.fvm import (
    generate_sludge_case,
    numpy_assembly,
    save_case,
)
from deeppreconditioning_tpu_torch.models import neural_fsai as nf
from deeppreconditioning_tpu_torch.models import precond_net_specs
from deeppreconditioning_tpu_torch.ops.fsai import FSAIPlan
from deeppreconditioning_tpu_torch.parallel import multihost
from deeppreconditioning_tpu_torch.parallel.data_parallel import (
    case_span,
    loss_weight,
)
from deeppreconditioning_tpu_torch.train import __main__ as entry
from deeppreconditioning_tpu_torch.train import trainer
from deeppreconditioning_tpu_torch.train.checkpoint import load_checkpoint

TESTS = Path(__file__).resolve().parent
WORKER = TESTS / "_torch_dp_worker.py"
FIXTURES = TESTS / "fixtures" / "torch_port"
REF = json.loads((FIXTURES / "dp_train.json").read_text())
WORLDS = (2, 3)
LOSS_RTOL, LOSS_ATOL = 2e-4, 1e-6  # tests/test_dp_training.py's bars
PARAM_LR_ATOL = 2e-2  # of the learning rate, against the reference
CONV_ITERS = 1.0  # mean validation iterations, conv family
DP_RTOL = 1e-10  # against the port's single-device step
CONV_ITERS_DP = 0.25  # mean validation iterations: 2 over the 8 cases
ADAM_NOISE = 1e-3  # of the learning rate
RUNS = [f"{family}/{loss}" for family, losses in
        (("conv", trainer.CONV_LOSSES), ("fsai", trainer.FSAI_LOSSES))
        for loss in losses]

sys.path.insert(0, str(TESTS))
import _torch_dp_worker as worker  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _distinct_ports(n):
    """n free localhost ports, held open together so they differ."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for sock in socks:
            sock.bind(("localhost", 0))
        return [sock.getsockname()[1] for sock in socks]
    finally:
        for sock in socks:
            sock.close()


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """Every world's results: {size: (folder, runs, params, [rank
    records])}.  If a rank fails or the worlds outlast their time, every
    rank is stopped and every rank's stderr reported."""
    procs = []
    for size, port in zip(WORLDS, _distinct_ports(len(WORLDS))):
        out = tmp_path_factory.mktemp(f"dp{size}")
        for rank in range(size):
            env = dict(os.environ, MASTER_ADDR="localhost",
                       MASTER_PORT=str(port), WORLD_SIZE=str(size),
                       RANK=str(rank), OUT=str(out), OMP_NUM_THREADS="1")
            procs.append((size, out, subprocess.Popen(
                [sys.executable, str(WORKER)], env=env,
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                text=True)))
    errs, deadline = {}, time.monotonic() + 300
    try:
        for i, (_, _, p) in enumerate(procs):
            try:
                errs[i] = p.communicate(
                    timeout=max(deadline - time.monotonic(), 1))[1]
            except subprocess.TimeoutExpired:
                break
    finally:
        for _, _, p in procs:
            if p.poll() is None:
                p.kill()
    for i, (_, _, p) in enumerate(procs):
        if i not in errs:
            errs[i] = p.communicate()[1]
    if any(p.returncode for _, _, p in procs):
        pytest.fail("the gloo worlds failed:\n" + "\n".join(
            f"world {size}, process {i}: rc {p.returncode}\n"
            f"{errs[i][-2000:]}" for i, (size, _, p) in enumerate(procs)))
    results = {}
    for size, out, _ in procs:
        results[size] = (
            out, json.loads((out / "runs.json").read_text()),
            dict(np.load(out / "params.npz")),
            [json.loads((out / f"rank{r}.json").read_text())
             for r in range(size)])
    return results


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for key, value in tree.items():
            out.update(_flat(value, f"{path}/{key}"))
        return out
    return {path: np.asarray(tree)}


def test_fixture_describes_the_runs():
    assert REF["worlds"] == list(WORLDS)
    cfg = REF["config"]
    assert worker.CONFIG == cfg
    assert (cfg["dof"], cfg["batch_size"], cfg["sparsity"], cfg["length"],
            cfg["epochs"]) == (24, 8, 0.8, 20, 3)
    assert cfg["conv"]["channels"] == [1, 4, 4, 4, 1]
    assert (cfg["fsai"]["width"], cfg["fsai"]["hidden"],
            cfg["fsai"]["loss"], cfg["fsai"]["pcg_steps"]) == (
                24, 8, "pcg_loss", 4)
    ds = worker.data_set("conv")
    assert (ds.dof_pad, ds.nnz0_pad) == (REF["conv"]["n_pad"],
                                         REF["conv"]["nnz0_pad"])


@pytest.mark.parametrize("size", WORLDS)
@pytest.mark.parametrize("family", ["conv", "fsai"])
def test_dp_epochs_match_the_jax_mesh_trainer(gloo, family, size):
    """Three epochs at 2 and 3 ranks against the reference's mesh of 2
    and 3 devices: step losses, validation loss and iterations, final
    parameters (float32 bars: the reference's weights are float32)."""
    _, runs, params, ranks = gloo[size]
    got = runs[f"jax/{family}"]
    ref = REF[family]["runs"][str(size)]
    assert got["step"] == ref["step"] == REF["config"]["epochs"]
    np.testing.assert_allclose([s[0] for s in got["step_losses"]],
                               ref["train_loss"], rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    np.testing.assert_allclose(got["val_loss"], ref["val_loss"],
                               rtol=LOSS_RTOL, atol=LOSS_ATOL)
    if family == "fsai":
        assert got["val_iterations"] == ref["val_iterations"]
        assert {r["kinds"]["jax/fsai"] for r in ranks} == {
            REF["fsai"]["plan_kind"]}
    else:
        assert np.abs(np.subtract(got["val_iterations"],
                                  ref["val_iterations"])).max() <= CONV_ITERS
    lr = REF["config"][family]["learning_rate"]
    want = _flat(ref["params"], f"jax/{family}")
    assert want and all(key in params for key in want)
    for key, value in want.items():
        np.testing.assert_allclose(params[key], value, rtol=LOSS_RTOL,
                                   atol=PARAM_LR_ATOL * lr, err_msg=key)


def _hold_single(runs, params, name, lr, one_runs=None, one_params=None):
    """``name``'s data-parallel run against its single-device run (in
    ``one_runs`` / ``one_params``, by default the same world's)."""
    one_runs = runs if one_runs is None else one_runs
    one_params = params if one_params is None else one_params
    got, one = runs[name], one_runs[f"{name}/one"]
    assert got["step"] == one["step"] >= 1
    np.testing.assert_allclose(got["step_losses"], one["step_losses"],
                               rtol=DP_RTOL, atol=0)
    gap = np.abs(np.subtract(got["val_iterations"], one["val_iterations"]))
    assert gap.max() <= (0 if name.endswith("fsai") or "/fsai/" in name
                         else CONV_ITERS_DP)
    keys = [k for k in params if k.startswith(f"{name}/")
            and not k.startswith(f"{name}/one/")]
    assert keys
    for key in keys:
        want = one_params[key.replace(name, f"{name}/one", 1)]
        scale = np.abs(want).max()
        atol = DP_RTOL * scale
        if "/grad/" not in key:
            atol += ADAM_NOISE * lr
        np.testing.assert_allclose(params[key], want, rtol=0, atol=atol,
                                   err_msg=key)


@pytest.mark.parametrize("size", WORLDS)
@pytest.mark.parametrize("run", RUNS)
def test_dp_step_equals_the_single_device_step(gloo, run, size):
    """Each loss's step at 2 and 3 ranks is the single-device step on the
    whole batch: the mean losses weighted by n_local / n_global, the sum
    (frobenius_loss) not; hutchinson_trace's probes are the whole
    batch's rows."""
    _, runs, params, _ = gloo[size]
    _, one_runs, one_params, _ = gloo[3]  # the single-device runs
    family = run.split("/")[0]
    _hold_single(runs, params, f"losses/{run}",
                 REF["config"][family]["learning_rate"], one_runs,
                 one_params)


@pytest.mark.parametrize("family", ["conv", "fsai"])
def test_an_empty_share_joins_with_zeros(gloo, family):
    """Batch 2 on 3 ranks: rank 2 has no case, joins the all-reduce with
    zeros, and the step is the whole batch's."""
    assert case_span(2, 2, 3) == range(2, 2)
    _, runs, params, ranks = gloo[3]
    _hold_single(runs, params, f"empty/{family}",
                 REF["config"][family]["learning_rate"])
    assert len({json.dumps(r["step_losses"][f"empty/{family}"])
                for r in ranks}) == 1


@pytest.mark.parametrize("size", WORLDS)
def test_every_rank_logs_the_global_loss_and_rank0_alone_writes(gloo, size):
    out, runs, _, ranks = gloo[size]
    for name in runs:
        if name.endswith("/one"):
            continue
        losses = {json.dumps(r["step_losses"][name]) for r in ranks}
        assert len(losses) == 1, name  # the all-reduced loss, on each rank
        assert ranks[0]["wrote"][name] == [
            "ckpt/best.msgpack", "ckpt/latest.msgpack",
            "metrics/metrics.json", "metrics/metrics.jsonl",
            "metrics/report.html"]
        assert all(r["wrote"][name] == [] for r in ranks[1:]), name
    records = [json.loads(line) for line in
               (out / "jax" / "conv" / "rank0" / "metrics" / "metrics.jsonl")
               .read_text().splitlines()]
    logged = [r["value"] for r in records if r["name"] == "train/loss/inverse"]
    assert logged == [s[0] for s in runs["jax/conv"]["step_losses"]]
    payload = load_checkpoint(out / "jax" / "conv" / "rank0" / "ckpt"
                              / "latest.msgpack")
    assert payload["step"] == REF["config"]["epochs"]
    # one all-reduce a step, timed
    assert [len(ms) for ms in runs["jax/conv"]["allreduce_ms"]] == [1, 1, 1]


@pytest.mark.parametrize("size", WORLDS)
def test_auto_plan_kind_agrees_across_ranks(gloo, size):
    _, _, _, ranks = gloo[size]
    kinds = [r["kinds"] for r in ranks]
    assert all(k == kinds[0] for k in kinds)
    assert {v for k, v in kinds[0].items() if "fsai" in k} == {"range"}


def test_dryrun_at_two_ranks(gloo):
    """``python -m deeppreconditioning_tpu_torch.dryrun`` in a gloo world
    of 2: both train steps the single-device loss, the halo PCG below
    1e-3, the sharded poly-FSAI within 2 iterations of the dense M."""
    out = gloo[2][0]
    result = json.loads((out / "dryrun.json").read_text())
    assert result["world_size"] == 2
    for name in ("conv", "fsai"):
        assert np.isfinite(result[f"{name}_loss"])
        assert result[f"{name}_loss"] == pytest.approx(
            result[f"{name}_single"], rel=1e-5)
    assert result["pcg_residual"] < 1e-3
    assert abs(result["poly_iterations"]
               - result["poly_single_iterations"]) <= 2


@pytest.mark.parametrize("batch,size", [(8, 2), (8, 3), (4, 3), (2, 3),
                                        (1, 4)])
def test_case_span_is_array_split(batch, size):
    spans = [case_span(batch, r, size) for r in range(size)]
    want = np.array_split(np.arange(batch), size)
    assert [list(s) for s in spans] == [w.tolist() for w in want]
    assert loss_weight("frobenius_loss", 3, 8) == 1.0
    assert loss_weight("pcg_loss", 3, 8) == 3 / 8


def _cat_plans(parts):
    return [type(p[0])(*[torch.cat(f) for f in zip(*p)]) for p in
            zip(*parts)]


@pytest.mark.parametrize("size", [2, 3])
def test_rank_shares_put_back_together_give_the_batch(size):
    """Every rank's ``share`` of a batch, concatenated, is the batch:
    features, sites, dense systems, solutions, right-hand sides, scales,
    sizes, conv plans and FSAI plans; the COO's batch column counts from 0
    within a share."""
    ds = RandomSPDDataSet("train", dof=24, batch_size=8,
                          specs=precond_net_specs((1, 4, 4, 4, 1)),
                          sparsity=0.8, length=20, seed=0, shuffle=False)
    batch = ds[1]
    shares = [ds.share(1, case_span(8, r, size)) for r in range(size)]
    assert all(s.index == 1 and s.span is not None for s in shares)
    for name in ("features", "solutions", "right_hand_sides", "scales"):
        assert torch.equal(torch.cat([getattr(s, name) for s in shares]),
                           getattr(batch, name)), name
    for i in range(3):
        assert torch.equal(torch.cat([s.sites[i] for s in shares]),
                           batch.sites[i])
    assert torch.equal(torch.cat([s.systems.to_dense() for s in shares]),
                       batch.systems.to_dense())
    for s in shares:
        live = s.systems.indices[s.systems.valid, 0]
        assert live.min() == 0 and live.max() == s.features.shape[0] - 1
    assert sum((s.original_sizes for s in shares), ()) == \
        batch.original_sizes
    for got, want in zip(_cat_plans([s.plans for s in shares]),
                         batch.plans):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    provider = nf.FSAIPlanProvider(ds, power=2, width=24)
    whole = provider(1, batch)
    parts = [provider(1, s) for s in shares]
    for field in ("lo", "local", "pos", "diag_pad", "out_rows"):
        assert torch.equal(torch.cat([getattr(p, field) for p in parts]),
                           getattr(whole, field)), field
    assert ds.share(1, range(0, 8)) is batch
    assert ds.share(1, range(3, 3)) is None
    with pytest.raises(ValueError):
        ds.share(1, range(6, 9))


def test_a_share_needs_the_plan_kind_settled_on_the_whole_batch():
    """At range height 16 the batch's first case builds no range plan
    (so one device settles on "generic") while case 3, the first of rank
    1's share at 3 ranks, builds one: the share's own first case would
    settle "range".  So "auto" is settled on the whole batch first, as
    its first call would be, and a share with "auto" unsettled is
    refused."""
    ds = RandomSPDDataSet("train", dof=24, batch_size=8, sparsity=0.8,
                          length=20, seed=1, shuffle=False)
    cases = case_span(8, 1, 3)
    assert cases.start == 3
    share = ds.share(0, cases)
    alone = nf.FSAIPlanProvider(ds, power=2, width=24, range_h=16)
    alone._sample_plan(*[np.asarray(x[0]) for x in share.sites], 128,
                       share.features.shape[1])
    assert alone.kind == "range"  # what the share alone would settle
    single = nf.FSAIPlanProvider(ds, power=2, width=24, range_h=16)
    whole = single(0, ds[0])
    assert single.kind == "generic"
    provider = nf.FSAIPlanProvider(ds, power=2, width=24, range_h=16)
    with pytest.raises(ValueError, match="settled"):
        provider(0, share)
    assert provider.settle(ds[0]) == "generic"
    plan = provider(0, share)
    assert type(plan) is type(whole) is FSAIPlan
    assert torch.equal(plan.sub_idx, whole.sub_idx[cases.start:cases.stop])


# -- the entry point ----------------------------------------------------------


@pytest.fixture(scope="module")
def case_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_cases")
    rng = np.random.default_rng(12)
    with numpy_assembly():
        for i in range(12):
            save_case(generate_sludge_case(rng, mesh_cells=1),
                      root / "sludge_patterns" / f"case_{i:04d}")
    return root


def _entry_args(root, out, *extra):
    return entry.parse_args([
        "--device", "cpu", "--data-root", str(root), "--width", "16",
        "--power", "3", "--hidden", "16", "--pcg-steps", "4",
        "--max-epochs", "2", "--validate-init", "--checkpoint-dir",
        str(out / "ck"), "--metrics-dir", str(out / "m"), *extra])


def test_dp1_equals_dp0_bit_for_bit(case_root, tmp_path, monkeypatch):
    """``train --dp 1`` alone makes a gloo group of one rank: its epochs,
    checkpoints and parameters are ``--dp 0``'s bit for bit, and the
    group is gone after the run."""
    for key in multihost.ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    runs = {}
    for dp in (0, 1):
        out = tmp_path / f"dp{dp}"
        runs[dp] = entry.run(_entry_args(case_root, out, "--dp", str(dp)))
        assert not torch.distributed.is_initialized()
    zero, one = runs[0], runs[1]
    assert one.backend == "gloo" and one.world.size == 1
    assert zero.world is None and zero.backend is None
    keys = ("step_losses", "val_losses", "val_iterations", "train_loss")
    for a, b in zip(zero.state.epochs, one.state.epochs):
        assert {k: a.get(k) for k in keys} == {k: b.get(k) for k in keys}
    for a, b in zip(zero.state.model.parameters(),
                    one.state.model.parameters()):
        assert torch.equal(a, b)
    for name in ("latest", "best"):
        assert (tmp_path / "dp0" / "ck" / f"{name}.msgpack").read_bytes() \
            == (tmp_path / "dp1" / "ck" / f"{name}.msgpack").read_bytes()


def test_dp_needs_its_ranks(case_root, tmp_path, monkeypatch):
    """``--dp 2`` with no torchrun variables, or in a world of another
    size, is refused before any group starts."""
    for key in multihost.ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        entry.run(_entry_args(case_root, tmp_path, "--dp", "2"))
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(multihost.free_port()))
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="world of 3 ranks"):
        entry.run(_entry_args(case_root, tmp_path, "--dp", "2"))
    with pytest.raises(ValueError, match="--dp -1"):
        entry.run(_entry_args(case_root, tmp_path, "--dp", "-1"))
    assert not torch.distributed.is_initialized()


def test_rank_device_and_nccl_need_a_card(monkeypatch):
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert multihost.rank_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            multihost.rank_device("cuda")
    assert multihost.backend_for("cpu") == "gloo"
