"""The port's pipeline runner (``deeppreconditioning_tpu_torch.repro``):
content-addressed stage skipping, the five cases of
``tests/test_repro.py``, and its hashes and stages against
``scripts/repro.py``'s."""

import importlib.util
import sys
from pathlib import Path

import pytest

from deeppreconditioning_tpu.config import params_show
from deeppreconditioning_tpu_torch import repro
from deeppreconditioning_tpu_torch.config import params_flat

REPO = Path(__file__).resolve().parents[1]


def _reference():
    spec = importlib.util.spec_from_file_location(
        "reference_repro", REPO / "scripts" / "repro.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules.setdefault("reference_repro", module)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def tmp_repo(tmp_path, monkeypatch):
    """Stage paths live under REPO for the lock's relative keys."""
    monkeypatch.setattr(repro, "REPO", tmp_path)
    return tmp_path


def _stage(root, name="s"):
    dep = root / "dep"
    out = root / "out.txt"
    dep.mkdir(exist_ok=True)
    (dep / "a.bin").write_bytes(b"data-v1")
    out.write_text("result")
    return repro.Stage(name, "noop", ["alpha", "beta"], deps=[dep],
                       outs=[out])


def test_skip_only_when_everything_matches(tmp_repo):
    stage = _stage(tmp_repo)
    params = {"alpha": 1, "beta": "x", "gamma": "ignored"}
    lock = {stage.name: stage.record(params)}
    assert repro.should_skip(stage, params, lock)
    assert not repro.should_skip(stage, {**params, "alpha": 2}, lock)
    assert repro.should_skip(stage, {**params, "gamma": "other"}, lock)


def test_dep_content_change_invalidates(tmp_repo):
    stage = _stage(tmp_repo)
    params = {"alpha": 1, "beta": "x"}
    lock = {stage.name: stage.record(params)}
    (tmp_repo / "dep" / "a.bin").write_bytes(b"data-v2-regenerated")
    assert not repro.should_skip(stage, params, lock)


def test_missing_or_tampered_output_invalidates(tmp_repo):
    stage = _stage(tmp_repo)
    params = {"alpha": 1, "beta": "x"}
    lock = {stage.name: stage.record(params)}
    (tmp_repo / "out.txt").write_text("hand-edited")
    assert not repro.should_skip(stage, params, lock)
    (tmp_repo / "out.txt").unlink()
    assert not repro.should_skip(stage, params, lock)


def test_no_lock_entry_runs(tmp_repo):
    stage = _stage(tmp_repo)
    assert not repro.should_skip(stage, {"alpha": 1, "beta": "x"}, {})


def test_downstream_chain_invalidation(tmp_repo):
    """Regenerating the generate stage's output (the train stage's
    dependency) invalidates train though its own output exists."""
    data = tmp_repo / "data"
    data.mkdir()
    (data / "case.npz").write_bytes(b"cases-v1")
    ckpt = tmp_repo / "best.msgpack"
    ckpt.write_bytes(b"weights-v1")
    gen = repro.Stage("generate", "g", ["n"], outs=[data])
    train = repro.Stage("train", "t", ["lr"], deps=[data], outs=[ckpt])
    params = {"n": 5, "lr": 0.1}
    lock = {"generate": gen.record(params), "train": train.record(params)}
    assert repro.should_skip(train, params, lock)
    (data / "case.npz").write_bytes(b"cases-v2-more-samples")
    assert not repro.should_skip(gen, {**params, "n": 9}, lock)
    assert not repro.should_skip(train, params, lock)


def test_hashes_and_stages_match_reference(tmp_path, monkeypatch):
    """Folder and file hashes equal the reference's; the stages declare
    the reference's params keys and dependency chain; the port's lock is
    its own and the entry points are the port's."""
    ref = _reference()
    (tmp_path / "d" / "sub").mkdir(parents=True)
    (tmp_path / "d" / "sub" / "x.bin").write_bytes(b"abc")
    (tmp_path / "d" / "y.txt").write_text("y")
    for p in (tmp_path / "d", tmp_path / "d" / "y.txt",
              tmp_path / "missing"):
        assert repro.path_sig(p) == ref._path_sig(p)
    params = params_flat(REPO / "params.yaml")
    ours = repro.build_stages(params, "cpu")
    theirs = ref.build_stages(params_show(REPO / "params.yaml"))
    assert [s.name for s in ours] == [s.name for s in theirs]
    for a, b in zip(ours, theirs):
        assert a.params_keys == b.params_keys
        assert a.module.startswith("deeppreconditioning_tpu_torch.")
        assert len(a.deps) == len(b.deps)
    assert ours[1].deps == ours[0].outs
    assert ours[2].deps == ours[0].outs + ours[1].outs
    assert ours[2].args[-1] == str(ours[1].outs[0])
    assert repro.LOCK == Path("assets/results/torch/repro.lock")
    lock = tmp_path / "lock"
    repro.save_lock(lock, {"generate": {"params": {"n": 1}}})
    assert repro.load_lock(lock) == {"generate": {"params": {"n": 1}}}
    assert repro.load_lock(tmp_path / "none") == {}
