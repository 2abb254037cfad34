"""The port's distributed solver (``deeppreconditioning_tpu_torch.parallel``)
against the JAX package's ``parallel`` on the CPU.

The ranks are processes over gloo (``tests/_torch_pcg_worker.py``),
spawned once for this file: a world of 1, of 2 and of 4 ranks, all
started together.  Each runs ``pcg_sharded`` in float64, in allgather
and halo modes, with no preconditioner, Jacobi, block-Jacobi IC(0),
the sharded FSAI apply and its polynomial wrap, on a sludge case and the
16^3 Poisson operator; the JAX ``pcg_sharded`` on the conftest's 8-device
virtual mesh at the same shard count (``scripts/
torch_port_parallel_reference.py``'s fixture) must give the same
iterations (the distributed maths is exact; block-Jacobi's count depends
on the shard count, so every count is held per shard count) and x within
1e-9 of max |x|.  At world size 1 both modes equal the port's
single-device ``preconditioned_conjugate_gradient`` with the same apply
(the halo exchange has no peer and sends nothing); so do the scaling
bench's solves at 16^3 (float32), whose counts are the JAX bench's at one
shard within 1.  In process: the host
partition, FSAI plan and block-Jacobi blocks against the reference's, the
exchange at world size 1, the backend choice and the env:// start-up."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from deeppreconditioning_tpu.parallel import block_jacobi as jax_bj
from deeppreconditioning_tpu.parallel import fsai as jax_fsai
from deeppreconditioning_tpu.parallel import partition as jax_partition
from deeppreconditioning_tpu.sparse.ell import ELLMatrix as JaxELL
from deeppreconditioning_tpu_torch.parallel import multihost
from deeppreconditioning_tpu_torch.parallel.block_jacobi import (
    build_block_jacobi_ic,
)
from deeppreconditioning_tpu_torch.parallel.fsai import build_sharded_fsai
from deeppreconditioning_tpu_torch.parallel.multihost import SolverWorld
from deeppreconditioning_tpu_torch.parallel.partition import shard_ell_rows
from deeppreconditioning_tpu_torch.parallel.pcg import exchange_slabs
from deeppreconditioning_tpu_torch.sparse.ell import ELLMatrix

TESTS = Path(__file__).resolve().parent
WORKER = TESTS / "_torch_pcg_worker.py"
FIXTURES = TESTS / "fixtures" / "torch_port"
REF = json.loads((FIXTURES / "parallel_iterations.json").read_text())
WORLDS = (1, 2, 4)
X_RTOL = 1e-9  # of max |x|
KEYS = [key for case in REF["gloo"].values() for key in case["runs"]]

sys.path.insert(0, str(TESTS))
import _torch_pcg_worker as worker  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """Every world's rank-0 results: {size: (runs, x, single, single_x,
    bench16)}."""
    procs = []
    for size in WORLDS:
        port = multihost.free_port()
        out = tmp_path_factory.mktemp(f"world{size}")
        for rank in range(size):
            env = dict(os.environ, MASTER_ADDR="localhost",
                       MASTER_PORT=str(port), WORLD_SIZE=str(size),
                       RANK=str(rank), OUT=str(out), OMP_NUM_THREADS="1")
            procs.append((size, out, subprocess.Popen(
                [sys.executable, str(WORKER)], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    try:
        errors = [(p.communicate(timeout=300), p.returncode)
                  for _, _, p in procs]
    finally:
        for _, _, p in procs:
            if p.poll() is None:
                p.kill()
    for (_, err), rc in errors:
        assert rc == 0, err[-3000:]
    results = {}
    for size, out, _ in procs:
        if size in results:
            continue
        single = single_x = bench = None
        if size == 1:
            single = json.loads((out / "single.json").read_text())
            single_x = dict(np.load(out / "single_x.npz"))
            bench = json.loads((out / "bench16.json").read_text())
        results[size] = (json.loads((out / "runs.json").read_text()),
                         dict(np.load(out / "x.npz")), single, single_x,
                         bench)
    return results


def test_fixture_describes_the_runs():
    assert REF["shards"] == list(WORLDS)
    assert tuple(REF["modes"]) == worker.MODES
    assert tuple(REF["preconds"]) == worker.PRECONDS
    assert (REF["sweeps"], REF["fsai_power"], tuple(REF["poly_q"])) == (
        worker.SWEEPS, worker.FSAI_POWER, worker.POLY_Q)
    assert len(KEYS) == 2 * len(WORLDS) * 2 * 5


@pytest.mark.parametrize("key", KEYS)
def test_sharded_pcg_matches_jax(gloo, key):
    case, size, mode, pre = key.split("/")
    runs, xs, *_ = gloo[int(size)]
    ref = REF["gloo"][case]["runs"][key]
    assert runs[key]["iterations"] == ref["iterations"]
    assert runs[key]["residual"] < 1e-8
    x_ref = np.load(FIXTURES / "parallel_x.npz")[f"{case}/{size}/{pre}"]
    assert np.abs(xs[key] - x_ref).max() <= X_RTOL * np.abs(x_ref).max()


@pytest.mark.parametrize("case", ["sludge", "poisson16"])
@pytest.mark.parametrize("pre", ["none", "jacobi", "block_jacobi_ic",
                                 "fsai"])
def test_world_one_halo_equals_single_device(gloo, case, pre):
    """At world size 1 the halo exchange has no peer: both modes run the
    single-device solve's iterations, and x within 1e-12 of max |x|."""
    runs, xs, single, single_x, _ = gloo[1]
    want = single_x[f"{case}/{pre}"]
    for mode in ("halo", "allgather"):
        key = f"{case}/1/{mode}/{pre}"
        assert runs[key]["iterations"] == single[f"{case}/{pre}"]
        assert np.abs(xs[key] - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("key", [f"{m}/{p}" for m in ("allgather", "halo")
                                 for p in ("none", "jacobi",
                                           "block_jacobi_ic", "fsai")])
def test_scaling_bench_world_one(gloo, key):
    """The bench's sharded solve at world size 1 equals its single-device
    solve, and is the JAX bench's count at one shard within 1 (float32);
    the byte model is the reference's."""
    got = gloo[1][4][key]
    assert got["iterations"] == got["single"]
    ref = REF["scaling16"]
    assert abs(got["iterations"] - ref["iterations"][key]) <= 1
    mode, pre = key.split("/")
    halo = ref["halo"]
    want = (2 * halo * 4 if mode == "halo" else ref["n"] * 4) + 12
    if pre == "fsai":
        want += 2 * halo * 4  # the factor's bandwidth is A's
    assert got["comm_bytes"] == want


def test_exchange_at_world_one_sends_nothing():
    """No peer, no operation: the exchange needs no process group and
    returns zero slabs (a send to oneself would be refused)."""
    world = SolverWorld(rank=0, size=1, device=torch.device("cpu"))
    x = torch.arange(8, dtype=torch.float64)
    left, right, works = exchange_slabs(world, x[:3], x[-3:], 3)
    assert works == [] and not left.any() and not right.any()
    assert world.left is None and world.right is None
    edge = SolverWorld(rank=3, size=4, device=torch.device("cpu"))
    assert (edge.left, edge.right) == (2, None)


def _jax_ell(a):
    return JaxELL.from_scipy(a, dtype=jnp.float64)


@pytest.mark.parametrize("shards", [1, 2, 3, 4])
def test_partition_and_fsai_plan_match_jax(shards):
    a, _ = worker.systems()["sludge"]
    ell = ELLMatrix.from_scipy(a, dtype=torch.float64)
    ours = shard_ell_rows(ell, shards)
    ref = jax_partition.shard_ell_rows(_jax_ell(a), shards)
    assert (ours.n, ours.n_shards, ours.halo, ours.n_total) == (
        ref.n, ref.n_shards, ref.halo, ref.n_total)
    np.testing.assert_array_equal(ours.cols, np.asarray(ref.cols))
    np.testing.assert_array_equal(ours.vals, np.asarray(ref.vals))
    columns = worker.fsai_columns(a, ell.n_pad)
    sf = build_sharded_fsai(*columns, shards, n_total=ours.n_total)
    sf_ref = jax_fsai.build_sharded_fsai(*columns, shards,
                                         n_total=ours.n_total)
    assert (sf.halo, sf.n_shards) == (sf_ref.halo, sf_ref.n_shards)
    for name in ("u_pos", "u_vals", "l_pos", "l_vals"):
        np.testing.assert_array_equal(getattr(sf, name),
                                      np.asarray(getattr(sf_ref, name)))
    # each rank's interior / boundary maps cover its real entries once
    for rank in range(shards):
        shard = ours.shard(rank, "cpu", torch.float64)
        real = shard.cols < ours.n_total
        inside = shard.loc < ours.rows_per_shard
        outside = shard.hidx < 2 * shard.halo_w
        assert torch.equal(inside | outside, real)
        assert not (inside & outside).any()


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_block_jacobi_blocks_match_jax(shards):
    """Each rank's Neumann IC(0) operator holds the reference's slice of
    the stacked per-shard factors (8 shards: the last ones lie past n)."""
    a, _ = worker.systems()["sludge"]
    n_total = shard_ell_rows(ELLMatrix.from_scipy(a), shards).n_total
    ref = jax_bj.build_block_jacobi_ic(a, shards, n_total, sweeps=8)
    r = n_total // shards
    cols, vals = np.asarray(ref.cols), np.asarray(ref.vals)
    inv = np.asarray(ref.inv_diag)
    for rank in range(shards):
        op = build_block_jacobi_ic(a, shards, n_total, rank, sweeps=8)
        sl = slice(rank * r, (rank + 1) * r)
        np.testing.assert_allclose(op.inv_diag, inv[sl], rtol=1e-13,
                                   atol=0)
        assert op.sweeps == ref.sweeps and op.cols.shape[0] == r

        def dense(c, v):
            out = np.zeros((r, r + 1))
            np.add.at(out, (np.arange(r)[:, None].repeat(c.shape[1], 1),
                            c), v)
            return out[:, :r]

        np.testing.assert_allclose(dense(op.cols, op.vals),
                                   dense(cols[sl], vals[sl]),
                                   rtol=1e-13, atol=1e-15)


def test_backend_follows_the_device():
    assert multihost.backend_for("cpu") == "gloo"
    assert multihost.backend_for(torch.device("cuda", 0)) == "nccl"
    assert multihost.backend_for("cuda:1") == "nccl"


def test_no_environment_no_process_group(monkeypatch):
    for key in multihost.ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    assert not multihost.initialize_if_needed("cpu")
    assert not torch.distributed.is_initialized()


def test_sharded_ell_covers_the_matrix():
    """Gathering every shard's rows gives A back (float32 too)."""
    a = sp.random(50, 50, density=0.1, random_state=np.random.default_rng(3),
                  format="csr") + sp.eye(50)
    ell = ELLMatrix.from_scipy(a, dtype=torch.float32)
    sharded = shard_ell_rows(ell, 3)
    rows = [sharded.shard(k, "cpu", torch.float32) for k in range(3)]
    x = torch.randn(sharded.n_total, generator=torch.Generator().manual_seed(0))
    x_ext = torch.cat([x, x.new_zeros(1)])
    y = torch.cat([(s.vals * x_ext[s.cols]).sum(1) for s in rows])
    want = torch.as_tensor(a.toarray(), dtype=torch.float32) @ x[:50]
    torch.testing.assert_close(y[:50], want, rtol=1e-5, atol=1e-5)
    assert rows[0].vals.dtype == torch.float32
