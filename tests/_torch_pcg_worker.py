"""One rank of the PyTorch port's distributed PCG on the CPU over gloo.

Spawned by ``tests/test_torch_parallel.py`` with the env:// variables
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) and
``OUT`` (a folder).  Runs ``pcg_sharded`` in float64 on the systems of
``scripts/torch_port_parallel_reference.py`` (a sludge case from seed 11
at ``mesh_cells`` 2 on the numpy assembly, the 16^3 Poisson operator),
in both modes and with every preconditioner; rank 0 writes the
iterations and residuals (``runs.json``) and the gathered x
(``x.npz``).  At world size 1 it also runs the port's single-device
``preconditioned_conjugate_gradient`` with the same applies
(``single.json``, ``single_x.npz``) and the scaling bench's solves at
16^3, float32, with every preconditioner in both modes, beside the
single-device solve of each (``bench16.json``).  Imports no JAX.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import scipy.sparse as sp
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from deeppreconditioning_tpu_torch.data.fvm import (  # noqa: E402
    generate_sludge_case,
    numpy_assembly,
)
from deeppreconditioning_tpu_torch.ops.fsai import (  # noqa: E402
    fsai_factor_scipy,
    tril_power_pattern,
)
from deeppreconditioning_tpu_torch import scaling_bench  # noqa: E402
from deeppreconditioning_tpu_torch.parallel import multihost  # noqa: E402
from deeppreconditioning_tpu_torch.parallel.block_jacobi import (  # noqa
    block_jacobi_apply,
    build_block_jacobi_ic,
)
from deeppreconditioning_tpu_torch.parallel.fsai import (  # noqa: E402
    build_sharded_fsai,
    fsai_apply,
    make_fsai_poly_sharded_apply,
    make_fsai_sharded_apply,
)
from deeppreconditioning_tpu_torch.parallel.partition import (  # noqa: E402
    pad_vector,
    shard_ell_rows,
)
from deeppreconditioning_tpu_torch.parallel.pcg import (  # noqa: E402
    diag_local,
    gather_vector,
    identity_local,
    pcg_sharded,
)
from deeppreconditioning_tpu_torch.solvers.cg import (  # noqa: E402
    ell_matvec,
    preconditioned_conjugate_gradient,
)
from deeppreconditioning_tpu_torch.sparse.dia import poisson_dia  # noqa
from deeppreconditioning_tpu_torch.sparse.ell import ELLMatrix  # noqa: E402

MODES = ("allgather", "halo")
PRECONDS = ("none", "jacobi", "block_jacobi_ic", "fsai", "fsai_poly")
SWEEPS = 8
FSAI_POWER = 2
POLY_Q = (0.9, 0.05)
DEV = torch.device("cpu")


def systems():
    with numpy_assembly():
        case = generate_sludge_case(np.random.default_rng(11), mesh_cells=2)
    lap = poisson_dia((16, 16, 16), dtype=torch.float64).to_scipy().tocsr()
    rhs = np.random.default_rng(0).standard_normal(lap.shape[0])
    return {"sludge": (case.matrix.tocsr(), case.rhs),
            "poisson16": (lap, rhs)}


def fsai_columns(a, n_pad):
    """The float64 host FSAI factor on tril(|A|^2), packed by column."""
    coo = sp.tril(a, format="coo")
    pr, pc = tril_power_pattern(coo.row.astype(np.int32),
                                coo.col.astype(np.int32), a.shape[0],
                                power=FSAI_POWER)
    c_sp = fsai_factor_scipy(a, pr, pc).tocsc()
    w = int(np.diff(c_sp.indptr).max())
    out_rows = np.full((n_pad, w), n_pad, np.int64)
    c_vals = np.zeros((n_pad, w))
    for j in range(c_sp.shape[1]):
        lo, hi = c_sp.indptr[j], c_sp.indptr[j + 1]
        out_rows[j, :hi - lo] = c_sp.indices[lo:hi]
        c_vals[j, :hi - lo] = c_sp.data[lo:hi]
    return out_rows, c_vals


def preconditioner(name, a, sharded, world, columns, a_shard):
    """(apply_m, m_data) of this rank; with ``world`` None the
    single-device apply of the same operator (1 shard)."""
    n = a.shape[0]
    rank = 0 if world is None else world.rank
    if name == "none":
        return identity_local, None
    if name == "jacobi":
        d = np.zeros(sharded.n_total)
        d[:n] = 1.0 / a.diagonal()
        r = sharded.rows_per_shard
        return diag_local, torch.as_tensor(d[rank * r:(rank + 1) * r])
    if name == "block_jacobi_ic":
        op = build_block_jacobi_ic(a, sharded.n_shards, sharded.n_total,
                                   rank, sweeps=SWEEPS)
        return block_jacobi_apply, op.to(DEV, torch.float64)
    sf = build_sharded_fsai(*columns, sharded.n_shards,
                            n_total=sharded.n_total)
    m_data = sf.shard(rank, DEV, torch.float64)
    if name == "fsai":
        if world is None:
            return fsai_apply, m_data
        return make_fsai_sharded_apply(world), m_data
    if world is None:
        return None, None  # no single-device run of the wrap
    m_data.update(q=torch.tensor(POLY_Q, dtype=torch.float64), a=a_shard)
    return make_fsai_poly_sharded_apply(world, len(POLY_Q) - 1), m_data


def bench16(world) -> dict:
    """The scaling bench at 16^3 on this world of one rank: iterations
    of every (mode, preconditioner), sharded and single-device."""
    a, b_host = scaling_bench.scaling_system(16)
    columns = scaling_bench.fsai_columns(a, DEV)
    ell = ELLMatrix.from_scipy(a, dtype=torch.float32)
    out = {}
    for mode in MODES:
        for pre in scaling_bench.PRECONDS:
            solve = scaling_bench.solver_setup(a, b_host, world, pre, mode,
                                               columns=columns)
            single = preconditioned_conjugate_gradient(
                ell_matvec, ell, solve.b, solve.single_apply, solve.m_data,
                max_iter=scaling_bench.MAX_ITER)
            out[f"{mode}/{pre}"] = {
                "iterations": int(solve.run().iterations),
                "single": int(single.iterations),
                "comm_bytes": solve.comm_bytes}
    return out


def main() -> None:
    torch.set_num_threads(1)
    out = Path(os.environ["OUT"])
    assert multihost.initialize_if_needed(DEV)
    world = multihost.solver_world(DEV)
    runs, xs, single, single_x = {}, {}, {}, {}
    for name, (a, rhs) in systems().items():
        n = a.shape[0]
        ell = ELLMatrix.from_scipy(a, dtype=torch.float64)
        sharded = shard_ell_rows(ell, world.size)
        a_shard = sharded.shard(world.rank, DEV, torch.float64)
        b = pad_vector(np.concatenate([rhs, np.zeros(ell.n_pad - n)]),
                       sharded.n_total)
        r = sharded.rows_per_shard
        b_local = torch.as_tensor(b[world.rank * r:(world.rank + 1) * r])
        columns = fsai_columns(a, ell.n_pad)
        for mode in MODES:
            for pre in PRECONDS:
                apply_m, m_data = preconditioner(pre, a, sharded, world,
                                                 columns, a_shard)
                res = pcg_sharded(world, a_shard, b_local, m_data, apply_m,
                                  mode=mode)
                x = gather_vector(res.x, world)[:n]
                key = f"{name}/{world.size}/{mode}/{pre}"
                runs[key] = {"iterations": int(res.iterations),
                             "residual": float(res.residual)}
                xs[key] = x.numpy()
        if world.size == 1:
            b_dev = torch.as_tensor(b)
            for pre in PRECONDS:
                apply_m, m_data = preconditioner(pre, a, sharded, None,
                                                 columns, a_shard)
                if apply_m is None:
                    continue
                res = preconditioned_conjugate_gradient(
                    ell_matvec, ell, b_dev[:ell.n_pad], apply_m,
                    m_data if pre != "jacobi" else m_data[:ell.n_pad])
                single[f"{name}/{pre}"] = int(res.iterations)
                single_x[f"{name}/{pre}"] = res.x[:n].numpy()
    if world.rank == 0:
        out.mkdir(parents=True, exist_ok=True)
        np.savez(out / "x.npz", **xs)
        (out / "runs.json").write_text(json.dumps(runs))
        if world.size == 1:
            np.savez(out / "single_x.npz", **single_x)
            (out / "single.json").write_text(json.dumps(single))
            (out / "bench16.json").write_text(json.dumps(bench16(world)))
    multihost.shutdown()


if __name__ == "__main__":
    main()
