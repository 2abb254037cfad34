"""Iteration counts and solutions of the JAX reference's distributed PCG
(``deeppreconditioning_tpu/parallel``) for the PyTorch port.

Runs on the CPU over the 8-device virtual mesh the tests use
(``--xla_force_host_platform_device_count=8``), in two parts:

* ``gloo``, float64: ``pcg_sharded`` at 1, 2 and 4 shards, in
  ``allgather`` and ``halo`` modes, with no preconditioner, Jacobi,
  block-Jacobi IC(0) (8 Neumann sweeps), the exact sharded FSAI apply
  (the float64 host factor on tril(|A|^2)) and its polynomial wrap
  (degree 1, q = (0.9, 0.05)), on two systems: a sludge-pattern case
  (seed 11, ``mesh_cells`` 2, numpy assembly) and the 16^3 Poisson
  operator with a standard normal right-hand side (seed 0).  Keeps the
  iterations and squared relative residual of every run, and x of every
  allgather run in ``parallel_x.npz`` (key ``case/shards/precond``; the
  halo runs' x agree with it to ~1e-11 of max |x|).
* ``scaling``, float32: ``scripts/scaling_bench.py``'s 64^3 system and
  preconditioners (none, jacobi, block-Jacobi IC(0) at 8 sweeps, fsai on
  tril(A) through ``fsai_values_lookup``) at one shard, both modes,
  ``max_iter`` 256: the iterations; ``scaling16`` the same at 16^3.

Writes ``tests/fixtures/torch_port/parallel_iterations.json`` and
``parallel_x.npz`` (about 3 minutes).

    JAX_PLATFORMS=cpu python scripts/torch_port_parallel_reference.py
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import numpy as np  # noqa: E402
import scipy.sparse as sp  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from deeppreconditioning_tpu import native  # noqa: E402
from deeppreconditioning_tpu.data.fvm import (  # noqa: E402
    generate_sludge_case,
)
from deeppreconditioning_tpu.ops.fsai import (  # noqa: E402
    build_fsai_plan,
    fsai_factor_scipy,
    fsai_values_lookup,
    tril_power_pattern,
)
from deeppreconditioning_tpu.parallel.block_jacobi import (  # noqa: E402
    block_jacobi_apply,
    build_block_jacobi_ic,
)
from deeppreconditioning_tpu.parallel.fsai import (  # noqa: E402
    build_sharded_fsai,
    make_fsai_poly_sharded_apply,
    make_fsai_sharded_apply,
)
from deeppreconditioning_tpu.parallel.partition import (  # noqa: E402
    pad_vector,
    shard_ell_rows,
)
from deeppreconditioning_tpu.parallel.pcg import (  # noqa: E402
    diag_local,
    identity_local,
    make_mesh,
    pcg_sharded,
)
from deeppreconditioning_tpu.sparse.dia import poisson_dia  # noqa: E402
from deeppreconditioning_tpu.sparse.ell import ELLMatrix  # noqa: E402

FIXTURES = REPO / "tests" / "fixtures" / "torch_port"
SHARDS = (1, 2, 4)
MODES = ("allgather", "halo")
PRECONDS = ("none", "jacobi", "block_jacobi_ic", "fsai", "fsai_poly")
SWEEPS = 8
FSAI_POWER = 2
POLY_Q = (0.9, 0.05)
SCALING_GRIDS = (64, 16)  # the bench's default; the CPU test's
SCALING_PRECONDS = ("none", "jacobi", "block_jacobi_ic", "fsai")
SCALING_MAX_ITER = 256


def systems():
    """(name -> (scipy CSR, rhs)) of the gloo part."""
    saved = native.available
    native.available = lambda: False  # the numpy assembly the port pins
    try:
        case = generate_sludge_case(np.random.default_rng(11), mesh_cells=2)
    finally:
        native.available = saved
    lap = poisson_dia((16, 16, 16), dtype=jnp.float64).to_scipy().tocsr()
    rhs = np.random.default_rng(0).standard_normal(lap.shape[0])
    return {"sludge": (case.matrix.tocsr(), case.rhs),
            "poisson16": (lap, rhs)}


def pack_columns(c_sp, n_pad):
    """scipy factor -> (n_pad, w) out_rows / c_vals, by column."""
    c_sp = c_sp.tocsc()
    w = int(np.diff(c_sp.indptr).max())
    out_rows = np.full((n_pad, w), n_pad, np.int32)
    c_vals = np.zeros((n_pad, w))
    for j in range(c_sp.shape[1]):
        lo, hi = c_sp.indptr[j], c_sp.indptr[j + 1]
        out_rows[j, :hi - lo] = c_sp.indices[lo:hi]
        c_vals[j, :hi - lo] = c_sp.data[lo:hi]
    return out_rows, c_vals


def fsai_columns(a):
    n = a.shape[0]
    coo = sp.tril(a, format="coo")
    pr, pc = tril_power_pattern(coo.row.astype(np.int32),
                                coo.col.astype(np.int32), n,
                                power=FSAI_POWER)
    return fsai_factor_scipy(a, pr, pc)


def preconditioner(name, a, sharded, s, c_sp, ell):
    n = a.shape[0]
    if name == "none":
        return identity_local, None
    if name == "jacobi":
        d = np.zeros(sharded.n_total)
        d[:n] = 1.0 / a.diagonal()
        return diag_local, jnp.asarray(d)
    if name == "block_jacobi_ic":
        return block_jacobi_apply, build_block_jacobi_ic(
            a, s, sharded.n_total, sweeps=SWEEPS)
    out_rows, c_vals = pack_columns(c_sp, ell.n_pad)
    sf = build_sharded_fsai(out_rows, c_vals, s, n_total=sharded.n_total)
    m_data = {"u_pos": sf.u_pos, "u_vals": sf.u_vals,
              "l_pos": sf.l_pos, "l_vals": sf.l_vals}
    if name == "fsai":
        return make_fsai_sharded_apply(sf.halo), m_data
    m_data.update(q=jnp.tile(jnp.asarray(POLY_Q), s),
                  a_cols=sharded.cols, a_vals=sharded.vals)
    return make_fsai_poly_sharded_apply(
        sf.halo, degree=len(POLY_Q) - 1, a_halo=max(sharded.halo, 1),
        n_total=sharded.n_total), m_data


def gloo_part():
    out, xs = {}, {}
    for name, (a, rhs) in systems().items():
        n = a.shape[0]
        ell = ELLMatrix.from_scipy(a, dtype=jnp.float64)
        c_sp = fsai_columns(a)
        out[name] = {"n": n, "n_pad": ell.n_pad, "runs": {}}
        for s in SHARDS:
            sharded = shard_ell_rows(ell, s)
            b = np.zeros(ell.n_pad)
            b[:n] = rhs
            b_dev = jnp.asarray(pad_vector(b, sharded.n_total))
            mesh = make_mesh(s)
            out[name]["halo"] = sharded.halo
            for mode in MODES:
                for pre in PRECONDS:
                    apply_m, m_data = preconditioner(pre, a, sharded, s,
                                                     c_sp, ell)
                    res = pcg_sharded(mesh, sharded, b_dev, m_data=m_data,
                                      apply_m=apply_m, mode=mode)
                    key = f"{name}/{s}/{mode}/{pre}"
                    out[name]["runs"][key] = {
                        "iterations": int(res.iterations),
                        "residual": float(res.residual)}
                    if mode == "allgather":  # the halo run's x agrees
                        xs[f"{name}/{s}/{pre}"] = np.asarray(res.x)[:n]
                    print(f"{key}: {int(res.iterations)}", flush=True)
    return out, xs


def scaling_part(g):
    dia = poisson_dia((g, g, g), dtype=jnp.float32)
    a = dia.to_scipy().tocsr()
    n = dia.n
    b_host = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    # scripts/scaling_bench.py's fsai: tril(A) (power 1), one batched
    # masked Gauss-Jordan through fsai_values_lookup
    coo = a.tocoo()
    keep = coo.row >= coo.col
    order = np.argsort(coo.row[keep].astype(np.int64) * n + coo.col[keep])
    l0_r = coo.row[keep][order].astype(np.int32)
    l0_c = coo.col[keep][order].astype(np.int32)
    l0_v = coo.data[keep][order].astype(np.float32)
    n_pad8 = ((n + 7) // 8) * 8
    pad = np.arange(n, n_pad8, dtype=np.int32)
    l0_r = np.concatenate([l0_r, pad])
    l0_c = np.concatenate([l0_c, pad])
    l0_v = np.concatenate([l0_v, np.ones(n_pad8 - n, np.float32)])
    pr, pc = tril_power_pattern(l0_r, l0_c, n_pad8, power=1)
    plan = build_fsai_plan(l0_r, l0_c, pr, pc, n_pad8)
    c_vals = np.asarray(jax.jit(fsai_values_lookup)(plan, jnp.asarray(l0_v)))
    ell = ELLMatrix.from_scipy(a, dtype=jnp.float32)
    sharded = shard_ell_rows(ell, 1)
    b = jnp.asarray(pad_vector(b_host, sharded.n_total))
    mesh = make_mesh(1)
    out = {"grid": g, "n": n, "halo": sharded.halo, "width": plan.width,
           "max_iter": SCALING_MAX_ITER, "sweeps": SWEEPS, "iterations": {}}
    for mode in MODES:
        for pre in SCALING_PRECONDS:
            if pre == "none":
                apply_m, m_data = identity_local, None
            elif pre == "jacobi":
                d = np.zeros(sharded.n_total, np.float32)
                d[:n] = 1.0 / a.diagonal()
                apply_m, m_data = diag_local, jnp.asarray(d)
            elif pre == "block_jacobi_ic":
                bj = build_block_jacobi_ic(sp.csr_matrix(a), 1,
                                           sharded.n_total, sweeps=SWEEPS)
                apply_m = block_jacobi_apply
                m_data = jax.tree.map(
                    lambda x: x.astype(jnp.float32)
                    if jnp.issubdtype(x.dtype, jnp.floating) else x, bj)
            else:
                sf = build_sharded_fsai(np.asarray(plan.out_rows), c_vals, 1,
                                        n_total=sharded.n_total)
                apply_m = make_fsai_sharded_apply(sf.halo)
                m_data = {"u_pos": sf.u_pos,
                          "u_vals": sf.u_vals.astype(jnp.float32),
                          "l_pos": sf.l_pos,
                          "l_vals": sf.l_vals.astype(jnp.float32)}
            res = pcg_sharded(mesh, sharded, b, m_data=m_data,
                              apply_m=apply_m, mode=mode,
                              max_iter=SCALING_MAX_ITER)
            out["iterations"][f"{mode}/{pre}"] = int(res.iterations)
            print(f"{g}^3 {mode} {pre}: {int(res.iterations)}", flush=True)
    return out


def main() -> None:
    gloo, xs = gloo_part()
    scaling = {g: scaling_part(g) for g in SCALING_GRIDS}
    (FIXTURES / "parallel_iterations.json").write_text(json.dumps({
        "what": "JAX reference pcg_sharded on the CPU's virtual mesh",
        "shards": list(SHARDS), "modes": list(MODES),
        "preconds": list(PRECONDS), "sweeps": SWEEPS,
        "fsai_power": FSAI_POWER, "poly_q": list(POLY_Q),
        "gloo": gloo, "scaling": scaling[SCALING_GRIDS[0]],
        "scaling16": scaling[SCALING_GRIDS[1]],
    }, indent=1))
    np.savez_compressed(FIXTURES / "parallel_x.npz", **xs)
    print(f"wrote {FIXTURES / 'parallel_iterations.json'}")


if __name__ == "__main__":
    main()
