"""Residual curves of the JAX reference's residual-parity report, and the
file digests of its generate stage, for the PyTorch port.

Runs ``scripts/residual_parity.py``'s loop on the JAX package, on the
CPU, with its numpy assembly, IC(0) and level paths (the C++ ``native``
library switched off, as the port's fixture-held paths pin its numpy
assembly): the first ``CASES`` sludge-pattern cases from seed 69420 at
``mesh_cells`` 2, vanilla / jacobi / incomplete_cholesky / fsai /
learned (the flagship checkpoint at its pattern power) in float64 and
float32, each ``pcg_with_history`` at 1024 iterations.  Keeps every
run's iterations, final squared relative residual and curve (its first
``iterations`` values, at full precision).

Then the generate stage on the same stream: the first ``GENERATE``
cases of ``generate_dataset`` (seed 69420, ``mesh_cells`` 2), written in
the reference's layout and digested file by file (each text file's
sha256; ``matrix.npz`` member by member, since the archive's zip headers
carry the write time).

Writes ``tests/fixtures/torch_port/residual_parity.json`` (about 1.5
minutes on 8 CPU cores).

    JAX_PLATFORMS=cpu python scripts/torch_port_residual_parity_reference.py
"""

from __future__ import annotations

import hashlib
import json
import sys
import tempfile
import zipfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from deeppreconditioning_tpu import native  # noqa: E402

native.available = lambda: False  # the numpy paths the port's fixtures pin

from deeppreconditioning_tpu.data.fvm import (  # noqa: E402
    generate_dataset,
    generate_sludge_case,
)
from deeppreconditioning_tpu.models import NeuralFSAI  # noqa: E402
from deeppreconditioning_tpu.models.neural_fsai import (  # noqa: E402
    neural_fsai_case_setup,
)
from deeppreconditioning_tpu.ops.fsai import (  # noqa: E402
    fsai_factor_scipy,
    tril_power_pattern,
)
from deeppreconditioning_tpu.ops.ic0 import (  # noqa: E402
    ic0_factor,
    jacobi_preconditioner,
)
from deeppreconditioning_tpu.ops.trisolve import (  # noqa: E402
    build_tri_schedule,
    ic_apply,
    transpose_schedule,
)
from deeppreconditioning_tpu.solvers.cg import (  # noqa: E402
    dense_matvec,
    ell_matvec,
    pcg_with_history,
)
from deeppreconditioning_tpu.sparse import ELLMatrix  # noqa: E402
from deeppreconditioning_tpu.train.trainer import (  # noqa: E402
    load_checkpoint,
)

OUT = REPO / "tests" / "fixtures" / "torch_port" / "residual_parity.json"
CHECKPOINT = REPO / "assets" / "checkpoints_fsai" / "best.msgpack"
SEED = 69420
MESH_CELLS = 2
CASES = 5
GENERATE = 50
TECHNIQUES = ("vanilla", "jacobi", "incomplete_cholesky", "fsai", "learned")


def _digests(folder: Path) -> dict:
    out = {}
    with zipfile.ZipFile(folder / "matrix.npz") as archive:
        for member in archive.namelist():
            out[f"matrix.npz/{member}"] = hashlib.sha256(
                archive.read(member)).hexdigest()
    for name in ("right_hand_side.csv", "solution.csv"):
        out[name] = hashlib.sha256((folder / name).read_bytes()).hexdigest()
    return out


def _runs(model, params, power):
    rng = np.random.default_rng(SEED)
    rows = []
    for case_idx in range(CASES):
        case = generate_sludge_case(rng, mesh_cells=MESH_CELLS)
        a = case.matrix.tocsr()
        n = a.shape[0]
        for dtype, label in ((jnp.float64, "f64"), (jnp.float32, "f32")):
            ell = ELLMatrix.from_scipy(a, dtype=dtype)
            b = np.zeros(ell.n_pad)
            b[:n] = case.rhs
            b_dev = jnp.asarray(b, dtype)
            for tech in TECHNIQUES:
                if tech == "jacobi":
                    d = np.zeros(ell.n_pad)
                    d[:n] = jacobi_preconditioner(a)
                    apply_m, m_data = (lambda m, r: m * r), jnp.asarray(
                        d, dtype)
                elif tech == "incomplete_cholesky":
                    lf = ic0_factor(a)
                    cast = lambda t: jax.tree.map(  # noqa: E731
                        lambda x: x.astype(dtype)
                        if jnp.issubdtype(x.dtype, jnp.floating) else x, t)
                    apply_m = lambda md, r: ic_apply(md[0], md[1], r)  # noqa
                    m_data = (cast(build_tri_schedule(lf, n_pad=ell.n_pad)),
                              cast(transpose_schedule(lf, n_pad=ell.n_pad)))
                elif tech == "fsai":
                    coo = a.tocoo()
                    keep = coo.row >= coo.col
                    pr, pc = tril_power_pattern(
                        coo.row[keep].astype(np.int32),
                        coo.col[keep].astype(np.int32), n, power=4)
                    c_sp = fsai_factor_scipy(a, pr, pc)
                    m = np.zeros((ell.n_pad, ell.n_pad))
                    m[:n, :n] = (c_sp @ c_sp.T).toarray()
                    apply_m, m_data = dense_matvec, jnp.asarray(m, dtype)
                elif tech == "learned":
                    m, _ = neural_fsai_case_setup(model, params, a, power,
                                                  dtype=dtype)
                    m_np = np.zeros((ell.n_pad, ell.n_pad))
                    m_np[:n, :n] = np.asarray(m, np.float64)[:n, :n]
                    apply_m, m_data = dense_matvec, jnp.asarray(m_np, dtype)
                else:
                    apply_m, m_data = (lambda m, r: r), None
                res, hist = pcg_with_history(ell_matvec, ell, b_dev,
                                             apply_m, m_data)
                iters = int(res.iterations)
                rows.append({
                    "case": case_idx, "technique": tech, "dtype": label,
                    "iterations": iters,
                    "final_sq_rel_residual": float(res.residual),
                    "curve": [float(v) for v in
                              np.asarray(hist, np.float64)[:iters]],
                })
                print(f"case {case_idx} {tech} {label}: {iters}",
                      flush=True)
    return rows


def main() -> None:
    payload = load_checkpoint(CHECKPOINT)
    model = NeuralFSAI(width=int(payload["width"]),
                       hidden=int(payload.get("hidden", 64)),
                       poly_degree=int(payload.get("poly_degree", 1)))
    power = int(payload.get("power", 4)) or 4
    rows = _runs(model, payload["params"], power)
    with tempfile.TemporaryDirectory() as tmp:
        generate_dataset(Path(tmp), number_samples=GENERATE,
                         mesh_cells=MESH_CELLS, seed=SEED)
        digests = [_digests(Path(tmp) / f"case_{i:04d}")
                   for i in range(GENERATE)]
    OUT.write_text(json.dumps({
        "what": "JAX reference, CPU, scripts/residual_parity.py's loop, "
                "numpy assembly / IC(0) / levels",
        "seed": SEED, "mesh_cells": MESH_CELLS, "cases": CASES,
        "checkpoint": str(CHECKPOINT.relative_to(REPO)),
        "learned_power": power, "width": int(payload["width"]),
        "rows": rows,
        "generate": {"samples": GENERATE, "digests": digests},
    }, indent=1))
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
