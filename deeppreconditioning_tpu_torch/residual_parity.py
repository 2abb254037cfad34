"""Residual-curve parity report: every technique's PCG in float64 and in
float32 on the first sludge cases.

    python -m deeppreconditioning_tpu_torch.residual_parity [--cases 5]
        [--out PATH] [--device cuda|cpu]

Counterpart of ``scripts/residual_parity.py``: the first ``--cases``
sludge-pattern cases from seed 69420 at ``mesh_cells`` 2, each solved by
PCG in float64 (the reference's arithmetic) and float32 with vanilla,
jacobi, incomplete_cholesky (IC(0), two level-scheduled solves), fsai
(the float64 host factor on tril(|A|^4), M = C C^T dense) and, when
``params.yaml``'s model is NeuralFSAI and ``checkpoint_dir/best.msgpack``
exists, learned (``models.neural_fsai.neural_fsai_case_setup`` in the
run's dtype at the checkpoint's pattern power: in float64 it runs kernel
B1's float64 instance on the card, at the checkpoint's width 24).  Each
run is ``solvers.cg.pcg_with_history`` (1024 masked iterations, the
squared relative residual after each); the report writes the
reference's CSV columns (case, technique, dtype, iterations,
final_sq_rel_residual, curve; the curve's first ``iterations`` values)
to ``assets/results/torch/residual_parity.csv`` and prints the float32
against float64 iteration deltas.  Runs on the card unless ``--device
cpu``.
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path

import numpy as np
import scipy.sparse as sp
import torch

from deeppreconditioning_tpu_torch import _backend
from deeppreconditioning_tpu_torch.config import params_show
from deeppreconditioning_tpu_torch.data.fvm import generate_sludge_case
from deeppreconditioning_tpu_torch.models.neural_fsai import (
    neural_fsai_case_setup,
    neural_fsai_from_checkpoint,
)
from deeppreconditioning_tpu_torch.ops.fsai import (
    fsai_factor_scipy,
    tril_power_pattern,
)
from deeppreconditioning_tpu_torch.ops.ic0 import (
    ic0_factor,
    jacobi_preconditioner,
)
from deeppreconditioning_tpu_torch.ops.trisolve import (
    build_tri_schedule,
    ic_apply,
    transpose_schedule,
)
from deeppreconditioning_tpu_torch.solvers.cg import (
    dense_matvec,
    ell_matvec,
    pcg_with_history,
)
from deeppreconditioning_tpu_torch.sparse.ell import ELLMatrix
from deeppreconditioning_tpu_torch.train.checkpoint import load_checkpoint

REPO = Path(__file__).resolve().parents[1]
SEED = 69420
MESH_CELLS = 2
FSAI_POWER = 4  # the classical fsai row's pattern power
DTYPES = ((torch.float64, "f64"), (torch.float32, "f32"))
COLUMNS = ("case", "technique", "dtype", "iterations",
           "final_sq_rel_residual", "curve")


def load_learned(params):
    """(model, pattern power) of ``params``' NeuralFSAI checkpoint, or
    (None, None) when the model is another or the checkpoint is absent
    (the reference script's rule)."""
    ckpt = REPO / params.checkpoint_dir / "best.msgpack"
    if params.model != "NeuralFSAI" or not ckpt.exists():
        return None, None
    payload = load_checkpoint(ckpt)
    return (neural_fsai_from_checkpoint(payload),
            int(payload.get("power", 4)) or 4)


def _tri_apply(m, r):
    return ic_apply(m[0], m[1], r)


def _dense(m_raw: np.ndarray, n: int, n_pad: int) -> np.ndarray:
    out = np.zeros((n_pad, n_pad))
    out[:n, :n] = m_raw[:n, :n]
    return out


def run_case(a: sp.csr_matrix, rhs: np.ndarray, techniques, device,
             model=None, learned_power=4):
    """Every technique in float64 and float32 on one system: a list of
    (technique, dtype label, CGResult, history) in the reference's order
    (dtypes outside, techniques inside)."""
    n = a.shape[0]
    out = []
    for dtype, label in DTYPES:
        ell = ELLMatrix.from_scipy(a, dtype=dtype, device=device)
        b = np.zeros(ell.n_pad)
        b[:n] = rhs
        b_dev = torch.as_tensor(b, device=device).to(dtype)

        def dense(m):
            return torch.as_tensor(m, device=device).to(dtype)

        for tech in techniques:
            if tech == "jacobi":
                d = np.zeros(ell.n_pad)
                d[:n] = jacobi_preconditioner(a)
                apply_m, m_data = (lambda m, r: m * r), dense(d)
            elif tech == "incomplete_cholesky":
                lf = ic0_factor(a)
                apply_m, m_data = _tri_apply, (
                    build_tri_schedule(lf, n_pad=ell.n_pad).to(device, dtype),
                    transpose_schedule(lf, n_pad=ell.n_pad).to(device,
                                                               dtype))
            elif tech == "fsai":
                coo = a.tocoo()
                keep = coo.row >= coo.col
                pr, pc = tril_power_pattern(
                    coo.row[keep].astype(np.int32),
                    coo.col[keep].astype(np.int32), n, power=FSAI_POWER)
                c_sp = fsai_factor_scipy(a, pr, pc)
                apply_m, m_data = dense_matvec, dense(
                    _dense((c_sp @ c_sp.T).toarray(), n, ell.n_pad))
            elif tech == "learned":
                m, _ = neural_fsai_case_setup(model, a, learned_power,
                                              dtype=dtype, device=device)
                apply_m, m_data = dense_matvec, dense(_dense(
                    m.double().cpu().numpy(), n, ell.n_pad))
            elif tech == "vanilla":
                apply_m, m_data = (lambda m, r: r), None
            else:
                raise ValueError(f"unknown technique {tech!r}")
            res, hist = pcg_with_history(ell_matvec, ell, b_dev, apply_m,
                                         m_data)
            out.append((tech, label, res, hist))
    return out


def run(cases: int = 5, device=None, model=None, learned_power=None,
        log=print) -> list[dict]:
    """The report's rows (``COLUMNS``, the curve as the float list) for
    the first ``cases`` cases; ``model``: the learned row's NeuralFSAI
    (default: ``params.yaml``'s checkpoint, when it is one)."""
    device = _backend.device() if device is None else torch.device(device)
    if model is None:
        model, learned_power = load_learned(params_show(REPO / "params.yaml"))
    techniques = ["vanilla", "jacobi", "incomplete_cholesky", "fsai"]
    if model is not None:
        techniques.append("learned")
    rng = np.random.default_rng(SEED)
    rows = []
    for case_idx in range(cases):
        case = generate_sludge_case(rng, mesh_cells=MESH_CELLS)
        for tech, label, res, hist in run_case(
                case.matrix.tocsr(), case.rhs, techniques, device, model,
                learned_power):
            iters = int(res.iterations)
            rows.append({
                "case": case_idx, "technique": tech, "dtype": label,
                "iterations": iters,
                "final_sq_rel_residual": float(res.residual),
                "curve": hist[:iters].double().cpu().tolist(),
            })
            log(f"case {case_idx} {tech} {label}: {iters} iters, final "
                f"{float(res.residual):.2e}")
    return rows


def summarize(rows, log=print) -> int:
    """Print each (case, technique)'s float32 against float64 count;
    return the largest delta."""
    by_key: dict = {}
    for r in rows:
        by_key.setdefault((r["case"], r["technique"]), {})[r["dtype"]] = r
    max_delta = 0
    for (c, t), d in by_key.items():
        delta = abs(d["f32"]["iterations"] - d["f64"]["iterations"])
        max_delta = max(max_delta, delta)
        rel = delta / max(d["f64"]["iterations"], 1)
        log(f"case {c} {t}: f64={d['f64']['iterations']} "
            f"f32={d['f32']['iterations']} (delta {delta}, {rel:.1%})")
    log(f"max iteration delta f32 vs f64: {max_delta}")
    return max_delta


def write_csv(path: Path, rows) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w") as fio:
        writer = csv.DictWriter(fio, fieldnames=list(COLUMNS))
        writer.writeheader()
        for r in rows:
            writer.writerow(dict(r, curve=";".join(
                f"{v:.6e}" for v in r["curve"])))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog="python -m deeppreconditioning_tpu_torch.residual_parity")
    parser.add_argument("--cases", type=int, default=5)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--out", type=Path, default=REPO / "assets" /
                        "results" / "torch" / "residual_parity.csv")
    args = parser.parse_args(argv)
    rows = run(args.cases, device=None if args.device == "cuda" else "cpu")
    summarize(rows)
    write_csv(args.out, rows)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
