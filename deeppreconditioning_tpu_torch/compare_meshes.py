"""Mesh-generalization study: kappa before and after the learned
preconditioner at mesh resolutions the model never saw.

    python -m deeppreconditioning_tpu_torch.compare_meshes \
        [--cases-per-resolution 3] [--out PATH] [--device cuda|cpu]

Counterpart of ``scripts/compare_meshes.py``: sludge-pattern cases from
``default_rng(69)`` at ``mesh_cells`` 2 to 6 (n from about 780 to about
1935), generated in memory, for each kappa(A) and kappa(M A) (float64 on
the host, ``np.linalg.cond``), written to ``compare_meshes.csv`` under
``assets/results/torch/``.  ``params.yaml``'s ``model`` picks the branch
as the script does:

* NeuralFSAI (the flagship, ``checkpoint_dir/best.msgpack`` at its pattern
  power): the one-off deployed setup ``models/neural_fsai.
  neural_fsai_case_setup`` on the raw system (a generic plan at the
  model's width 24, patterns wider than it capped to the strongest
  couplings per column; one B1 launch per case on the card), M in raw
  space, so kappa(M A);
* a conv model (PreconditionerNet, PreconditionerSparseUNet): the case's
  own conv plan, the forward on its scaled tril, L scattered dense and
  kappa(L L^T A~) in scaled space.

Runs on the card unless ``--device cpu``.  Each case's setup (the
NeuralFSAI branch: forward and M, after its untimed plan build and copy
to the device) is timed as the median of ``TIMING_REPS`` runs.
"""

from __future__ import annotations

import argparse
import csv
import time
from pathlib import Path

import numpy as np
import torch

from deeppreconditioning_tpu_torch import _backend
from deeppreconditioning_tpu_torch.bench.suite import RESULTS_DIRECTORY
from deeppreconditioning_tpu_torch.config import params_show
from deeppreconditioning_tpu_torch.data.fvm import generate_sludge_case
from deeppreconditioning_tpu_torch.metrics import scatter_tril_dense
from deeppreconditioning_tpu_torch.models import (
    conv_model_from_checkpoint,
    plan_builder_for,
)
from deeppreconditioning_tpu_torch.models.neural_fsai import (
    neural_fsai_case_m,
    neural_fsai_case_plan,
    neural_fsai_from_checkpoint,
    scaled_tril,
)
from deeppreconditioning_tpu_torch.ops.sparse_conv import (
    build_sample_plan,
    pad_sample_plans,
    stack_plans,
)
from deeppreconditioning_tpu_torch.train.checkpoint import load_checkpoint
from deeppreconditioning_tpu_torch.utils.profiling import time_call

REPO = Path(__file__).resolve().parents[1]
SEED = 69  # compare_meshes.py's
MESH_CELLS = (2, 3, 4, 5, 6)
CASES_PER_RESOLUTION = 3
OUT = RESULTS_DIRECTORY / "compare_meshes.csv"
FIELDS = ("mesh_cells", "dof", "kappa_pre", "kappa_post")
TIMING_REPS = 3


def kappa_fsai(a, model, power: int, device, dtype=torch.float32):
    """NeuralFSAI branch: kappa(A), kappa(M A), the device setup's
    seconds (median of ``TIMING_REPS``) and how many setups ran (each one
    B1 launch on the card)."""
    a = a.tocsr()
    n = a.shape[0]
    a_dense = a.toarray()
    kappa_pre = float(np.linalg.cond(a_dense))
    case = neural_fsai_case_plan(a, power, model.width, dtype, device)
    setups = 0

    def setup():
        nonlocal setups
        setups += 1
        return neural_fsai_case_m(model, case)

    seconds = time_call(setup, device, reps=TIMING_REPS)
    m = setup().double().cpu().numpy()[:n, :n]
    return {"kappa_pre": kappa_pre,
            "kappa_post": float(np.linalg.cond(m @ a_dense)),
            "setup_s": seconds, "setups": setups}


def kappa_conv(a, model, builder, device, dtype=torch.float32):
    """Conv branch: kappa(A) and kappa(L L^T A~) with the case's own plan
    (``builder`` a ``ConvSpec`` list or an object with ``build``)."""
    a = a.tocsr()
    n = a.shape[0]
    a_dense = a.toarray()
    kappa_pre = float(np.linalg.cond(a_dense))
    rows, cols, vals, diag = scaled_tril(a)
    if hasattr(builder, "build"):
        plan_host = builder.build(rows, cols, (n, n))
    else:
        plan_host = build_sample_plan(rows, cols, (n, n), builder)
    nnz0_pad = ((rows.shape[0] + 255) // 256) * 256
    plans = [p.to(device) for p in
             stack_plans(pad_sample_plans([plan_host], [nnz0_pad]))]
    feats = torch.zeros(1, nnz0_pad, 1, dtype=dtype, device=device)
    feats[0, :rows.shape[0], 0] = torch.as_tensor(vals, device=device)
    model = model.to(device=device, dtype=dtype)
    with torch.no_grad():
        values = model(feats, plans)
        final = plans[-1]
        l_dense = scatter_tril_dense(values, final.rows, final.cols,
                                     final.valid, n)[0]
    l_dense = l_dense.double().cpu().numpy()
    d_isqrt = 1.0 / np.sqrt(diag)
    a_tilde = a_dense * np.outer(d_isqrt, d_isqrt)
    return {"kappa_pre": kappa_pre,
            "kappa_post": float(np.linalg.cond(l_dense @ l_dense.T
                                               @ a_tilde)),
            "setup_s": None, "setups": 0}


def run(device=None, cases_per_resolution: int = CASES_PER_RESOLUTION,
        params=None, dtype=torch.float32) -> list:
    """The study's rows (``FIELDS``, plus the NeuralFSAI branch's
    ``setup_s``, its device setup's seconds, None for a conv model, and
    ``setups``, the setups it ran), in generation order; ``params``
    defaults to ``params.yaml``'s."""
    device = _backend.device() if device is None else torch.device(device)
    params = params_show(REPO / "params.yaml") if params is None else params
    payload = load_checkpoint(REPO / params.checkpoint_dir / "best.msgpack")
    if params.model == "NeuralFSAI":
        model = neural_fsai_from_checkpoint(payload)
        power = int(payload.get("power", 4)) or 4

        def kappas(a):
            return kappa_fsai(a, model, power, device, dtype)
    else:
        model = conv_model_from_checkpoint(params.model, payload,
                                           channels=params.channels)
        builder = plan_builder_for(params.model, params.channels)

        def kappas(a):
            return kappa_conv(a, model, builder, device, dtype)
    return [{"mesh_cells": cells, "dof": case.matrix.shape[0],
             **kappas(case.matrix)}
            for cells, case in study_cases(cases_per_resolution)]


def study_cases(cases_per_resolution: int = CASES_PER_RESOLUTION):
    """The study's ``(mesh_cells, case)`` in generation order, from one
    ``default_rng(SEED)`` stream."""
    rng = np.random.default_rng(SEED)
    for cells in MESH_CELLS:
        for _ in range(cases_per_resolution):
            yield cells, generate_sludge_case(rng, mesh_cells=cells)


def write_csv(rows: list, out: Path = OUT) -> None:
    """``compare_meshes.csv`` in the script's schema."""
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("w") as fio:
        writer = csv.DictWriter(fio, fieldnames=FIELDS,
                                extrasaction="ignore")
        writer.writeheader()
        writer.writerows(rows)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cases-per-resolution", type=int,
                        default=CASES_PER_RESOLUTION)
    parser.add_argument("--out", type=Path, default=OUT)
    parser.add_argument("--device", default=None)
    args = parser.parse_args()
    t0 = time.perf_counter()
    rows = run(args.device, args.cases_per_resolution)
    for row in rows:
        print(f"mesh_cells={row['mesh_cells']} dof={row['dof']} "
              f"kappa {row['kappa_pre']:.4g} -> {row['kappa_post']:.4g}")
    write_csv(rows, args.out)
    print(f"wrote {args.out} ({time.perf_counter() - t0:.1f} s)")


if __name__ == "__main__":
    main()
