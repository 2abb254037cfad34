"""Per-case incomplete_lu iterations of the JAX reference, flagship split.

Runs the JAX package on the CPU in float32 (the card's dtype) over the
sludge-pattern test split (500 cases from seed 69420 at ``mesh_cells=2``,
last 100 cases) for the technique incomplete_lu: the suite's
``_setup_incomplete_lu`` (ICT with ``add_fill_in=1``, ``threshold=0.1``,
then the two level-scheduled triangular solves) and
``preconditioned_conjugate_gradient`` with the ELL operator, no timing.
The reference's compiled host library (``native/libdptpu.so``) must be
available: its sparse left-looking ICT is the reference's own route for
this technique, and the script refuses to run on the dense numpy
fallback.  The first ``KAPPA_CASES`` cases also get the suite's density
and kappa bookkeeping in float64, and every case records whether
ICT(1, 0.1)'s factor has tril(A)'s pattern, and its largest relative
difference from IC(0)'s factor.

Writes ``tests/fixtures/torch_port/ilu_iterations.json``.  The PyTorch
port's ``chip_smoke.py`` holds its per-case counts on the GPU against it.
About a minute.

    JAX_PLATFORMS=cpu python scripts/torch_port_ilu_reference.py
"""

from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import scipy.sparse as sp

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from deeppreconditioning_tpu import native  # noqa: E402
from deeppreconditioning_tpu.bench.suite import BenchmarkSuite  # noqa: E402
from deeppreconditioning_tpu.data.datasets import (  # noqa: E402
    SludgePatternDataSet,
)
from deeppreconditioning_tpu.data.fvm import (  # noqa: E402
    generate_sludge_case,
    save_case,
)
from deeppreconditioning_tpu.models import plan_builder_for  # noqa: E402
from deeppreconditioning_tpu.ops.ic0 import (  # noqa: E402
    ic0_factor,
    ict_factor,
)
from deeppreconditioning_tpu.solvers.cg import (  # noqa: E402
    ell_matvec,
    preconditioned_conjugate_gradient,
)
from deeppreconditioning_tpu.sparse import ELLMatrix  # noqa: E402

SEED = 69420
SAMPLES = 500
MESH_CELLS = 2
KAPPA_CASES = 5  # the test stage's --kappa-cases default
ADD_FILL_IN, THRESHOLD = 1, 0.1
OUT = REPO / "tests" / "fixtures" / "torch_port" / "ilu_iterations.json"


def main() -> None:
    if not native.available():
        raise SystemExit("native/libdptpu.so does not load: the reference's "
                         "ICT route is its native one")
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        rng = np.random.default_rng(SEED)
        for i in range(SAMPLES):
            case = generate_sludge_case(rng, mesh_cells=MESH_CELLS)
            save_case(case, root / "sludge_patterns" / f"case_{i:04d}")
        data_set = SludgePatternDataSet(
            stage="test", batch_size=1,
            specs=plan_builder_for("NeuralFSAI", None),
            shuffle=False, root=root,
        )

    # the suite here only supplies its host reconstruction and the setup
    suite = BenchmarkSuite(data_set, None, None,
                           techniques=("incomplete_lu",), kappa_cases=0)
    n_pad = data_set.dof_pad
    iterations, success, same_pattern, ic0_rel = [], [], [], []
    kappas, densities = [], []
    for index in range(len(data_set)):
        batch = data_set[index]
        a_sp, rhs, n0 = suite._reconstruct(index)
        ell = ELLMatrix.from_scipy(a_sp, n_pad=n_pad, dtype=jnp.float32)
        b = np.zeros(n_pad)
        b[:n0] = rhs
        need_dense = index < KAPPA_CASES
        apply_m, m_data, density, m_sp = suite._setup_incomplete_lu(
            a_sp, batch, ell, need_dense)
        res = preconditioned_conjugate_gradient(
            ell_matvec, ell, jnp.asarray(b, jnp.float32), apply_m, m_data,
            rtol=suite.rtol, max_iter=suite.max_iter,
            check_every=suite.check_every,
        )
        iterations.append(int(res.iterations))
        success.append(bool(float(res.residual) < suite.rtol))
        densities.append(float(density))
        if need_dense:
            kappas.append(float(np.linalg.cond((m_sp @ a_sp).toarray())))
        l_ict = ict_factor(a_sp, add_fill_in=ADD_FILL_IN,
                           threshold=THRESHOLD)
        l_ic0 = ic0_factor(a_sp)
        tril = sp.tril(a_sp.tocsr(), format="csr")
        same = (np.array_equal(l_ict.indptr, tril.indptr)
                and np.array_equal(l_ict.indices, tril.indices))
        same_pattern.append(bool(same))
        ic0_rel.append(float(np.max(np.abs(l_ict.data - l_ic0.data)
                                    / np.abs(l_ic0.data))) if same
                       else float("nan"))

    out = {
        "what": "per-case incomplete_lu PCG iterations of the JAX "
                "reference, CPU float32, ICT through the reference's "
                "native library (its own route); density and kappa in "
                "float64 on the first kappa_cases cases",
        "ict_route": "native",
        "seed": SEED,
        "samples": SAMPLES,
        "mesh_cells": MESH_CELLS,
        "split": "test",
        "cases": len(data_set),
        "n_pad": n_pad,
        "add_fill_in": ADD_FILL_IN,
        "threshold": THRESHOLD,
        "check_every": suite.check_every,
        "rtol": suite.rtol,
        "max_iter": suite.max_iter,
        "kappa_cases": KAPPA_CASES,
        "mean_iterations": float(np.mean(iterations)),
        "iterations": iterations,
        "success": success,
        "densities": densities,
        "kappas": kappas,
        "ict_pattern_is_tril_a": same_pattern,
        "ict_vs_ic0_max_rel": ic0_rel,
    }
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps({k: out[k] for k in ("mean_iterations", "cases")})
          + f" kappa {np.mean(kappas)} density {np.mean(densities)} "
          f"same pattern {sum(same_pattern)}/{len(same_pattern)} "
          f"max rel vs IC(0) {np.nanmax(ic0_rel)}")


if __name__ == "__main__":
    main()
