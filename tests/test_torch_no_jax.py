"""The PyTorch port imports no JAX, Flax, msgpack or YAML: every module of the
package (and ``chip_smoke.py``) imports in a subprocess where those
modules cannot be imported, the conv train stage's and the structured
trainer's and scaling protocol's names, the batched probe, the mesh study
and the one-off deployed setup included, the distributed solver, the
generate stage, the pipeline runner, the residual-parity report and the
scaling bench too, the data-parallel trainer and the multichip dry run
as well, and the host runtime it
builds and loads there is its own (nothing under ``native/`` or
``deeppreconditioning_tpu/`` among the loaded shared objects)."""

import subprocess
import sys
from pathlib import Path

import torch  # noqa: F401  (the port needs torch, and only torch)

REPO = Path(__file__).resolve().parents[1]

PROBE = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "yaml", "msgpack"):
    sys.modules[name] = None
import deeppreconditioning_tpu_torch as pkg
names = [pkg.__name__] + [
    m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
]
for name in names:
    importlib.import_module(name)
import chip_smoke
for name in ("ops.ic0", "ops.trisolve", "ops.amg", "ops.banded_factor",
             "bench.irregular", "metrics", "sparse.coo", "train.trainer",
             "train.__main__", "utils.logging", "ops.sparse_conv",
             "ops.factor_apply", "models.precond_net", "models.sparse_unet",
             "test", "data.datasets", "train.checkpoint", "config",
             "train.structured", "bench.large_solve", "ops.stencil",
             "data.poisson", "solvers.cg", "bench.batched_probe",
             "compare_meshes", "parallel", "parallel.partition",
             "parallel.multihost", "parallel.pcg", "parallel.block_jacobi",
             "parallel.fsai", "sparse.csr", "generate_data", "repro",
             "residual_parity", "scaling_bench", "parallel.data_parallel",
             "dryrun"):
    assert pkg.__name__ + "." + name in sys.modules, name
from deeppreconditioning_tpu_torch.data.datasets import (
    ConvPlans, RandomSPDDataSet, StAnDataSet, download_from_kaggle)
from deeppreconditioning_tpu_torch.models import (
    conv_params_from_jax, conv_params_to_jax, init_params)
from deeppreconditioning_tpu_torch.train.trainer import (
    conv_loss, train, train_step, validate, warmup_cosine_decay)
from deeppreconditioning_tpu_torch.train.structured import (
    batch_loss, make_data, run)
from deeppreconditioning_tpu_torch.ops.dia_spmv import DIAMatvec
from deeppreconditioning_tpu_torch.ops.structured_fsai import (
    make_structured_poly_apply, offset_lower_matvec, offset_upper_matvec)
from deeppreconditioning_tpu_torch.ops.stencil import (
    StencilOperator3D, poisson2d_stencil_matvec, stencil_matvec_flat,
    stencil_matvec_padded)
from deeppreconditioning_tpu_torch.data.poisson import (
    poisson_family, poisson_rhs_sequence)
from deeppreconditioning_tpu_torch.solvers.cg import (
    benchmark_cg, conjugate_gradient, pcg_sequence_fixed_trips,
    pcg_with_history)
from deeppreconditioning_tpu_torch.bench.large_solve import large_solve
from deeppreconditioning_tpu_torch.bench.scaling import (
    amg_setup, crossover_k, next_unique, rhs_sequence, scaling_problem)
from deeppreconditioning_tpu_torch.ops.ic0 import (
    ict_factor, materialize_normal)
from deeppreconditioning_tpu_torch.models.neural_fsai import (
    CasePlan, neural_fsai_case_m, neural_fsai_case_plan,
    neural_fsai_case_setup, neural_fsai_dense_preconditioner, scaled_tril)
from deeppreconditioning_tpu_torch.ops.fsai import (
    fsai_factor_scipy, fsai_values_range, lookup_local_blocks,
    range_dense_factor, round_bf16)
from deeppreconditioning_tpu_torch.parallel.pcg import (
    exchange_slabs, gather_vector, pcg_sharded, sharded_matvec)
from deeppreconditioning_tpu_torch.parallel.fsai import (
    build_sharded_fsai, fsai_apply, make_fsai_poly_sharded_apply,
    make_fsai_sharded_apply)
from deeppreconditioning_tpu_torch.parallel.multihost import (
    SolverWorld, backend_for, initialize_if_needed, initialize_single,
    rank_device, solver_world, train_world)
from deeppreconditioning_tpu_torch.parallel.data_parallel import (
    CollectiveClock, RankShares, all_reduce_gradients, broadcast_floats,
    broadcast_parameters, case_span, loss_weight)
from deeppreconditioning_tpu_torch.dryrun import (
    conv_step, fsai_step, halo_pcg, poly_fsai)
from deeppreconditioning_tpu_torch.train.__main__ import start_world
from deeppreconditioning_tpu_torch.data.fvm import (
    case_digests, generate_dataset, native_assembly, numpy_assembly)
from deeppreconditioning_tpu_torch import native
assert pkg.__name__ + ".native" in sys.modules
assert native.available()  # builds and loads the host runtime
from pathlib import Path
repo = Path(pkg.__file__).resolve().parents[1]
maps = open("/proc/self/maps").read()
for banned in (repo / "native", repo / "deeppreconditioning_tpu"):
    assert str(banned) + "/" not in maps, banned
assert str(repo / "build" / "torch_host") + "/" in maps
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "flax", "yaml", "deeppreconditioning_tpu")
       and sys.modules[m] is not None]
assert not bad, bad
print(len(names))
"""


def test_port_imports_without_jax():
    out = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 68
