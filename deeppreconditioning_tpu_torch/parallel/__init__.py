"""Row-partitioned distributed solver and data-parallel training on
``torch.distributed``.

Counterpart of ``deeppreconditioning_tpu/parallel`` and of the
reference trainer's ``dp_shard``.  Where the reference runs one program
over a device mesh under ``shard_map`` (or GSPMD), here every rank is a
process on its own device, holding its contiguous block of rows (the
solver) or its contiguous share of every batch's cases (training):

    partition     ShardedELL: the host row partition (global columns,
                  equal row blocks, the bandwidth as the halo width)
    multihost     process-group start-up (env://; NCCL for a CUDA
                  device, gloo for the CPU), each rank's card and the
                  rank/world description (``solver_world``,
                  ``train_world``)
    pcg           the sharded SpMV (all-gather or halo exchange) and the
                  chunked PCG with all-reduced scalars
    block_jacobi  shard-local IC(0) applied by Neumann sweeps
    fsai          the exact FSAI factor apply with two halo exchanges,
                  and its polynomial wrap
    data_parallel the trainer's batch split (``case_span``), the one
                  gradient-and-loss all-reduce a step and the parameter
                  broadcast (``train`` / ``train_neural_fsai``'s ``world``)

Edge shards address no column outside the domain, so the halo exchanges
talk to the neighbours that exist; at world size 1 there is nothing to
exchange.
"""

from deeppreconditioning_tpu_torch.parallel.partition import (
    ShardedELL,
    pad_vector,
    shard_ell_rows,
)
from deeppreconditioning_tpu_torch.parallel.pcg import (
    pcg_sharded,
    sharded_matvec,
)

__all__ = [
    "ShardedELL",
    "pad_vector",
    "shard_ell_rows",
    "sharded_matvec",
    "pcg_sharded",
]
