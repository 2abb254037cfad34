"""Row-partitioned distributed solver on ``torch.distributed``.

Counterpart of ``deeppreconditioning_tpu/parallel`` (its solver half; the
data-parallel trainer is not ported yet).  Where the reference runs one
program over a device mesh under ``shard_map``, here every rank is a
process that holds its contiguous block of rows on its own device:

    partition     ShardedELL: the host row partition (global columns,
                  equal row blocks, the bandwidth as the halo width)
    multihost     process-group start-up (env://; NCCL for a CUDA
                  device, gloo for the CPU) and the rank/world description
    pcg           the sharded SpMV (all-gather or halo exchange) and the
                  chunked PCG with all-reduced scalars
    block_jacobi  shard-local IC(0) applied by Neumann sweeps
    fsai          the exact FSAI factor apply with two halo exchanges,
                  and its polynomial wrap

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
