"""Process-group start-up and the rank/world description of the solver.

Counterpart of ``deeppreconditioning_tpu/parallel/multihost.py`` on
``torch.distributed``.  The reference starts ``jax.distributed`` from
``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` and builds a device
mesh; here every rank is one process on one device, started from the
standard env:// variables (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, as ``torchrun`` sets them):

    MASTER_ADDR=<host0> MASTER_PORT=29500 WORLD_SIZE=<N> RANK=<i> \
        python your_script.py

The backend follows the device the caller passes: NCCL for a CUDA
device, gloo for the CPU.  It is never chosen by probing for a GPU, and
nothing falls back from one to the other.  ``SolverWorld`` takes the
place of the reference's ``solver_mesh`` / ``make_mesh``: the rank, the
shard count, the device and the group the solver's collectives use.
There is no device mesh.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass

import torch
import torch.distributed as dist

ENV_KEYS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


@dataclass(frozen=True)
class SolverWorld:
    """One rank's view of the row-partitioned solver.

    rank / size: this rank and the shard count (ranks 0..size-1 hold the
    shards, in order, so a group rank is the global rank); ``group``:
    their process group (None: the default group).
    """

    rank: int
    size: int
    device: torch.device
    group: object = None

    @property
    def left(self) -> int | None:
        """The rank holding the rows before this one's, if any."""
        return self.rank - 1 if self.rank > 0 else None

    @property
    def right(self) -> int | None:
        """The rank holding the rows after this one's, if any."""
        return self.rank + 1 if self.rank < self.size - 1 else None


def backend_for(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _start(device, **kwargs) -> None:
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend=backend_for(device), **kwargs)


def initialize_if_needed(device) -> bool:
    """Start the default process group from env:// when ``WORLD_SIZE``
    and ``RANK`` (with ``MASTER_ADDR`` / ``MASTER_PORT``) are set.

    Returns True when the process group exists (started here or before),
    False when no multi-process environment is configured.  The backend
    is ``backend_for(device)``."""
    if dist.is_initialized():
        return True
    if not all(os.environ.get(k) for k in ENV_KEYS):
        return False
    _start(device, init_method="env://",
           world_size=int(os.environ["WORLD_SIZE"]),
           rank=int(os.environ["RANK"]))
    return True


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def initialize_single(device) -> None:
    """A process group of this process alone (world size 1, rank 0, at
    ``tcp://localhost:<free port>``): the solver's collectives then run,
    on ``backend_for(device)``, with no peer."""
    _start(device, init_method=f"tcp://localhost:{free_port()}",
           world_size=1, rank=0)


def solver_world(device, n_shards: int | None = None) -> SolverWorld | None:
    """The solver's world over the first ``n_shards`` ranks of the
    default group (all of them by default).  Every rank must call it (a
    subgroup is created collectively); a rank outside the shards gets
    None."""
    world = dist.get_world_size()
    size = world if n_shards is None else n_shards
    if not 1 <= size <= world:
        raise ValueError(f"{size} shards on a world of {world} ranks")
    group = None if size == world else dist.new_group(list(range(size)))
    rank = dist.get_rank()
    if rank >= size:
        return None
    return SolverWorld(rank=rank, size=size, device=torch.device(device),
                       group=group)


def shutdown() -> None:
    """Destroy the default process group, if any."""
    if dist.is_initialized():
        dist.destroy_process_group()
