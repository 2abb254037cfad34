"""Data-parallel training over ranks: the batch split, the gradient
all-reduce and the parameter broadcast.

Counterpart of ``dp_shard`` (``deeppreconditioning_tpu/train/
trainer.py``).  The reference puts every batch leaf whose leading axis
divides by the device count on ``P("dp")`` and lets GSPMD compile the
step of the global batch.  Here every rank is one process on one device
(``multihost.train_world``) and the step is explicit:

- each rank takes a contiguous span of every batch's cases
  (``case_span``, the spans of ``np.array_split``; a rank's span may be
  empty);
- its loss on that span is weighted by ``loss_weight``: n_local /
  n_global for a loss that is a mean over the cases (all but
  ``frobenius_loss``), 1 for the sum, so the ranks' weighted losses add
  up to the global batch's loss whatever the split;
- one SUM all-reduce per step (``all_reduce_gradients``) carries every
  parameter's gradient (zeros where a rank has none) and the weighted
  loss in one flat buffer: every rank then holds the global batch's
  gradient and loss;
- Adam then runs on the same gradients on every rank, from the same
  parameters (``broadcast_parameters`` from rank 0 at the start).

The flat COO batch is never cut leaf by leaf: a rank's share is rebuilt
from its cases (``PlannedDataSet.share``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from deeppreconditioning_tpu_torch.parallel.multihost import SolverWorld
from deeppreconditioning_tpu_torch.utils.tracing import Interval

SUM_LOSSES = ("frobenius_loss",)  # the rest are means over the cases


def case_span(batch_size: int, rank: int, size: int) -> range:
    """Rank ``rank``'s cases of a batch of ``batch_size`` over ``size``
    ranks: contiguous, the first ``batch_size % size`` ranks one case
    more (``np.array_split``'s spans)."""
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} outside a world of {size}")
    bounds = np.cumsum([0] + [len(part) for part in
                              np.array_split(np.arange(batch_size), size)])
    return range(int(bounds[rank]), int(bounds[rank + 1]))


class RankShares:
    """A split's batches as one rank's shares: item ``i`` is
    ``split.share(i, cases)`` (a ``DeviceBatch`` of the cases ``cases``
    of batch ``i``, or None when they are none)."""

    def __init__(self, split, cases: range) -> None:
        self.split = split
        self.cases = cases
        self.batch_size = split.batch_size

    def __len__(self) -> int:
        return len(self.split)

    def __getitem__(self, i: int):
        return self.split.share(i, self.cases)


def loss_weight(loss: str, n_local: int, n_global: int) -> float:
    """The factor of a rank's loss before its backward: 1 for a sum over
    the cases, n_local / n_global for a mean."""
    return 1.0 if loss in SUM_LOSSES else n_local / n_global


def _group_args(world: SolverWorld) -> dict:
    return {} if world.group is None else {"group": world.group}


def broadcast_parameters(model: torch.nn.Module, world: SolverWorld) -> None:
    """Every rank's parameters become rank 0's (one broadcast of the flat
    parameters)."""
    params = list(model.parameters())
    flat = torch.cat([p.detach().reshape(-1) for p in params])
    dist.broadcast(flat, src=0, **_group_args(world))
    with torch.no_grad():
        offset = 0
        for p in params:
            p.copy_(flat[offset:offset + p.numel()].view_as(p))
            offset += p.numel()


class CollectiveClock:
    """Times each all-reduce with a ``utils/tracing.Interval``: CUDA
    events on a CUDA device (read after the step has synchronized), the
    host clock on the CPU (gloo's collectives return when they are
    done)."""

    def __init__(self, device) -> None:
        self.device = torch.device(device)
        self._spans: list = []

    def start(self) -> Interval:
        return Interval(self.device)

    def stop(self, begun: Interval) -> None:
        self._spans.append(begun.stop())

    def take(self) -> list[float]:
        """The milliseconds of the all-reduces since the last call."""
        spans, self._spans = self._spans, []
        return [span.ms() for span in spans]


def all_reduce_gradients(model: torch.nn.Module, world: SolverWorld,
                         loss: torch.Tensor | None,
                         clock: CollectiveClock | None = None
                         ) -> torch.Tensor:
    """SUM-all-reduce this rank's gradients and its weighted ``loss``
    (None: an empty share, which joins with zeros) in one flat buffer;
    every parameter's ``grad`` becomes its slice of the sum.  A parameter
    with no gradient adds zeros, so every rank flattens the same layout
    (Adam then leaves it where it is, its moments zero, as one device's
    Adam, which skips it, does).  Returns the summed loss: the global
    batch's."""
    params = list(model.parameters())
    ref = params[0]
    parts = [torch.zeros_like(p).reshape(-1) if p.grad is None
             else p.grad.reshape(-1) for p in params]
    value = (torch.zeros(1, dtype=ref.dtype, device=ref.device)
             if loss is None else loss.detach().reshape(1).to(ref.dtype))
    flat = torch.cat(parts + [value])
    begun = None if clock is None else clock.start()
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, **_group_args(world))
    if clock is not None:
        clock.stop(begun)
    offset = 0
    for p in params:
        p.grad = flat[offset:offset + p.numel()].view_as(p)
        offset += p.numel()
    return flat[-1]


def broadcast_floats(world: SolverWorld, values) -> list[float]:
    """Rank 0's ``values`` (Python floats) on every rank, exactly (one
    float64 broadcast on the world's device)."""
    flat = torch.tensor([float(v) for v in values], dtype=torch.float64,
                        device=world.device)
    dist.broadcast(flat, src=0, **_group_args(world))
    return flat.tolist()
