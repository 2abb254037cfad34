"""Distributed PCG: the row-partitioned SpMV and all-reduced scalars.

Counterpart of ``deeppreconditioning_tpu/parallel/pcg.py``.  Each rank
runs this code on its own rows (an ``ELLShard``); the numeric contract is
the single-device solver's (``solvers/cg.py``): the same update order,
the squared relative-residual stop ``(r.r) / (b.b) < rtol``, the same
iteration cap, ``check_every`` masked iterations per chunk.  Every dot
product is a local partial dot summed over the ranks by ``all_reduce``
(the reference's ``psum``); the dots an iteration needs at one point go
in one all-reduce (r.z with Ap.p, then r'.z' with r'.r').  ``done`` is
read on the host once per chunk, never once per iteration: every rank
reads the same all-reduced value, so all leave the loop together.

The SpMV comes in two modes:

  * ``allgather`` - ``all_gather_into_tensor`` the whole x each
    application; exact for any pattern.
  * ``halo`` - one ``batch_isend_irecv`` with the left and right
    neighbours (the reference's two ring ``ppermute``s): each rank
    receives the last ``halo`` entries of its left neighbour and the
    first ``halo`` of its right one.  Exact when the bandwidth is at most
    the shard's rows.  The accumulation is split into an interior pass
    that reads only the local x, computed while the exchange is in
    flight, and a boundary pass over the received slabs.  Edge shards
    address no column outside the domain, so the first rank has no left
    exchange and the last no right one (the reference's ring wrap-around
    slabs are never read); at world size 1 there is no peer and nothing
    is sent (``torch.distributed`` refuses a send to oneself).

Preconditioner applies are shard-local (``identity_local``,
``diag_local``, ``block_jacobi.block_jacobi_apply``) or exchange halos
themselves (``fsai``).
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from deeppreconditioning_tpu_torch.parallel.multihost import SolverWorld
from deeppreconditioning_tpu_torch.parallel.partition import ELLShard
from deeppreconditioning_tpu_torch.solvers.cg import CGResult


def identity_local(m_data, r):
    del m_data
    return r


def diag_local(m_data, r):
    """Shard-local Jacobi apply: m_data is the local slice of 1/diag."""
    return m_data * r


def exchange_slabs(world: SolverWorld, to_left: torch.Tensor | None,
                   to_right: torch.Tensor | None, width: int):
    """Start every rank's symmetric exchange: send ``to_left`` (if given)
    to the left neighbour and ``to_right`` (if given) to the right one;
    receive ``width`` entries from the right neighbour when slabs go left,
    and from the left one when slabs go right.  Returns (from_left,
    from_right, works): the receive buffers, zero where nothing arrives,
    filled once every work in ``works`` is waited on."""
    ref = to_left if to_left is not None else to_right
    from_left = ref.new_zeros(width)
    from_right = ref.new_zeros(width)
    ops = []
    if world.left is not None:
        if to_left is not None:
            ops.append(dist.P2POp(dist.isend, to_left, world.left,
                                  world.group))
        if to_right is not None:
            ops.append(dist.P2POp(dist.irecv, from_left, world.left,
                                  world.group))
    if world.right is not None:
        if to_right is not None:
            ops.append(dist.P2POp(dist.isend, to_right, world.right,
                                  world.group))
        if to_left is not None:
            ops.append(dist.P2POp(dist.irecv, from_right, world.right,
                                  world.group))
    works = dist.batch_isend_irecv(ops) if ops else []
    return from_left, from_right, works


def wait_all(works) -> None:
    for work in works:
        work.wait()


def sharded_matvec(a: ELLShard, x_local: torch.Tensor, world: SolverWorld,
                   mode: str) -> torch.Tensor:
    """This rank's rows of y = A x, communicating x as ``mode`` says."""
    if mode == "halo":
        return _matvec_halo(a, x_local, world)
    if mode != "allgather":
        raise ValueError(f"unknown mode {mode!r}")
    return _matvec_allgather(a, x_local, world)


def _matvec_allgather(a: ELLShard, x_local, world: SolverWorld):
    x_ext = x_local.new_zeros(a.n_total + 1)  # slot n_total reads 0
    dist.all_gather_into_tensor(x_ext[:a.n_total], x_local,
                                group=world.group)
    return (a.vals * x_ext[a.cols]).sum(dim=1)


def _matvec_halo(a: ELLShard, x_local, world: SolverWorld):
    """Neighbour halo exchange (exact iff bandwidth <= rows per shard),
    the interior pass overlapping it."""
    h = a.halo_w
    from_left, from_right, works = exchange_slabs(
        world, x_local[:h], x_local[-h:], h)
    x_loc_ext = torch.cat([x_local, x_local.new_zeros(1)])
    y = (a.vals * x_loc_ext[a.loc]).sum(dim=1)
    wait_all(works)
    halos = torch.cat([from_left, from_right, x_local.new_zeros(1)])
    return y + (a.vals * halos[a.hidx]).sum(dim=1)


def _pdots(world: SolverWorld, *pairs) -> torch.Tensor:
    """The global dots u.v of ``pairs``, in one all-reduce."""
    partial = torch.stack([torch.dot(u, v) for u, v in pairs])
    dist.all_reduce(partial, group=world.group)
    return partial


def pcg_sharded(
    world: SolverWorld,
    a: ELLShard,
    b: torch.Tensor,  # this rank's rows of b, (rows_per_shard,)
    m_data: Any = None,
    apply_m: Callable = identity_local,
    mode: str = "allgather",
    rtol: float = 1e-8,
    max_iter: int = 1024,
    check_every: int = 64,
) -> CGResult:
    """Distributed PCG over the ranks of ``world``; returns this rank's
    rows of x with the (global) iteration count and squared relative
    residual.  ``apply_m(m_data, r_local)`` is this rank's apply."""
    if mode == "halo" and a.halo > a.rows_per_shard:
        raise ValueError(f"bandwidth {a.halo} exceeds the shard's "
                         f"{a.rows_per_shard} rows; use mode='allgather'")
    if a.n_shards != world.size or a.rank != world.rank:
        raise ValueError(f"shard {a.rank} of {a.n_shards} on rank "
                         f"{world.rank} of {world.size}")

    def matvec(x):
        return sharded_matvec(a, x, world, mode)

    x = torch.zeros_like(b)
    r = b - matvec(x)
    z = apply_m(m_data, r)
    p = z
    bb, rr = _pdots(world, (b, b), (r, r))
    bb = torch.where(bb == 0, torch.ones_like(bb), bb)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    k = torch.zeros((), dtype=torch.int32, device=b.device)
    done = rr / bb < rtol
    while not bool(done | (k >= max_iter)):  # one host read per chunk
        for _ in range(check_every):
            frozen = done | (k >= max_iter)
            ap = matvec(p)
            rz, denom = _pdots(world, (r, z), (ap, p))
            alpha = torch.where(frozen, zero, rz / denom)
            x = x + alpha * p
            r_new = torch.where(frozen, r, r - alpha * ap)
            z_new = torch.where(frozen, z, apply_m(m_data, r_new))
            rz_new, rr = _pdots(world, (r_new, z_new), (r_new, r_new))
            beta = torch.where(frozen, zero, rz_new / rz)
            p = torch.where(frozen, p, z_new + beta * p)
            k = torch.where(frozen, k, k + 1)
            done = done | (rr / bb < rtol)
            r, z = r_new, z_new
    (rr,) = _pdots(world, (r, r))
    return CGResult(x=x, iterations=k, residual=rr / bb)


def gather_vector(x_local: torch.Tensor, world: SolverWorld) -> torch.Tensor:
    """The global vector (n_total,) from every rank's rows, on every rank."""
    out = x_local.new_empty(x_local.shape[0] * world.size)
    dist.all_gather_into_tensor(out, x_local, group=world.group)
    return out
