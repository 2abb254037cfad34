"""Runner: the structured-grid multigrid solve, one right-hand side a
request.

Set-up makes the configuration's coefficient fields from the seed
(``inputs/poisson.py``, float64 on the card, the same fields and streams
as ``structured_learned``) and hands the port each operator as a float32
``DIAMatrix``.  Request k takes field k mod fields and a fresh right-hand
side drawn from the seed on the card (untimed), then runs the
``"gmg_jacobi"`` technique of the port's scaling run: ``build_gmg`` (span
``setup``: the Galerkin levels and the root's inverse), then
``preconditioned_conjugate_gradient`` with ``dia_matvec`` and
``gmg_apply``, x0 = 0 (span ``pcg``): one V(1,1) damped-Jacobi cycle an
apply, every operator product on every level through kernel B2, and on
the card the solve replayed from the solver's CUDA graphs.  Nothing
derived from values passes from one request to the next.

The check works out again, from the field alone, the hierarchy
(``reference/gmg.py``: the Galerkin operators by scatter-add, the root
inverted in float64) and compares each coarse level's bands below the
finest (``level_gap``: the largest entry error over the largest entry of
the reference's, the worst level), the root's inverse (``root_gap``, the
same), one V-cycle of the request's hierarchy on its right-hand side, the
solve's first residual, made by the port's ``gmg_apply`` after the
request's timed window (``cycle_gap``, the same, against the reference's
cycle in float64), the iterations of the solve against those of the
reference's PCG with its own cycle in float64 (``iters_gap``, how many
more or fewer), and the solution's squared relative residual of the raw
system in float64 (``true_resid``); every request's reported residual
must meet rtol.  The fault ``levels_stale`` solves field f with field
f + 1's coarse levels and root below f's finest level (its operator and
inverse diagonal), while the request hands the check the hierarchy it
built for f: what a graph replay that kept stale coarse-level tensors
would do.  Such a solve still converges, to rtol, but in other
iterations.

The cell measures the V-cycle replayed from the solver's CUDA graphs: a
port whose ``gmg_apply`` is not declared ``capture_safe`` would solve in
the eager loop, another configuration, so the cell refuses it at once,
before any field is made.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from deeppreconditioning_tpu_torch.ops.dia_spmv import dia_matvec
from deeppreconditioning_tpu_torch.ops.gmg import build_gmg, gmg_apply
from deeppreconditioning_tpu_torch.ops.structured_fsai import (
    dia_sorted_by_offset,
)
from deeppreconditioning_tpu_torch.solvers.cg import (
    preconditioned_conjugate_gradient,
)
from deeppreconditioning_tpu_torch.sparse.dia import DIAMatrix
from portbench.inputs.poisson import generate_fields
from portbench.reference import gmg as ref
from portbench.reference.pcg import squared_residual
from portbench.work.gmg import solve_work

FAULTS = ("answer_altered", "state_unchanged", "levels_stale")


def gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest entry error over the largest entry of ``want``."""
    return float((got.double() - want).abs().max() / want.abs().max())


class Cell:
    def __init__(self, config, traffic, seed, device, spans, fault=None):
        if not getattr(gmg_apply, "capture_safe", False):
            raise RuntimeError(
                "this port's gmg_apply is not declared capture_safe, so its "
                "PCG cannot replay the V-cycle from CUDA graphs")
        self.config, self.traffic, self.device = config, traffic, device
        self.spans, self.fault, self.seed = spans, fault, int(seed)
        self.rtol = float(config["rtol"])
        self.max_iter = int(config["max_iter"])
        self.check_every = int(traffic["check_every"])
        self.shape = tuple(int(s) for s in config["grid"])
        self.fields = generate_fields(seed, int(traffic["fields"]),
                                      self.shape, float(config["sigma"]),
                                      device)
        self.ops = [dia_sorted_by_offset(DIAMatrix(
            vals=f.vals.to(torch.float32),
            offsets=f.offsets, n=f.n)) for f in self.fields]
        self.gen = torch.Generator(device=device)

    def route(self):
        return None

    def _stale(self, f: int, m):
        """``m`` below its finest level replaced by field f + 1's."""
        other = build_gmg(self.ops[(f + 1) % len(self.ops)], self.shape)
        return replace(other, levels=(m.levels[0],) + other.levels[1:])

    @torch.no_grad()
    def _run(self, f: int, b: torch.Tensor):
        a = self.ops[f]
        with self.spans("setup"):
            m = build_gmg(a, self.shape)
        solved = self._stale(f, m) if self.fault == "levels_stale" else m
        with self.spans("pcg"):
            res = preconditioned_conjugate_gradient(
                dia_matvec, a, b, gmg_apply, solved, rtol=self.rtol,
                max_iter=self.max_iter, check_every=self.check_every)
        x = res.x
        if self.fault == "answer_altered":
            x = x.clone()
            x[x.shape[-1] // 4] += x.abs().max()
        elif self.fault == "state_unchanged":
            x = torch.zeros_like(x)
        return f, m, b, x, res.iterations, res.residual

    def _rhs(self, k: int, stream: int = 4) -> torch.Tensor:
        seed = int(np.random.default_rng([self.seed, stream, k]).integers(
            2**62))
        self.gen.manual_seed(seed)
        a = self.ops[0]
        b = torch.randn(a.n_pad, generator=self.gen, device=self.device)
        b[a.n:] = 0.0
        return b

    def warm(self) -> None:
        for f in range(len(self.ops)):
            self._run(f, self._rhs(f, stream=5))

    def prepare(self, k: int):
        return k % len(self.ops), self._rhs(k)

    def request(self, k: int, inputs):
        return self._run(*inputs)

    @torch.no_grad()
    def keep(self, k: int, outcome):
        """A sampled request's hierarchy, with one cycle of it made now on
        the right-hand side, and its solve."""
        f, m, b, x, iterations, residual = outcome
        coarse = tuple(lev.a.vals[:, :lev.a.n] for lev in m.levels[1:])
        return (f, coarse, m.coarse_inv, gmg_apply(m, b), b, x,
                int(iterations), residual)

    def summarize(self, outcome):
        f, *_, iterations, residual = outcome
        return f, iterations, residual

    def outcome(self, summary):
        f, iterations, residual = summary
        return (1, int(float(residual) < self.rtol), [int(iterations)],
                {"field": f})

    def work(self, record) -> dict:
        """Kernel B2's least work and the request's flops
        (``work/gmg.py``)."""
        return solve_work(self.shape, record.iterations[0])

    def release(self) -> None:
        self.ops = []

    @property
    def limits(self) -> dict:
        """The compared numbers' limits, from the mix."""
        return {name: float(v) for name, v in self.traffic["limits"].items()}

    def _reference(self, f: int, precision=None) -> ref.Hierarchy:
        fld = self.fields[f]
        return ref.build(fld.vals, fld.offsets, self.shape, precision)

    def _gaps(self, coarse, root_inv, h: ref.Hierarchy) -> dict:
        if len(coarse) != len(h.coarse):
            return {"level_gap": float("inf"), "root_gap": float("inf")}
        return {
            "level_gap": max(gap(got, want[:, :got.shape[1]])
                             for got, want in zip(coarse, h.coarse)),
            "root_gap": gap(root_inv, h.root_inv),
        }

    def _matvec(self, f: int):
        fld = self.fields[f]
        return lambda v: ref.matvec(fld.vals, fld.offsets, v)

    def check(self, kept: dict):
        refs, per_sample = {}, {}
        for k, (f, coarse, root_inv, z, b, x, iterations, reported) in sorted(
                kept.items()):
            if f not in refs:
                refs[f] = self._reference(f)
            h, a_mv, n = refs[f], self._matvec(f), self.fields[f].n
            _, want_iters = ref.solve(h, a_mv, b, self.rtol, self.max_iter)
            per_sample[k] = {
                **self._gaps(coarse, root_inv, h),
                "cycle_gap": gap(z[:n], ref.cycle(h, b.double())[:n]),
                "iters_gap": float(abs(iterations - want_iters)),
                "true_resid": float(squared_residual(a_mv, x, b)),
                "reported_resid": float(reported),
            }
        checks = [(name, max(v[name] for v in per_sample.values()), limit)
                  for name, limit in self.limits.items()]
        return checks, per_sample

    def control(self, kept: dict) -> dict:
        """The reference in bf16 in the program's place (its hierarchy, its
        cycle on each field's first sampled right-hand side, and its PCG
        solve of it with that cycle, every stored vector in bf16), judged
        as the program is."""
        out = dict.fromkeys(("level_gap", "root_gap", "cycle_gap",
                             "iters_gap", "true_resid"), 0.0)
        firsts = {}
        for k, (f, _, _, _, b, *_) in sorted(kept.items()):
            firsts.setdefault(f, b)
        for f, b in firsts.items():
            want, low = self._reference(f), self._reference(f, "bf16")
            a_mv, n = self._matvec(f), self.fields[f].n
            got = self._gaps(low.coarse, low.root_inv, want)
            got["cycle_gap"] = gap(ref.cycle(low, b.double(), "bf16")[:n],
                                   ref.cycle(want, b.double())[:n])
            _, want_iters = ref.solve(want, a_mv, b, self.rtol,
                                      self.max_iter)
            x, iters = ref.solve(low, a_mv, b, self.rtol, self.max_iter,
                                 "bf16")
            got["iters_gap"] = float(abs(iters - want_iters))
            got["true_resid"] = float(squared_residual(a_mv, x, b))
            for name, value in got.items():
                out[name] = max(out[name], value)
        return out
