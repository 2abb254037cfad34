"""Runner: the structured-grid learned solve over sequences of right-hand
sides, one right-hand side a request.

Request k solves right-hand side k mod L of sequence k // L (L the mix's
``sequence``, 8).  A sequence starts from the configuration's base
right-hand side and random-walks from it: b_0 = base, b_t = b_{t-1} +
step * noise on the n rows (``bench/scaling.rhs_sequence``'s walk, step
0.1), the noise drawn from the seed on the card, untimed, in
``prepare``.  x0 = 0 in every request.  Every solve is the ``"learned"``
technique of the port's scaling run: ``structured_setup`` and
``bands_to_dia`` (span ``setup``), then
``preconditioned_conjugate_gradient`` with ``dia_matvec`` and
``make_structured_poly_apply_dia`` (span ``pcg``), so every operator and
factor product goes through kernel B2; the structured plan is built from
the operator's own band offsets (its stencil).

Two shapes of the loop, by the configuration's ``operator``:

* ``"hpcg"``: HPCG's 27-point operator (``reference/hpcg.py``, on the
  card) and its base b = A 1.  The one operator is set up once in the
  cell's set-up, and its graphs are captured in warm-up; a request is one
  solve.  This is HPCG's own shape: the setup untimed, the CG timed.
* otherwise: the configuration's lognormal Poisson fields
  (``inputs/poisson.py``, the mix's ``fields`` of them); sequence s runs
  on field s mod fields from a fresh seeded base (as ``fields8-rhs``
  draws one).  The request that starts a sequence runs that field's setup
  inside its timed request; the other L - 1 reuse it.

Nothing derived from values passes from one sequence to the next.

The check is ``structured_learned``'s: per operator or field in the
sample, the factor's bands (``bands_gap``) and q (``q_gap``) against the
float64 reference's setup, and per sampled request the solution's
squared relative residual of the raw system in float64
(``true_resid``); every request's reported residual must meet rtol.
"""

from __future__ import annotations

import numpy as np
import torch

from deeppreconditioning_tpu_torch.ops.dia_spmv import dia_matvec
from deeppreconditioning_tpu_torch.ops.structured_fsai import (
    bands_to_dia,
    build_structured_plan,
    dia_sorted_by_offset,
    make_structured_poly_apply_dia,
    structured_setup,
)
from deeppreconditioning_tpu_torch.solvers.cg import (
    preconditioned_conjugate_gradient,
)
from deeppreconditioning_tpu_torch.sparse.dia import DIAMatrix
from portbench.harness.spec import BENCH_DIR
from portbench.inputs.poisson import generate_fields
from portbench.reference.hpcg import box_slots, hpcg_bands, learned_setup
from portbench.reference.msgpack import mlp_weights
from portbench.reference.neural_fsai import rounder
from portbench.reference.pcg import pcg, squared_residual
from portbench.reference.structured import (
    Bands,
    dia_matvec64,
    poly_apply,
    stencil_slots,
)
from portbench.runners.percase_learned import load_model
from portbench.work import (
    NO_WORK,
    KernelWork,
    dia_work,
    gauss_jordan_work,
    mlp_flops,
    pcg_vector_flops,
)

FAULTS = ("answer_altered", "state_unchanged")


class Cell:
    def __init__(self, config, traffic, seed, device, spans, fault=None):
        self.config, self.traffic, self.device = config, traffic, device
        self.spans, self.fault, self.seed = spans, fault, int(seed)
        self.rtol = float(config["rtol"])
        self.max_iter = int(config["max_iter"])
        self.check_every = int(traffic["check_every"])
        self.length = int(traffic["sequence"])
        self.step = float(traffic["rhs_step"])
        self.shape = tuple(int(s) for s in config["grid"])
        self.hpcg = config.get("operator") == "hpcg"
        self.model, payload = load_model(BENCH_DIR / config["checkpoint"],
                                         device)
        self.weights = mlp_weights(payload)
        self.width, self.hidden = self.model.width, self.model.hidden
        self.degree = self.model.poly_degree
        if self.hpcg:
            vals, offsets = hpcg_bands(self.shape, device)
            self.fields = None
            self.ops = [DIAMatrix(vals=vals.to(torch.float32),
                                  offsets=offsets,
                                  n=int(np.prod(self.shape)))]
            self.base = Bands(vals, offsets).matvec(
                self._ones(vals.shape[1])).to(torch.float32)
            del vals
        else:
            self.fields = generate_fields(seed, int(traffic["fields"]),
                                          self.shape,
                                          float(config["sigma"]), device)
            self.ops = [dia_sorted_by_offset(DIAMatrix(
                vals=f.vals.to(torch.float32), offsets=f.offsets, n=f.n))
                for f in self.fields]
        a = self.ops[0]
        self.n, self.n_pad = a.n, a.n_pad
        self.operator_bands = len(a.offsets)
        self.plan = build_structured_plan(self.shape,
                                          power=self.weights["power"],
                                          a_offsets=a.offsets)
        if self.plan.width != self.width:
            raise ValueError("the plan's width is not the model's")
        self.apply = make_structured_poly_apply_dia(self.degree)
        self.gen = torch.Generator(device=device)
        self.current = None  # (field, bands, q, c_up, c_low)
        self.rhs = None  # the sequence's last right-hand side
        self.setup_peak = None

    def _ones(self, n_pad: int) -> torch.Tensor:
        x = torch.zeros(n_pad, dtype=torch.float64, device=self.device)
        x[:int(np.prod(self.shape))] = 1.0
        return x

    def route(self):
        """The set-up's peak of device memory (the one HPCG setup's)."""
        return {"setup_peak_bytes": self.setup_peak}

    def _draw(self, stream: int, k: int) -> torch.Tensor:
        seed = int(np.random.default_rng([self.seed, stream, k]).integers(
            2**62))
        self.gen.manual_seed(seed)
        out = torch.randn(self.n_pad, generator=self.gen,
                          device=self.device)
        out[self.n:] = 0.0
        return out

    def _next_rhs(self, k: int, stream: int) -> torch.Tensor:
        """Right-hand side k mod L of sequence k // L (stream 4 the
        window's, 5 the warm-up's)."""
        if k % self.length == 0:
            if self.hpcg:
                self.rhs = self.base.clone()
            else:
                self.rhs = self._draw(stream, k // self.length)
        else:
            self.rhs = self.rhs + self.step * self._draw(stream + 4, k)
        return self.rhs

    def _setup(self, f: int):
        a = self.ops[f]
        bands, q = structured_setup(a, self.plan, self.model)
        c_up, c_low = bands_to_dia(bands, self.plan.offsets, a.n)
        self.current = (f, bands, q, c_up, c_low)

    @torch.no_grad()
    def _run(self, f: int, b: torch.Tensor, start: bool):
        if start and not self.hpcg:
            with self.spans("setup"):
                self._setup(f)
        _, bands, q, c_up, c_low = self.current
        a = self.ops[f]
        with self.spans("pcg"):
            res = preconditioned_conjugate_gradient(
                dia_matvec, a, b, self.apply, (c_up, c_low, q, a),
                rtol=self.rtol, max_iter=self.max_iter,
                check_every=self.check_every)
        x = res.x
        if self.fault == "answer_altered":
            x = x.clone()
            x[x.shape[-1] // 4] += x.abs().max()
        elif self.fault == "state_unchanged":
            x = torch.zeros_like(x)
        return f, start, bands, q, b, x, res.iterations, res.residual

    def _field(self, k: int) -> int:
        return (k // self.length) % len(self.ops)

    @torch.no_grad()
    def warm(self) -> None:
        if self.hpcg:
            if self.device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(self.device)
            self._setup(0)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
                self.setup_peak = torch.cuda.max_memory_allocated(
                    self.device)
            for k in range(2):
                self._run(0, self._next_rhs(k, stream=5), False)
        else:
            for f in range(len(self.ops)):
                k = f * self.length
                self._run(f, self._next_rhs(k, stream=5), True)
                self._run(f, self._next_rhs(k + 1, stream=5), False)
        self.rhs = None

    def prepare(self, k: int):
        return self._field(k), self._next_rhs(k, stream=4), (
            k % self.length == 0)

    def request(self, k: int, inputs):
        return self._run(*inputs)

    def keep(self, k: int, outcome):
        f, _, bands, q, b, x, _, residual = outcome
        return f, bands, q, b, x, residual

    def summarize(self, outcome):
        f, start, _, _, _, _, iterations, residual = outcome
        return f, start and not self.hpcg, iterations, residual

    def outcome(self, summary):
        f, setup, iterations, residual = summary
        return (1, int(float(residual) < self.rtol), [int(iterations)],
                {"field": f, "setup": setup})

    def _b2_products(self, iters: int, setup: bool) -> list:
        """(bands, count) of the DIA products a request needs: with a
        setup, the safeguard's 9 products of B = C^T A C; then the start
        and each iteration's operator product and preconditioner apply
        (C^T, 2d products of B, C)."""
        w, a_bands = self.width, self.operator_bands
        b_apply = [(w, 1), (a_bands, 1), (w, 1)]
        safeguard = ([(nb, 9 * c) for nb, c in b_apply]
                     if setup and self.degree else [])
        per_apply = [(w, 2)] + [(nb, 2 * self.degree * c)
                                for nb, c in b_apply]
        per_iter = [(a_bands, 1)] + per_apply
        return safeguard + [(nb, (iters + 1) * c) for nb, c in per_iter]

    def operator_work(self):
        """The least work of one product with the operator (kernel B2)."""
        return dia_work(self.operator_bands, self.n_pad)

    def work(self, record) -> dict:
        """Kernel B1's and B2's least work and the request's flops: with a
        setup, the local solves and the MLP of every column; the DIA
        products; the vector updates of the start and each iteration."""
        iters, setup = record.iterations[0], record.info["setup"]
        b1 = gauss_jordan_work(self.n, self.width) if setup else NO_WORK
        b2 = NO_WORK
        for bands, count in self._b2_products(iters, setup):
            one = dia_work(bands, self.n_pad)
            b2 = b2 + KernelWork(one.bytes * count, one.flops * count)
        flops = (b1.flops + b2.flops + (iters + 1) * pcg_vector_flops(self.n)
                 + (mlp_flops(self.n, self.width, self.hidden)
                    if setup else 0))
        return {"b1": b1, "b2": b2, "flops": flops}

    def release(self) -> None:
        self.ops, self.current, self.rhs = [], None, None
        self.model = self.base = None

    @property
    def limits(self) -> dict:
        """The compared numbers' limits, from the mix."""
        return {name: float(v) for name, v in self.traffic["limits"].items()}

    def _raw(self, f: int):
        """(float64 values, offsets) of operator or field ``f``."""
        if self.hpcg:
            return hpcg_bands(self.shape, self.device)
        return self.fields[f].vals, self.fields[f].offsets

    def _slots(self):
        power = self.weights["power"]
        return (box_slots(self.shape, power) if self.hpcg
                else stencil_slots(self.shape, power))

    def _reference(self, f: int, precision=None):
        vals, offsets = self._raw(f)
        return learned_setup(vals, offsets, self.shape, self._slots(),
                             self.weights, self.device, precision)

    def check(self, kept: dict):
        refs, per_sample = {}, {}
        for k, (f, bands, q, b, x, reported) in sorted(kept.items()):
            if f not in refs:
                refs[f] = self._reference(f)
            bands_ref, q_ref = refs[f]
            vals, offsets = self._raw(f)
            r = b.double() - dia_matvec64(vals, offsets, x)
            del vals
            bb = b.double()
            per_sample[k] = {
                "bands_gap": float((bands.double() - bands_ref).abs().max()
                                   / bands_ref.abs().max()),
                "q_gap": float((q.double() - q_ref).abs().max()
                               / q_ref.abs().max()),
                "true_resid": float(torch.dot(r, r) / torch.dot(bb, bb)),
                "reported_resid": float(reported),
            }
        checks = [(name, max(v[name] for v in per_sample.values()), limit)
                  for name, limit in self.limits.items()]
        return checks, per_sample

    def control(self, kept: dict) -> dict:
        """The reference in bf16 in the program's place (its factor, and
        its PCG solve of each operator's first sampled right-hand side
        with that factor), judged as the program is."""
        bf16 = rounder("bf16")
        out = {"bands_gap": 0.0, "q_gap": 0.0, "true_resid": 0.0}
        firsts = {}
        for k, (f, _, _, b, *_) in sorted(kept.items()):
            firsts.setdefault(f, b)
        for f, b in firsts.items():
            bands_ref, q_ref = self._reference(f)
            bands_low, q_low = self._reference(f, "bf16")
            out["bands_gap"] = max(out["bands_gap"], float(
                (bands_low - bands_ref).abs().max() / bands_ref.abs().max()))
            out["q_gap"] = max(out["q_gap"], float(
                (q_low - q_ref).abs().max() / q_ref.abs().max()))
            a = Bands(*self._raw(f))
            offsets = self._slots()[0]
            x = pcg(a.matvec, lambda r: poly_apply(
                bands_low, offsets, q_low, a.matvec, r), b.double(),
                self.rtol, self.max_iter, bf16)
            out["true_resid"] = max(out["true_resid"], float(
                squared_residual(a.matvec, x, b)))
        return out
