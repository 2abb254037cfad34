"""Runner: the structured-grid learned solve, one right-hand side a
request.

Set-up makes the configuration's coefficient fields from the seed
(``inputs/poisson.py``, float64 on the card), hands the port each
operator as a float32 ``DIAMatrix`` and builds the structured plan
once.  Request k takes field
k mod fields and a fresh right-hand side drawn from the seed on the card
(untimed), then runs the ``"learned"`` builder of the port's scaling run:
``structured_setup`` and ``bands_to_dia`` (span ``setup``), then
``preconditioned_conjugate_gradient`` with ``dia_matvec`` and
``make_structured_poly_apply_dia`` (span ``pcg``): every operator product
goes through kernel B2.  Nothing derived from values passes from one
request to the next.

The check works out again, from the field and the weights alone, the
factor's bands and q (``reference/structured.py``), and compares the
bands (``bands_gap``: the largest entry error over the largest entry of
the reference's), q (``q_gap``, the same over q) and the solution's
squared relative residual in float64 (``true_resid``; the configuration's
tolerance bounds the residual the port's PCG reports, which every request
must meet, and the true residual of a float32 solve sits near it on
either side, so its limit is set from readings).
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
from portbench.runners.percase_learned import load_model
from portbench.harness.spec import BENCH_DIR
from portbench.inputs.poisson import generate_fields
from portbench.reference.msgpack import mlp_weights
from portbench.reference.neural_fsai import rounder
from portbench.reference.pcg import pcg, squared_residual
from portbench.reference.structured import (
    Bands,
    dia_matvec64,
    poly_apply,
    stencil_slots,
    structured_learned,
)
from portbench.work import (
    NO_WORK,
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
        self.shape = tuple(int(s) for s in config["grid"])
        self.fields = generate_fields(seed, int(traffic["fields"]),
                                      self.shape, float(config["sigma"]),
                                      device)
        self.model, payload = load_model(BENCH_DIR / config["checkpoint"],
                                         device)
        self.weights = mlp_weights(payload)
        self.width, self.hidden = self.model.width, self.model.hidden
        self.degree = self.model.poly_degree
        self.ops = [dia_sorted_by_offset(DIAMatrix(
            vals=f.vals.to(torch.float32),
            offsets=f.offsets, n=f.n)) for f in self.fields]
        self.plan = build_structured_plan(self.shape,
                                          power=self.weights["power"])
        if self.plan.width != self.width:
            raise ValueError("the plan's width is not the model's")
        self.apply = make_structured_poly_apply_dia(self.degree)
        self.gen = torch.Generator(device=device)

    def route(self):
        return None

    @torch.no_grad()
    def _run(self, f: int, b: torch.Tensor):
        a = self.ops[f]
        with self.spans("setup"):
            bands, q = structured_setup(a, self.plan, self.model)
            c_up, c_low = bands_to_dia(bands, self.plan.offsets, a.n)
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
        return f, bands, q, b, x, res.iterations, res.residual

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

    def keep(self, k: int, outcome):
        f, bands, q, b, x, _, residual = outcome
        return f, bands, q, b, x, residual

    def summarize(self, outcome):
        f, _, _, _, _, iterations, residual = outcome
        return f, iterations, residual

    def outcome(self, summary):
        f, iterations, residual = summary
        return (1, int(float(residual) < self.rtol), [int(iterations)],
                {"field": f})

    def _b2_products(self, iters: int) -> list:
        """(bands, count) of the DIA products a request needs: the
        safeguard's 9 products of B = C^T A C, then the start and each
        iteration's operator product and preconditioner apply (C^T, 2d
        products of B, C)."""
        w, a_bands = self.width, len(self.fields[0].offsets)
        b_apply = [(w, 1), (a_bands, 1), (w, 1)]
        safeguard = [(nb, 9 * c) for nb, c in b_apply] if self.degree else []
        per_apply = [(w, 2)] + [(nb, 2 * self.degree * c)
                                for nb, c in b_apply]
        per_iter = [(a_bands, 1)] + per_apply
        return safeguard + [(nb, (iters + 1) * c) for nb, c in per_iter]

    def work(self, record) -> dict:
        """Kernel B1's and B2's least work and the request's flops: the
        local solves and the MLP of every column, the DIA products, and
        the vector updates of the start and each iteration."""
        n, n_pad = self.fields[0].n, self.fields[0].n_pad
        iters = record.iterations[0]
        b1 = gauss_jordan_work(n, self.width)
        b2 = NO_WORK
        for bands, count in self._b2_products(iters):
            for _ in range(count):
                b2 = b2 + dia_work(bands, n_pad)
        flops = (b1.flops + mlp_flops(n, self.width, self.hidden)
                 + b2.flops + (iters + 1) * pcg_vector_flops(n))
        return {"b1": b1, "b2": b2, "flops": flops}

    def release(self) -> None:
        self.ops = []
        self.model = None

    @property
    def limits(self) -> dict:
        """The compared numbers' limits, from the mix."""
        return {name: float(v) for name, v in self.traffic["limits"].items()}

    def _reference(self, f: int, precision=None):
        fld = self.fields[f]
        return structured_learned(fld.vals, fld.offsets, self.shape,
                                  self.weights, self.device, precision)

    def check(self, kept: dict):
        refs, per_sample = {}, {}
        for k, (f, bands, q, b, x, reported) in sorted(kept.items()):
            if f not in refs:
                refs[f] = self._reference(f)
            bands_ref, q_ref = refs[f]
            fld = self.fields[f]
            r = b.double() - dia_matvec64(fld.vals, fld.offsets, x)
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
        its PCG solve of each field's first sampled right-hand side with
        that factor), judged as the program is."""
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
            fld = self.fields[f]
            a = Bands(fld.vals, fld.offsets)
            offsets = stencil_slots(self.shape, self.weights["power"])[0]
            x = pcg(a.matvec, lambda r: poly_apply(
                bands_low, offsets, q_low, a.matvec, r), b.double(),
                self.rtol, self.max_iter, bf16)
            out["true_resid"] = max(out["true_resid"], float(
                squared_residual(a.matvec, x, b)))
        return out
