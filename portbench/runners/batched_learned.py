"""Runner: the batched learned solve of a split of sludge cases, the whole
split a request.

The port has no public entry for this route, so this runner calls the
suite's (``BenchmarkSuite``): set-up stacks the cases as
``_batched_common`` and ``_batched_fsai_inputs`` stack them (dense scaled
A~, scales, b and n0 on the card; the plan groups).  A request runs what
``run_batched`` runs for the learned technique, once: the band-form
build of ``_banded_learned_setup`` (one B1 launch per chunk of a plan
group, bands first in bf16 with A~ rounded to bf16 for the apply's inner
product; span ``setup``), then ``batched_preconditioned_conjugate_gradient``
until every system converges (span ``pcg``); if one does not, the float32
rebuild and solve.  The route is the port's: the band form while the
split's band spread is at most ``banded_spread_cap``; this runner stops
with an error on a split that would take the dense M.  Nothing derived
from values passes from one request to the next.

The check works out again, from the raw cases and the weights alone,
every case's factor in band form (``reference/``), and compares the
bands (``bands_gap``: per case the largest entry error over the largest
entry of the reference's bands, the largest over the cases) and every
system's squared relative residual in float64 (``true_resid``).  q is the
checkpoint's q_coeffs in float32 in every case and every run, so it is
not compared (its gap, 1.65e-8, has no control reading above it).
"""

from __future__ import annotations

import torch

from deeppreconditioning_tpu_torch.bench.suite import (
    BenchmarkSuite,
    _learned_banded_setup_group,
    _scaled_dense_matvec,
    _scaled_dense_matvec_fast,
)
from deeppreconditioning_tpu_torch.ops.banded_factor import (
    band_spread,
    make_banded_poly_apply,
)
from deeppreconditioning_tpu_torch.ops.fsai import round_bf16
from deeppreconditioning_tpu_torch.solvers.cg import (
    batched_preconditioned_conjugate_gradient,
)
from portbench.runners.percase_learned import _Split, load_model
from portbench.harness.spec import BENCH_DIR
from portbench.inputs.fvm import generate_cases
from portbench.reference.fsai_pattern import split_patterns
from portbench.reference.msgpack import mlp_weights
from portbench.reference.neural_fsai import (
    band_form,
    dense_learned_m,
    learned_factor,
    rounder,
)
from portbench.reference.pcg import pcg, squared_residual
from portbench.work import NO_WORK, gauss_jordan_work, learned_case_flops

FAULTS = ("answer_altered", "state_unchanged", "half_batch")


class Cell:
    def __init__(self, config, traffic, seed, device, spans, fault=None):
        self.config, self.traffic, self.device = config, traffic, device
        self.spans, self.fault = spans, fault
        self.rtol = float(config["rtol"])
        self.max_iter = int(config["max_iter"])
        self.check_every = int(traffic["check_every"])
        self.chunk = int(traffic["chunk"])
        self.cases = generate_cases(seed, int(traffic["cases"]),
                                    int(config["mesh_cells"]))
        self.model, payload = load_model(BENCH_DIR / config["checkpoint"],
                                         device)
        self.weights = mlp_weights(payload)
        self.power = self.weights["power"]
        self.width, self.hidden = self.model.width, self.model.hidden
        self.degree = self.model.poly_degree
        self.n_pad = int(config["n_pad"])
        self.suite = BenchmarkSuite(
            data_set=_Split(self.cases, self.n_pad), model=self.model,
            techniques=("learned",), device=device,
            fsai_power=self.power, learned_power=self.power,
            rtol=self.rtol, max_iter=self.max_iter, kappa_cases=0)
        self.common = self.suite._batched_common()
        self.groups = self.suite._batched_fsai_inputs(self.power, self.width)
        self.spread = max(band_spread(p.out_rows.cpu().numpy(), self.n_pad)
                          for _, p, _, _ in self.groups)
        if self.spread > self.suite.banded_spread_cap:
            raise ValueError(
                f"band spread {self.spread} > {self.suite.banded_spread_cap}:"
                " the port takes the dense M, which this runner does not run")
        self.a_data = (self.common["a_tilde"], self.common["d_sqrt"])
        self.routes = {}
        self.pattern_nnz = None  # per case, set by ``check``

    def route(self) -> dict:
        """The requests that took each route, and the band spread."""
        return {"band_spread": self.spread, **self.routes}

    def _build(self, m_dtype):
        """``_banded_learned_setup``'s build: (bands, q, a_data)."""
        common, n_cases = self.common, len(self.cases)
        bands = torch.zeros(n_cases, self.spread, self.n_pad,
                            dtype=torch.float32, device=self.device)
        qs = torch.zeros(n_cases, self.degree + 1, dtype=torch.float32,
                         device=self.device)
        for sel, plans, ops in self.suite._group_chunks(self.groups,
                                                        self.chunk):
            bands[sel], qs[sel] = _learned_banded_setup_group(
                self.model, plans, ops, common["d_sqrt"][sel] ** 2,
                common["n0"][sel], self.spread, torch.float32)
        if m_dtype is None:
            return bands, qs, self.a_data
        return (bands.to(m_dtype), qs,
                (round_bf16(common["a_tilde"]), common["d_sqrt"]))

    @torch.no_grad()
    def _attempt(self, m_dtype):
        with self.spans("setup"):
            m_data = self._build(m_dtype)
        apply_fn = make_banded_poly_apply(
            _scaled_dense_matvec_fast if m_dtype is not None
            else _scaled_dense_matvec, self.degree)
        b = self.common["b"]
        with self.spans("pcg"):
            if self.fault == "half_batch":
                half = b.shape[0] // 2
                part = batched_preconditioned_conjugate_gradient(
                    _scaled_dense_matvec,
                    tuple(t[:half] for t in self.a_data), b[:half],
                    apply_fn, (m_data[0][:half], m_data[1][:half],
                               tuple(t[:half] for t in m_data[2])),
                    rtol=self.rtol, max_iter=self.max_iter,
                    check_every=self.check_every)
                fill = torch.arange(b.shape[0], device=b.device) % half
                res = part._replace(x=part.x[fill],
                                    iterations=part.iterations[fill],
                                    residual=part.residual[fill])
            else:
                res = batched_preconditioned_conjugate_gradient(
                    _scaled_dense_matvec, self.a_data, b, apply_fn, m_data,
                    rtol=self.rtol, max_iter=self.max_iter,
                    check_every=self.check_every)
        return m_data, res

    def _run(self):
        route = "bf16"
        m_data, res = self._attempt(torch.bfloat16)
        if not bool((res.residual < self.rtol).all()):
            route = "float32"
            m_data, res = self._attempt(None)
        x = res.x
        if self.fault == "answer_altered":
            x = x.clone()
            x[0, x.shape[-1] // 4] += x[0].abs().max()
        elif self.fault == "state_unchanged":
            x = torch.zeros_like(x)
        return m_data[0], m_data[1], x, res.iterations, res.residual, route

    def warm(self) -> None:
        self._run()
        with torch.no_grad():  # the retry's shapes too
            self._attempt(None)

    def prepare(self, k: int):
        return None

    def request(self, k: int, inputs):
        return self._run()

    def keep(self, k: int, outcome):
        bands, _, x, _, residual, route = outcome
        return bands, x, residual, route

    def summarize(self, outcome):
        _, _, _, iterations, residual, route = outcome
        return iterations, residual, route

    def outcome(self, summary):
        iterations, residual, route = summary
        self.routes[route] = self.routes.get(route, 0) + 1
        its = iterations.cpu().tolist()
        ok = int((residual < self.rtol).sum())
        return len(its), ok, its, {"route": route}

    def work(self, record) -> dict:
        """Kernel B1's least work and the request's flops, summed over
        the split as the per-case runner counts a case, each system for
        the iterations it took; reads the patterns the check worked
        out."""
        b1, flops = NO_WORK, 0
        for case, nnz_c, iters in zip(self.cases, self.pattern_nnz,
                                      record.iterations):
            b1 = b1 + gauss_jordan_work(case.n, self.width)
            flops += learned_case_flops(case.n, case.vals.shape[0], nnz_c,
                                        self.width, self.hidden,
                                        self.degree, iters)
        return {"b1": b1, "b2": NO_WORK, "flops": flops}

    def release(self) -> None:
        self.suite = self.common = self.groups = self.a_data = None
        self.model = None

    @property
    def limits(self) -> dict:
        """The compared numbers' limits, from the mix."""
        return {name: float(v) for name, v in self.traffic["limits"].items()}

    def _references(self, precision=None):
        patterns = split_patterns(self.cases, self.n_pad, self.power,
                                  self.width)
        self.pattern_nnz = [int((pc < c.n).sum())
                            for c, (_, pc) in zip(self.cases, patterns)]
        for case, pattern in zip(self.cases, patterns):
            c_eff, q = learned_factor(case, pattern, self.weights,
                                      self.device, precision)
            yield band_form(c_eff, self.spread, self.n_pad), q

    @staticmethod
    def _gap(got, ref) -> float:
        return float((got.double() - ref).abs().max() / ref.abs().max())

    def check(self, kept: dict):
        refs = list(self._references())
        per_sample = {}
        for k, (bands, x, reported, route) in sorted(kept.items()):
            worst = {"bands_gap": 0.0, "true_resid": 0.0}
            for i, (case, (b_ref, _)) in enumerate(zip(self.cases, refs)):
                n = case.n
                a = torch.as_tensor(case.csr().toarray(), device=self.device)
                rhs = torch.as_tensor(case.rhs, device=self.device)
                r = rhs - a @ x[i, :n].double()
                values = {
                    "bands_gap": self._gap(bands[i], b_ref),
                    "true_resid": float(torch.dot(r, r)
                                        / torch.dot(rhs, rhs)),
                }
                worst = {n_: max(worst[n_], v) for n_, v in values.items()}
            worst["reported_resid"] = float(reported.max())
            per_sample[k] = worst
        checks = [(name, max(v[name] for v in per_sample.values()), limit)
                  for name, limit in self.limits.items()]
        return checks, per_sample

    def control(self, kept: dict) -> dict:
        """The control's numbers: the reference's bands stored in fp8
        (the step below the bf16 the configuration states for them), and
        its PCG solve of every system in bf16 (the step below float32)
        with its M rounded to bf16, judged as the program is."""
        fp8, bf16 = rounder("fp8"), rounder("bf16")
        patterns = split_patterns(self.cases, self.n_pad, self.power,
                                  self.width)
        gap = 0.0
        n_cases = len(self.cases)
        a = torch.zeros(n_cases, self.n_pad, self.n_pad,
                        dtype=torch.float64, device=self.device)
        m = torch.zeros_like(a)
        b = torch.zeros(n_cases, self.n_pad, dtype=torch.float64,
                        device=self.device)
        for i, (case, pattern) in enumerate(zip(self.cases, patterns)):
            n = case.n
            c_eff, _ = learned_factor(case, pattern, self.weights,
                                      self.device)
            b_ref = band_form(c_eff, self.spread, self.n_pad)
            gap = max(gap, self._gap(fp8(b_ref), b_ref))
            a[i, :n, :n] = torch.as_tensor(case.csr().toarray(),
                                           device=self.device)
            a[i, n:, n:] = torch.eye(self.n_pad - n, dtype=torch.float64,
                                     device=self.device)
            m[i, :n, :n] = dense_learned_m(case, pattern, self.weights,
                                           self.device, "bf16")
            b[i, :n] = torch.as_tensor(case.rhs, device=self.device)

        def bmv(mat):
            return lambda v: (mat @ v[..., None])[..., 0]

        x = pcg(bmv(a), bmv(m), b, self.rtol, self.max_iter, bf16)
        return {"bands_gap": gap,
                "true_resid": float(squared_residual(bmv(a), x, b).max())}
