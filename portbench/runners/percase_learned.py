"""Runner: the per-case learned solve of sludge cases, one case a request.

Set-up makes the configuration's cases from the seed
(``inputs/fvm.py``) and prepares each as the port's suite prepares it
(``BenchmarkSuite._system`` and ``_fsai_plan``: the ELL operator, b, the
range or generic FSAI plan, its operand and the scales on the card).
Request k takes the next case of a seeded order and runs what the
suite's learned setup and solve run: ``neural_fsai_dense_preconditioner``
(span ``setup``), then ``preconditioned_conjugate_gradient`` with the ELL
operator and the dense M (span ``pcg``).  Nothing derived from values
passes from one request to the next.

The check takes the requests the seed samples and works out again, from
the raw case and the weights alone, the learned M (``reference/``); it
compares M on the live block (``m_gap``: the largest entry error over the
largest entry of the reference's M) and the solution's squared relative
residual on the raw system in float64 (``true_resid``).  The
configuration's tolerance bounds the residual the port's PCG reports,
which every request must meet; the true residual of a float32 solve
sits near it, on either side, so its limit is set from readings.
"""

from __future__ import annotations

import numpy as np
import torch

from deeppreconditioning_tpu_torch.bench.suite import BenchmarkSuite
from deeppreconditioning_tpu_torch.data.datasets import _prepare_sample
from deeppreconditioning_tpu_torch.models.neural_fsai import (
    NeuralFSAI,
    neural_fsai_dense_preconditioner,
    params_from_jax,
)
from deeppreconditioning_tpu_torch.solvers.cg import (
    dense_matvec,
    ell_matvec,
    preconditioned_conjugate_gradient,
)
from portbench.harness.spec import BENCH_DIR
from portbench.inputs.fvm import generate_cases
from portbench.reference.fsai_pattern import split_patterns
from portbench.reference.msgpack import load_checkpoint, mlp_weights
from portbench.reference.neural_fsai import dense_learned_m, rounder
from portbench.reference.pcg import pcg, squared_residual
from portbench.work import NO_WORK, gauss_jordan_work, learned_case_flops

FAULTS = ("answer_altered", "state_unchanged")


class _Split:
    """The suite's view of the cell's cases: ``len``, ``host_sample`` and
    ``dof_pad``."""

    def __init__(self, cases, n_pad: int):
        if max(c.n for c in cases) > n_pad:
            raise ValueError(f"a case is larger than n_pad {n_pad}")
        self.dof_pad = n_pad
        self._host = [_prepare_sample(c.rows, c.cols, c.vals,
                                      np.zeros(c.n), c.rhs, n_pad)
                      for c in cases]

    def __len__(self) -> int:
        return len(self._host)

    def host_sample(self, index: int):
        return self._host[index]


def load_model(path, device) -> tuple:
    payload = load_checkpoint(path)
    model = NeuralFSAI(int(payload["width"]), int(payload["hidden"]),
                       int(payload["poly_degree"]))
    model.load_state_dict(params_from_jax(payload["params"]))
    return model.to(device=device, dtype=torch.float32).eval(), payload


class Cell:
    def __init__(self, config, traffic, seed, device, spans, fault=None):
        self.config, self.traffic, self.device = config, traffic, device
        self.spans, self.fault = spans, fault
        self.rtol = float(config["rtol"])
        self.max_iter = int(config["max_iter"])
        self.check_every = int(traffic["check_every"])
        self.cases = generate_cases(seed, int(traffic["cases"]),
                                    int(config["mesh_cells"]))
        self.model, payload = load_model(
            BENCH_DIR / config["checkpoint"], device)
        self.weights = mlp_weights(payload)
        self.power = self.weights["power"]
        self.width, self.hidden = self.model.width, self.model.hidden
        self.degree = self.model.poly_degree
        self.pattern_nnz = None  # per case, set by ``check``
        split = _Split(self.cases, int(config["n_pad"]))
        suite = BenchmarkSuite(
            data_set=split, model=self.model, techniques=("learned",),
            device=device, fsai_power=self.power, learned_power=self.power,
            rtol=self.rtol, max_iter=self.max_iter,
            check_every=self.check_every, kappa_cases=0)
        self.prepared = []
        for i in range(len(self.cases)):
            a_sp, ell, b = suite._system(i)
            kind, plan, operand, scales = suite._fsai_plan(
                i, ell, width=self.width, power=self.power)
            self.prepared.append((ell, b, kind, plan, operand, scales,
                                  a_sp.shape[0]))
        kinds = [p[2] for p in self.prepared]
        self._route = {"generic_cases": kinds.count("generic"),
                       "range_cases": kinds.count("range")}
        self.order_rng = np.random.default_rng([int(seed), 2])
        self.order = []

    def route(self) -> dict:
        """How many cases took the range plan and the generic one."""
        return self._route

    @torch.no_grad()
    def _run(self, index: int):
        ell, b, _, plan, operand, scales, n0 = self.prepared[index]
        with self.spans("setup"):
            m = neural_fsai_dense_preconditioner(
                self.model, plan, operand, scales, n0, dtype=torch.float32)
        with self.spans("pcg"):
            res = preconditioned_conjugate_gradient(
                ell_matvec, ell, b, dense_matvec, m, rtol=self.rtol,
                max_iter=self.max_iter, check_every=self.check_every)
        x = res.x
        if self.fault == "answer_altered":
            x = x.clone()
            x[x.shape[-1] // 4] += x.abs().max()
        elif self.fault == "state_unchanged":
            x = torch.zeros_like(x)
        return index, m, x, res.iterations, res.residual

    def warm(self) -> None:
        """Every case once: both plan kinds and every shape the window
        uses."""
        for i in range(len(self.prepared)):
            self._run(i)

    def prepare(self, k: int) -> int:
        if not self.order:
            self.order = self.order_rng.permutation(len(self.cases)).tolist()
        return self.order.pop(0)

    def request(self, k: int, index: int):
        return self._run(index)

    def keep(self, k: int, outcome):
        index, m, x, _, residual = outcome
        return index, m, x, residual

    def summarize(self, outcome):
        """What the loop holds of a request once it has ended: no M, no
        x."""
        index, _, _, iterations, residual = outcome
        return index, iterations, residual

    def outcome(self, summary):
        """(systems, systems converged, iterations, what ``work`` reads)."""
        index, iterations, residual = summary
        return (1, int(float(residual) < self.rtol), [int(iterations)],
                {"case": index})

    def work(self, record) -> dict:
        """Kernel B1's least work on the case's n0 columns and the
        request's flops (``work.learned_case_flops``); reads the patterns
        the check worked out."""
        case = self.cases[record.info["case"]]
        return {"b1": gauss_jordan_work(case.n, self.width), "b2": NO_WORK,
                "flops": learned_case_flops(
                    case.n, case.vals.shape[0],
                    self.pattern_nnz[record.info["case"]], self.width,
                    self.hidden, self.degree, record.iterations[0])}

    def release(self) -> None:
        self.prepared = []
        self.model = None

    @property
    def limits(self) -> dict:
        """The compared numbers' limits, from the mix."""
        return {name: float(v) for name, v in self.traffic["limits"].items()}

    def check(self, kept: dict):
        """(checks, per sample values): the largest of each number over
        the samples, beside its limit."""
        patterns = split_patterns(self.cases, int(self.config["n_pad"]),
                                  self.power, self.width)
        self.pattern_nnz = [int((pc < c.n).sum())
                            for c, (_, pc) in zip(self.cases, patterns)]
        per_sample = {}
        for k, (index, m, x, reported) in sorted(kept.items()):
            case = self.cases[index]
            n = case.n
            m_ref = dense_learned_m(case, patterns[index], self.weights,
                                    self.device)
            m_prog = m[:n, :n].double()
            gap = float((m_prog - m_ref).abs().max()
                        / m_ref.abs().max())
            a = torch.as_tensor(case.csr().toarray(), device=self.device)
            b = torch.as_tensor(case.rhs, device=self.device)
            r = b - a @ x[:n].double()
            resid = float(torch.dot(r, r) / torch.dot(b, b))
            per_sample[k] = {"m_gap": gap, "true_resid": resid,
                             "reported_resid": float(reported)}
        checks = [(name, max(v[name] for v in per_sample.values()), limit)
                  for name, limit in self.limits.items()]
        return checks, per_sample

    def control(self, kept: dict) -> dict:
        """The control's numbers: the reference in bf16 in the program's
        place (its M, and its PCG solve with that M), judged as the
        program is (the largest over the samples)."""
        patterns = split_patterns(self.cases, int(self.config["n_pad"]),
                                  self.power, self.width)
        bf16 = rounder("bf16")
        out = {"m_gap": 0.0, "true_resid": 0.0}
        for k, (index, *_) in sorted(kept.items()):
            case = self.cases[index]
            m_ref = dense_learned_m(case, patterns[index], self.weights,
                                    self.device)
            m_low = dense_learned_m(case, patterns[index], self.weights,
                                    self.device, "bf16")
            a = torch.as_tensor(case.csr().toarray(), device=self.device)
            b = torch.as_tensor(case.rhs, device=self.device)[None]
            x = pcg(lambda v: v @ a, lambda v: v @ m_low, b, self.rtol,
                    self.max_iter, bf16)
            out["m_gap"] = max(out["m_gap"], float(
                (m_low - m_ref).abs().max() / m_ref.abs().max()))
            out["true_resid"] = max(out["true_resid"], float(
                squared_residual(lambda v: v @ a, x, b).max()))
        return out
