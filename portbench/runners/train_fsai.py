"""Runner: NeuralFSAI training steps with ``pcg_loss``, one step a request.

Set-up makes the mix's cases from the seed (``inputs/fvm.py``) and
serves them as the trainer does: a ``PlannedDataSet`` of the train split
(batches of 4, shuffled once from the seed, n_pad from the
configuration) and an ``FSAIPlanProvider`` whose plans for every batch
are built in set-up.  The weights are made from the seed on the device
(every leaf drawn, so every leaf has a gradient at step 1), the
optimizer is the trainer's ``adam(model, lr)``.  Set-up then drives this
one model and optimizer through the first three steps by the window's
own call (``fsai_train_step(..., loss="pcg_loss", pcg_steps=16)`` on the
batch's operands as the trainer's step function takes them), keeps their
losses, the optimizer's first moments after step 1 and the parameters
before step 1 and after step 3, and hands the same objects to the
window, which steps on over the batches, epoch after epoch (span
``step``).

The check runs the reference's three steps (``reference/train_step.py``)
from the same weights on the same batches and compares, by the worst
leaf: each step's loss (``loss_gap``, relative), the norm of the first
gradient as Adam holds it (exp_avg / (1 - beta1); ``grad_gap``) and the
norm of the parameters' change over the three steps (``delta_gap``),
each gap of norms taken against the larger of the leaf's reference norm
and the median leaf's.  Leaves whose reference gradient is under a
thousandth of the median leaf's are left out of both.
"""

from __future__ import annotations

import numpy as np
import torch

from deeppreconditioning_tpu_torch.data.datasets import PlannedDataSet
from deeppreconditioning_tpu_torch.models.neural_fsai import (
    FSAIPlanProvider,
    NeuralFSAI,
)
from deeppreconditioning_tpu_torch.ops.fsai import take_cases
from deeppreconditioning_tpu_torch.train.trainer import adam, fsai_train_step
from portbench.inputs.fvm import generate_cases
from portbench.reference.train_step import train_steps
from portbench.work import (
    NO_WORK,
    gauss_jordan_work,
    learned_apply_flops,
    mlp_flops,
    pcg_vector_flops,
)

FAULTS = ("state_unchanged", "half_batch")
CHECKED_STEPS = 3


def make_weights(model: NeuralFSAI, seed: int, device) -> dict:
    """Every leaf drawn from the seed on the device, in a few calls: the
    hidden layers at 1 / sqrt(fan_in), the heads at a hundredth of that,
    biases and q_coeffs at 0.01."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.default_rng([int(seed), 6]).integers(
        2**62)))
    state = {}
    for name, t in model.state_dict().items():
        draw = torch.randn(t.shape, generator=gen, device=device)
        if name.endswith("weight"):
            scale = t.shape[1] ** -0.5
            if name.split(".")[0] in ("alpha", "beta"):
                scale *= 0.01
        else:
            scale = 0.01
        state[name] = draw * scale
    return state


class Cell:
    def __init__(self, config, traffic, seed, device, spans, fault=None):
        self.config, self.traffic, self.device = config, traffic, device
        self.spans, self.fault = spans, fault
        self.pcg_steps = int(traffic["pcg_steps"])
        self.lr = float(traffic["learning_rate"])
        self.batch = int(config["batch_size"])
        self.n_pad = int(config["n_pad"])
        self.width, self.hidden = int(config["fsai_width"]), int(
            config["hidden"])
        self.degree, self.power = int(config["poly_degree"]), int(
            config["fsai_power"])
        # the train split is the first 80% of the cases made
        made = generate_cases(seed, int(traffic["cases"]) * 5 // 4,
                              int(config["mesh_cells"]))
        raw = [(c.rows, c.cols, c.vals, np.zeros(c.n), c.rhs) for c in made]
        ds = PlannedDataSet.__new__(PlannedDataSet)
        order = list(range(int(traffic["cases"])))
        np.random.default_rng([int(seed), 7]).shuffle(order)
        ds.order = order
        ds.items = [made[i] for i in order]
        ds._finalize([raw[i] for i in order], self.n_pad, self.batch, None,
                     device, torch.float32)
        self.data, self.cases = ds, ds.items
        self.provider = FSAIPlanProvider(ds, power=self.power,
                                         width=self.width)
        self.plans = [self.provider(i, ds[i]) for i in range(len(ds))]
        self.plan_kind = self.provider.kind
        self.model = NeuralFSAI(self.width, self.hidden, self.degree).to(
            device)
        self.init = make_weights(self.model, seed, device)
        self.model.load_state_dict(self.init)
        self.optimizer = adam(self.model, self.lr)
        self.next_batch = 0
        self.first = {}
        self.left_out = None  # set by ``check``

    def route(self) -> dict:
        """The plan kind, and how many leaves the check left out."""
        return {"plan_kind": self.plan_kind,
                "leaves_left_out": self.left_out}

    def _step(self, index: int):
        batch, plans = self.data[index], self.plans[index]
        feats = batch.features[:, :, 0]
        a_tril = batch.systems.to_dense()
        rhs = batch.right_hand_sides
        if self.fault == "half_batch":
            half = feats.shape[0] // 2
            plans = take_cases(plans, slice(0, half))
            feats, a_tril, rhs = feats[:half], a_tril[:half], rhs[:half]
        if self.fault == "state_unchanged":
            saved = {k: v.clone() for k, v in
                     self.model.state_dict().items()}
        with self.spans("step"):
            loss = fsai_train_step(self.model, self.optimizer, plans, feats,
                                   a_tril, rhs, loss="pcg_loss",
                                   pcg_steps=self.pcg_steps)
        if self.fault == "state_unchanged":
            self.model.load_state_dict(saved)
        return index, loss

    def _first_steps(self) -> None:
        """The checked steps, through the window's own call."""
        losses = []
        for index in range(CHECKED_STEPS):
            losses.append(self._step(index)[1])
            if index == 0:
                self.first["exp_avg"] = {
                    name: self.optimizer.state[p]["exp_avg"].detach().clone()
                    for name, p in self.model.named_parameters()}
        self.first["losses"] = [float(v) for v in losses]
        self.first["params"] = {k: v.detach().clone()
                                for k, v in self.model.state_dict().items()}
        self.next_batch = CHECKED_STEPS

    def warm(self) -> None:
        self._first_steps()
        for index in range(CHECKED_STEPS, len(self.data)):
            self._step(index)  # every batch's shapes and plans
        self.next_batch = 0

    def prepare(self, k: int) -> int:
        index = self.next_batch
        self.next_batch = (index + 1) % len(self.data)
        return index

    def request(self, k: int, index: int):
        return self._step(index)

    def keep(self, k: int, outcome):
        return None

    def summarize(self, outcome):
        return outcome

    def outcome(self, summary):
        index, loss = summary
        finite = bool(torch.isfinite(loss))
        return self.batch, self.batch * finite, [], {"batch": index}

    def work(self, record) -> dict:
        """Kernel B1's least work (every column of the batch's n_pad) and
        the step's flops: the local solves, the MLP forward and its
        backward (twice the forward), and the loss's 16 PCG steps with M
        applied in factored form, forward and backward (twice)."""
        b1, flops = NO_WORK, 0
        first = record.info["batch"] * self.batch
        for case in self.cases[first:first + self.batch]:
            nnz_c, nnz_a = self.pattern_nnz[id(case)], case.vals.shape[0]
            work = gauss_jordan_work(self.n_pad, self.width)
            b1 = b1 + work
            loss = (self.pcg_steps + 1) * (
                learned_apply_flops(nnz_c, nnz_a, self.degree)
                + 2 * nnz_a + pcg_vector_flops(self.n_pad))
            flops += work.flops + 3 * (
                mlp_flops(self.n_pad, self.width, self.hidden) + loss)
        return {"b1": b1, "b2": NO_WORK, "flops": flops}

    def release(self) -> None:
        self.model = self.optimizer = self.plans = self.data = None
        self.provider = None

    @property
    def limits(self) -> dict:
        """The compared numbers' limits, from the mix."""
        return {name: float(v) for name, v in self.traffic["limits"].items()}

    def _reference(self, precision=None) -> dict:
        from portbench.reference.fsai_pattern import tril_power_pattern
        from portbench.reference.train_step import scaled_system

        batches = [self.cases[i * self.batch:(i + 1) * self.batch]
                   for i in range(CHECKED_STEPS)]
        self.pattern_nnz = {}
        for case in self.cases:
            _, _, (rows, cols) = scaled_system(case, self.n_pad)
            _, pc = tril_power_pattern(rows, cols, self.n_pad, self.power)
            self.pattern_nnz[id(case)] = int((pc < case.n).sum())
        return train_steps(batches, self.init, self.n_pad, self.width,
                           self.power, self.degree, self.lr, self.pcg_steps,
                           self.device, precision)

    def _gaps(self, got: dict) -> dict:
        """The compared numbers of ``got`` (the program's or the
        control's readings) against the float64 reference."""
        ref = self.ref
        g_norm = {k: float(v.norm()) for k, v in ref["first_grad"].items()}
        median = float(np.median(list(g_norm.values())))
        if not median > 0.0:  # nothing moves: nothing can be compared
            return {name: float("inf") for name in self.limits}
        leaves = [k for k, v in g_norm.items() if v >= 1e-3 * median]
        self.left_out = len(g_norm) - len(leaves)
        d_ref = {k: ref["params"][k] - self.init[k].double() for k in leaves}
        d_norm = {k: float(v.norm()) for k, v in d_ref.items()}
        d_median = float(np.median(list(d_norm.values())))
        grad_gap = max(
            abs(float(got["first_grad"][k].double().norm()) - g_norm[k])
            / max(g_norm[k], median) for k in leaves)
        delta_gap = max(
            abs(float((got["params"][k].double()
                       - self.init[k].double()).norm()) - d_norm[k])
            / max(d_norm[k], d_median) for k in leaves)
        loss_gap = max(abs(a - b) / abs(b) for a, b in
                       zip(got["losses"], ref["losses"]))
        return {"loss_gap": loss_gap, "grad_gap": grad_gap,
                "delta_gap": delta_gap}

    def check(self, kept: dict):
        self.ref = self._reference()
        got = {"losses": self.first["losses"],
               "first_grad": {k: v / 0.1 for k, v in
                              self.first["exp_avg"].items()},
               "params": self.first["params"]}
        values = self._gaps(got)
        checks = [(name, values[name], limit)
                  for name, limit in self.limits.items()]
        return checks, {}

    def control(self, kept: dict) -> dict:
        """The reference's steps in bf16 in the program's place."""
        return self._gaps(self._reference("bf16"))
