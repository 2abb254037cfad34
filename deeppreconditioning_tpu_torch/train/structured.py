"""Train the structured-grid NeuralFSAI head (the scaling family's).

    python -m deeppreconditioning_tpu_torch.train.structured
        [--shape 12,12,12] [--samples 32] [--steps 400] [--lr 2e-3]
        [--power 2] [--degree 1] [--hidden 64] [--pcg-steps 12]
        [--sigma 1.0|LO:HI] [--rhs random|ax] [--seed 69]
        [--init-from CKPT] [--out PATH] [--device cpu]

Counterpart of ``scripts/train_structured.py``.  Data: ``--samples``
variable-coefficient Poisson operators on one grid, drawn from
``default_rng(seed)`` with sigma uniform in [LO, HI] per sample, bands
sorted by offset, and a random right-hand side (or ``A x*``) per sample.
The model is ``NeuralFSAI(width=w, hidden, poly_degree)`` with w the
pattern width of the stencil-graph power (13 at power 2, 4 at power 1),
initialized as the script does (``init_params``: lecun truncated-normal
dense layers, zero heads and q; drawn from torch's generator, so the
reference's exact init comes in with ``--init-from``).

The loss is the script's ``case_loss`` over all samples at once (its
``jax.vmap``): the batched ``structured_setup`` without the safeguard
(one B1 launch for every sample's local systems), ``--pcg-steps``
unrolled PCG steps with the offset-form apply and the operator product
through ``dia_matvec`` (kernel B2 on the card, forward and backward),
the squared relative residual's log floored at 1e-28, and the mean.
Adam at ``--lr`` (optax's defaults).  The best loss is paired with the
parameters from before the step that produced it.  Every 25 steps and
at the last one it prints the script's line; then it writes the
script's payload (Flax msgpack) to ``--out``, by default under
``assets/results/torch/``.  Without ``--device cpu`` the run needs the
card.
"""

from __future__ import annotations

import argparse
import math
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from deeppreconditioning_tpu_torch import _backend
from deeppreconditioning_tpu_torch.data.poisson import poisson_coeff_dia
from deeppreconditioning_tpu_torch.models.neural_fsai import (
    NeuralFSAI,
    init_params,
    params_from_jax,
    params_to_jax,
)
from deeppreconditioning_tpu_torch.ops.dia_spmv import dia_matvec
from deeppreconditioning_tpu_torch.ops.structured_fsai import (
    build_structured_plan,
    dia_sorted_by_offset,
    make_structured_poly_apply,
    structured_setup,
)
from deeppreconditioning_tpu_torch.sparse.dia import DIAMatrix
from deeppreconditioning_tpu_torch.train.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)

REPO = Path(__file__).resolve().parents[2]
OUT = REPO / "assets" / "results" / "torch" / "train_structured" / "best.msgpack"
PRINT_EVERY = 25


def parse_sigma(text: str) -> tuple[float, float]:
    """'1.0' -> (1.0, 1.0); 'LO:HI' -> (LO, HI)."""
    if ":" in text:
        lo, hi = (float(s) for s in text.split(":"))
        return lo, hi
    return float(text), float(text)


def make_data(shape, samples: int, sigma, rhs: str, seed: int,
              dtype=torch.float32, device=None):
    """The training set: (A, b) with A a batched ``DIAMatrix`` (samples,
    7, n_pad) and b (samples, n_pad), drawn as the script draws them (the
    rhs rounded through float32; ``ax`` multiplies on the device)."""
    lo, hi = sigma
    rng = np.random.default_rng(seed)
    mats, rhss = [], []
    for _ in range(samples):
        a = dia_sorted_by_offset(poisson_coeff_dia(
            shape, rng=rng, sigma=float(rng.uniform(lo, hi)), dtype=dtype,
            device=device))
        mats.append(a.vals)
        if rhs == "ax":
            x_star = np.zeros(a.n_pad, np.float32)
            x_star[:a.n] = rng.standard_normal(a.n)
            rhss.append(dia_matvec(a, torch.as_tensor(
                x_star, device=device).to(dtype)))
        else:
            b_np = np.zeros(a.n_pad, np.float32)
            b_np[:a.n] = rng.standard_normal(a.n)
            rhss.append(torch.as_tensor(b_np, device=device).to(dtype))
    a = DIAMatrix(vals=torch.stack(mats), offsets=a.offsets, n=a.n)
    return a, torch.stack(rhss)


def batch_loss(model: NeuralFSAI, plan, a: DIAMatrix, a_t: DIAMatrix,
               b: torch.Tensor, pcg_steps: int) -> torch.Tensor:
    """The script's ``case_loss`` for every sample of (A, b) at once, and
    its mean.  The script's iterate x, and its last step's z and p, do not
    enter the loss and are not formed (XLA drops them from the
    reference's program): ``pcg_steps * (1 + 2 * degree)`` operator
    products, each with its backward."""
    bands, q = structured_setup(a, plan, model, safeguard=False)
    apply_fn = make_structured_poly_apply(plan.offsets, model.poly_degree)
    m_data = (bands, q, a, a_t)

    def dot(u, v):
        return (u * v).sum(dim=-1, keepdim=True)

    def nonzero(v):
        return torch.where(v == 0, torch.ones_like(v), v)

    bb = torch.clamp((b * b).sum(dim=-1), min=1e-30)
    r = b
    z = apply_fn(m_data, r)
    p = r * 0 + z
    for step in range(pcg_steps):
        ap = dia_matvec(a, p, a_t)
        rz = dot(r, z)
        alpha = rz / nonzero(dot(ap, p))
        r = r - alpha * ap
        if step == pcg_steps - 1:
            break
        z = apply_fn(m_data, r)
        beta = dot(r, z) / nonzero(rz)
        p = z + beta * p
    return torch.log(torch.clamp((r * r).sum(dim=-1) / bb, min=1e-28)).mean()


@dataclass
class StructuredRun:
    """What one training run did: per-step losses and seconds (each step
    ends with the loss read on the host), the best loss and the state
    that gave it, the payload written."""

    losses: list = field(default_factory=list)
    step_seconds: list = field(default_factory=list)
    best_loss: float = math.inf
    best_step: int = -1
    best_state: dict | None = None
    model: NeuralFSAI | None = None
    payload: dict | None = None
    out: Path | None = None
    setup_seconds: float = 0.0


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--shape", default="12,12,12")
    parser.add_argument("--samples", type=int, default=32)
    parser.add_argument("--steps", type=int, default=400)
    parser.add_argument("--lr", type=float, default=2e-3)
    parser.add_argument("--power", type=int, default=2)
    parser.add_argument("--degree", type=int, default=1)
    parser.add_argument("--hidden", type=int, default=64)
    parser.add_argument("--pcg-steps", type=int, default=12)
    parser.add_argument("--sigma", default="1.0",
                        help="coefficient contrast: a float, or 'LO:HI' "
                        "for per-sample uniform draws")
    parser.add_argument("--rhs", default="random", choices=["random", "ax"])
    parser.add_argument("--seed", type=int, default=69)
    parser.add_argument("--init-from", default=None,
                        help="a checkpoint payload whose parameters start "
                        "the run (the reference's init)")
    parser.add_argument("--out", default=str(OUT))
    parser.add_argument("--device", default=None,
                        help="'cpu' for the CPU; the card otherwise")
    return parser.parse_args(argv)


def run(args: argparse.Namespace, device=None, dtype=torch.float32,
        log=print) -> StructuredRun:
    """Train as ``args`` say on ``device`` (default: ``--device``, else
    the card) and write the payload to ``args.out`` (None: no file)."""
    if device is None:
        device = (torch.device(args.device) if args.device
                  else _backend.device())
    device = torch.device(device)
    shape = tuple(int(s) for s in args.shape.split(","))
    sigma = parse_sigma(args.sigma)
    plan = build_structured_plan(shape, power=args.power)
    w = plan.width
    log(f"shape={shape} pattern width={w} offsets={plan.offsets}")
    t0 = time.perf_counter()
    a, b = make_data(shape, args.samples, sigma, args.rhs, args.seed, dtype,
                     device)
    a_t = a.transpose()
    model = NeuralFSAI(width=w, hidden=args.hidden,
                       poly_degree=args.degree).to(dtype)
    if args.init_from:
        payload = load_checkpoint(args.init_from)
        if (int(payload["width"]), int(payload["hidden"]),
                int(payload["poly_degree"])) != (w, args.hidden,
                                                 args.degree):
            raise ValueError(f"{args.init_from} holds another model")
        model.load_state_dict(params_from_jax(payload["params"]))
    else:
        init_params(model, torch.Generator().manual_seed(args.seed))
    model = model.to(device=device, dtype=dtype)
    optimizer = torch.optim.Adam(model.parameters(), lr=args.lr,
                                 betas=(0.9, 0.999), eps=1e-8)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    result = StructuredRun(model=model,
                           setup_seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    for it in range(args.steps):
        start = time.perf_counter()
        optimizer.zero_grad(set_to_none=True)
        loss_t = batch_loss(model, plan, a, a_t, b, args.pcg_steps)
        loss_t.backward()
        loss = float(loss_t.detach())
        # the loss belongs to the parameters before this step's update
        if loss < result.best_loss:
            result.best_loss, result.best_step = loss, it
            result.best_state = {k: v.detach().clone()
                                 for k, v in model.state_dict().items()}
        optimizer.step()
        result.losses.append(loss)
        result.step_seconds.append(time.perf_counter() - start)
        if it % PRINT_EVERY == 0 or it == args.steps - 1:
            log(f"step {it:4d} loss {loss:+.4f} (best "
                f"{result.best_loss:+.4f}, {time.perf_counter() - t0:.0f}s)")
    best_state = result.best_state or model.state_dict()
    result.payload = {
        "params": params_to_jax({k: v.float() for k, v in
                                 best_state.items()}),
        "width": w,
        "hidden": args.hidden,
        "poly_degree": args.degree,
        "power": args.power,
        "family": "structured_poisson",
        "train_shape": list(shape),
        "sigma": [sigma[0], sigma[1]],
        "rhs": args.rhs,
        "final_loss": result.best_loss,
    }
    if args.out:
        result.out = Path(args.out)
        save_checkpoint(result.out, result.payload)
        log(f"saved {result.out} (loss {result.best_loss:+.4f})")
    return result


def main(argv=None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
