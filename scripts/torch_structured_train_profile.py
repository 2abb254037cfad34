#!/usr/bin/env python3
"""Where a structured train step's time goes on a card.

    python3 scripts/torch_structured_train_profile.py [--steps N]

For the w-13 configuration (``python -m
deeppreconditioning_tpu_torch.train.structured``'s defaults: 12^3, 32
samples, power 2, degree 1, 12 PCG steps) and the w-4 one (power 1,
degree 0) in turn it builds the training set as the entry point does,
starts from the JAX init parameters of the phase 4i fixture and takes
three warm-up steps with Adam at 2e-3.  Then, over the next ``N`` steps:

- the step split into forward and loss, backward, and the Adam update,
  each ended by ``torch.cuda.synchronize()`` (host clock, median ms),
  and the B1 / B2 launches per step;
- the same steps under ``torch.profiler``: wall, device time (the summed
  durations of the kernels, memcpys and memsets the card ran; GPU user
  annotations left out) and its share of the wall, the kernels per step,
  and the top device items.

The profiler's host overhead lengthens the wall, so the share is a lower
bound of the unprofiled busy share.  Needs a CUDA device.
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from deeppreconditioning_tpu_torch import _backend  # noqa: E402
from deeppreconditioning_tpu_torch.models.neural_fsai import (  # noqa: E402
    NeuralFSAI,
    params_from_jax,
)
from deeppreconditioning_tpu_torch.ops.structured_fsai import (  # noqa: E402
    build_structured_plan,
)
from deeppreconditioning_tpu_torch.train import (  # noqa: E402
    structured as structured_train,
)
from deeppreconditioning_tpu_torch.train.checkpoint import (  # noqa: E402
    load_checkpoint,
)

CONFIGS = {"w13": [], "w4": ["--power", "1", "--degree", "0"]}
FIXTURES = REPO / "tests" / "fixtures" / "torch_port"
WARMUP = 3
TOP_ROWS = 8


def card_line() -> str:
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def profile_config(tag, steps, dev) -> None:
    args = structured_train.parse_args(CONFIGS[tag])
    shape = tuple(int(s) for s in args.shape.split(","))
    plan = build_structured_plan(shape, power=args.power)
    a, b = structured_train.make_data(
        shape, args.samples, structured_train.parse_sigma(args.sigma),
        args.rhs, args.seed, device=dev)
    a_t = a.transpose()
    model = NeuralFSAI(plan.width, args.hidden, args.degree)
    model.load_state_dict(params_from_jax(load_checkpoint(
        FIXTURES / f"structured_train_init_{tag}.msgpack")["params"]))
    model = model.to(dev)
    optimizer = torch.optim.Adam(model.parameters(), lr=args.lr,
                                 betas=(0.9, 0.999), eps=1e-8)

    def step():
        optimizer.zero_grad(set_to_none=True)
        loss = structured_train.batch_loss(model, plan, a, a_t, b,
                                           args.pcg_steps)
        loss.backward()
        optimizer.step()

    for _ in range(WARMUP):
        step()
    torch.cuda.synchronize()
    parts = []
    _backend.reset_launch_counts()
    for _ in range(steps):
        t = [time.perf_counter()]
        optimizer.zero_grad(set_to_none=True)
        loss = structured_train.batch_loss(model, plan, a, a_t, b,
                                           args.pcg_steps)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        loss.backward()
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        optimizer.step()
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        parts.append(np.diff(t))
    launches = {k: v / steps for k, v in _backend.launch_counts().items()}
    parts = np.asarray(parts) * 1e3
    med = np.median(parts, axis=0)
    print(f"== {tag} (w {plan.width}, {args.samples} samples x "
          f"{a.n_pad}): step parts, median ms over {steps} steps: forward "
          f"and loss {med[0]:.3f}, backward {med[1]:.3f}, Adam {med[2]:.3f};"
          f" step {np.median(parts.sum(axis=1)):.3f}; launches per step "
          f"{launches}")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    on_card = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device = [e for e in on_card if not e.is_user_annotation]
    busy_ms = sum(e.time_range.elapsed_us() for e in device) * 1e-3
    kernels = sum(1 for e in device
                  if "memcpy" not in e.name.lower()
                  and "memset" not in e.name.lower())
    print(f"   profiled: wall {wall_ms / steps:.3f} ms per step, device "
          f"{busy_ms / steps:.3f} ms per step ({100 * busy_ms / wall_ms:.1f}"
          f"%), {len(device) / steps:.0f} device items per step, "
          f"{kernels / steps:.0f} of them kernels "
          f"({len(on_card) - len(device)} annotations left out)")
    print(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=TOP_ROWS,
        max_name_column_width=60))


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=10)
    steps = parser.parse_args().steps
    dev = _backend.device()
    print(f"card: {card_line()}, torch {torch.__version__}")
    for tag in CONFIGS:
        profile_config(tag, steps, dev)
    print(f"card: {card_line()}")


if __name__ == "__main__":
    main()
