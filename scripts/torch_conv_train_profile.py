#!/usr/bin/env python3
"""Where a conv train step's time goes on a card.

    python3 scripts/torch_conv_train_profile.py [--steps N]

For ``PreconditionerNet`` and ``PreconditionerSparseUNet`` in turn it
builds the training split as ``python -m deeppreconditioning_tpu_torch.train
--model ...`` does (the 400-case train split of the 500 sludge-pattern
cases from seed 69420, shuffled with seed 69, batches of 4 with their
conv plans), starts from the JAX init parameters of the phase 4h fixture
and takes three warm-up steps of ``inverse_loss`` with Adam at 1e-3 on
the first batches.  Then, over the next ``N`` batches (each built before
it is timed):

- the step split into forward and loss, backward, and the Adam update,
  each ended by ``torch.cuda.synchronize()`` (host clock, median ms);
- the same steps under ``torch.profiler``: wall, device time (the summed
  durations of the kernels, memcpys and memsets the card ran; GPU user
  annotations, which span some of them, left out) and its
  share of the wall, the kernels launched per step, and the top device
  items.

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
from deeppreconditioning_tpu_torch.bench.__main__ import (  # noqa: E402
    flagship_cases,
)
from deeppreconditioning_tpu_torch.config import get_model_class  # noqa: E402
from deeppreconditioning_tpu_torch.train import (  # noqa: E402
    __main__ as train_entry,
)
from deeppreconditioning_tpu_torch.train import trainer  # noqa: E402
from deeppreconditioning_tpu_torch.train.checkpoint import (  # noqa: E402
    load_checkpoint,
)

INIT = {"PreconditionerNet": "conv_train_init_precond_net.msgpack",
        "PreconditionerSparseUNet": "conv_train_init_unet.msgpack"}
WARMUP = 3
TOP_ROWS = 8


def card_line() -> str:
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def split_step(model, optimizer, batch) -> tuple:
    """One train step in three synchronized parts -> seconds each."""
    out = []
    t0 = time.perf_counter()
    optimizer.zero_grad(set_to_none=True)
    value = trainer.conv_loss(model, batch)
    torch.cuda.synchronize()
    out.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    value.backward()
    torch.cuda.synchronize()
    out.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    optimizer.step()
    torch.cuda.synchronize()
    out.append(time.perf_counter() - t0)
    return out


def profile_model(name, cases, steps, dev) -> None:
    args = train_entry.parse_args(["--model", name])
    data_set = train_entry._conv_data_set(args, dev, cases)
    model = get_model_class(name)(
        channels=tuple(args.params.channels)).to(dev)
    trainer.load_params(model, load_checkpoint(
        REPO / "tests" / "fixtures" / "torch_port" / INIT[name]))
    optimizer = trainer.adam(model, args.lr)
    for i in range(WARMUP):
        trainer.train_step(model, optimizer, data_set[i])
    torch.cuda.synchronize()

    first = WARMUP
    parts = []
    for i in range(first, first + steps):
        batch = data_set[i]
        torch.cuda.synchronize()
        parts.append(split_step(model, optimizer, batch))
    parts = np.asarray(parts) * 1e3
    med = np.median(parts, axis=0)
    print(f"== {name}: step parts, median ms over {steps} steps: forward "
          f"and loss {med[0]:.3f}, backward {med[1]:.3f}, Adam "
          f"{med[2]:.3f}; step {np.median(parts.sum(axis=1)):.3f}")

    first += steps
    batches = [data_set[i] for i in range(first, first + steps)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches:
            trainer.train_step(model, optimizer, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    on_card = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    # a GPU user annotation (``Optimizer.step#Adam.step``) spans device
    # items that are counted on their own
    device = [e for e in on_card if not e.is_user_annotation]
    busy_ms = sum(e.time_range.elapsed_us() for e in device) * 1e-3
    kernels = sum(1 for e in device
                  if "memcpy" not in e.name.lower()
                  and "memset" not in e.name.lower())
    print(f"   profiled: wall {wall_ms / steps:.3f} ms per step, device "
          f"{busy_ms / steps:.3f} ms per step ({100 * busy_ms / wall_ms:.1f}"
          f"%), {len(device) / steps:.0f} device items per step, "
          f"{kernels / steps:.0f} of them kernels "
          f"({len(on_card) - len(device)} annotations left out); launches "
          f"of B1, B2, B3 {_backend.launch_counts()}")
    print(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=TOP_ROWS,
        max_name_column_width=60))


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=20)
    steps = parser.parse_args().steps
    dev = _backend.device()
    print(f"card: {card_line()}, torch {torch.__version__}")
    cases = flagship_cases()
    for name in INIT:
        profile_model(name, cases, steps, dev)
    print(f"card: {card_line()}")


if __name__ == "__main__":
    main()
