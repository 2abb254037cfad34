#!/usr/bin/env python3
"""torch.profiler breakdown of the port's two paths on a card.

    python3 scripts/torch_profile.py

Per-case path: builds it as ``python -m deeppreconditioning_tpu_torch.bench``
does (500 sludge-pattern cases from seed 69420, the 100-case test split,
the flagship NeuralFSAI checkpoint) and, for each of vanilla, jacobi,
fsai and learned on its own, runs the suite's per-case protocol (the
entry point's timing reps included) over the split's first ``CASES``
cases under ``torch.profiler``.  Per technique it prints the wall time
of the profiled run, the device time (the summed durations of the
kernels, memcpys and memsets the card ran) and its share of the wall,
the per-case medians of setup and solve, and the top device items.

Scaling path: for each technique of ``bench/scaling.py`` on its own,
``run_scaling`` at ``SCALING_SIDE``^3 with one timing rep (setup warm-up,
timed setup, kept setup, chunked solve, fixed-trip solve, timed solve)
under ``torch.profiler``, with the same report.

The profiler's host overhead lengthens the wall, so the share is a lower
bound of the unprofiled busy share.  Needs a CUDA device.
"""

import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from deeppreconditioning_tpu_torch import _backend  # noqa: E402
from deeppreconditioning_tpu_torch.bench import scaling  # noqa: E402
from deeppreconditioning_tpu_torch.bench.__main__ import (  # noqa: E402
    KAPPA_CASES,
    SEED,
    TIMING_REPS,
    generate_cases,
)
from deeppreconditioning_tpu_torch.bench.suite import (  # noqa: E402
    TECHNIQUES,
    BenchmarkSuite,
)
from deeppreconditioning_tpu_torch.config import params_show  # noqa: E402
from deeppreconditioning_tpu_torch.data.datasets import (  # noqa: E402
    SludgePatternDataSet,
)
from deeppreconditioning_tpu_torch.models.neural_fsai import (  # noqa: E402
    neural_fsai_from_checkpoint,
)
from deeppreconditioning_tpu_torch.train.checkpoint import (  # noqa: E402
    load_checkpoint,
)

CASES = 10
TOP_ROWS = 8
SCALING_SIDE = 128


class LeadingCases:
    """The first ``count`` cases of a data set, with its ``dof_pad``."""

    def __init__(self, data_set, count):
        self.data_set, self.count = data_set, min(count, len(data_set))
        self.dof_pad = data_set.dof_pad

    def __len__(self):
        return self.count

    def host_sample(self, index):
        return self.data_set.host_sample(index)


def device_busy_ms(prof) -> float:
    """Summed durations of the events that ran on the card."""
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) * 1e-3


def report(name, prof, wall_ms, detail):
    busy_ms = device_busy_ms(prof)
    print(f"== {name}: wall {wall_ms:.1f} ms, device {busy_ms:.1f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), {detail}")
    print(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=TOP_ROWS,
        max_name_column_width=60))


def profile_per_case(dev) -> None:
    params = params_show(REPO / "params.yaml")
    cases = generate_cases(params.number_samples, SEED, params.mesh_cells)
    data_set = LeadingCases(SludgePatternDataSet(stage="test", cases=cases),
                            CASES)
    payload = load_checkpoint(REPO / params.checkpoint_dir / "best.msgpack")
    model = neural_fsai_from_checkpoint(payload)
    print(f"{torch.cuda.get_device_name(dev)}; torch {torch.__version__}; "
          f"{len(data_set)} cases, n_pad {data_set.dof_pad}, "
          f"timing reps {TIMING_REPS}")
    for name in TECHNIQUES:
        suite = BenchmarkSuite(
            data_set, model, techniques=(name,), device=dev,
            timing_reps=TIMING_REPS, kappa_cases=KAPPA_CASES,
            learned_power=int(payload.get("power", 4)) or 4,
        )
        torch.cuda.synchronize(dev)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            suite.run()
            torch.cuda.synchronize(dev)
            wall_ms = (time.perf_counter() - t0) * 1e3
        report(name, prof, wall_ms,
               f"iterations mean {np.mean(suite.iterations[name]):.2f}, "
               f"setup median {np.median(suite.setups[name]) * 1e3:.3f} ms, "
               f"solve median {np.median(suite.durations[name]) * 1e3:.3f}"
               " ms")


def profile_scaling(dev) -> None:
    print(f"scaling path at {SCALING_SIDE}^3, one timing rep")
    for name in scaling.TECHNIQUES:
        torch.cuda.synchronize(dev)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run = scaling.run_scaling(dev, shapes=(SCALING_SIDE,), reps=1,
                                      out=None, techniques=(name,))
            torch.cuda.synchronize(dev)
            wall_ms = (time.perf_counter() - t0) * 1e3
        row = run.rows[0]
        report(f"{SCALING_SIDE}^3 {name}", prof, wall_ms,
               f"iterations {row['iterations']}, setup "
               f"{row['setup_s'] * 1e3:.3f} ms, solve "
               f"{row['solve_s'] * 1e3:.3f} ms")


def main() -> None:
    dev = _backend.device()
    _backend.kernel_library()
    profile_per_case(dev)
    profile_scaling(dev)


if __name__ == "__main__":
    main()
