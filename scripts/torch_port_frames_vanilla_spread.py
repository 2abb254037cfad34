"""The port's own frames batched vanilla counts on the CPU, in float32 and
float64, beside the JAX reference's.

Unpreconditioned CG on the frame stiffness systems (kappa ~3.5e3, n 300 to
750) takes a per-case count that rounding sets.  This script runs the
port's ``run_batched`` vanilla row (``bench/frames.frames_suite`` on the
200 frame cases from seed 69422, the last 40) on the CPU in float32 and in
float64, and prints per case the port's counts beside the JAX CPU counts
of ``tests/fixtures/torch_port/frames_batched_iterations.json`` (float32
``iterations.vanilla``, float64 ``vanilla_f64``), the largest gaps, and
the cases whose float32 counts differ by more than max(2, 5%).  It
compares two implementations of one algorithm on one host, so what it
shows is the spread that the order of the sums alone gives.  About 15 s
on 4 CPU threads.

    python scripts/torch_port_frames_vanilla_spread.py
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from deeppreconditioning_tpu_torch.bench import frames  # noqa: E402

FIXTURE = (REPO / "tests" / "fixtures" / "torch_port"
           / "frames_batched_iterations.json")


def port_counts(cases, dtype) -> np.ndarray:
    """The port's batched vanilla per-case counts on the CPU in ``dtype``."""
    suite = frames.frames_suite(torch.device("cpu"), dtype=dtype,
                                cases=cases)
    suite.run_batched(techniques=("vanilla",), reps=1, setup_reps=1)
    return np.asarray(suite.batched["vanilla"]["iterations_per_case"])


def main() -> None:
    ref = json.loads(FIXTURE.read_text())
    cases = frames.generate_frame_cases(solve=False)
    port = {"f32": port_counts(cases, torch.float32),
            "f64": port_counts(cases, torch.float64)}
    jax_counts = {"f32": np.asarray(ref["iterations"]["vanilla"]),
                  "f64": np.asarray(ref["vanilla_f64"])}
    print("case: port f32 / JAX f32 / port f64 / JAX f64")
    for i in range(len(jax_counts["f32"])):
        print(f"  {i:2d}: {port['f32'][i]} / {jax_counts['f32'][i]} / "
              f"{port['f64'][i]} / {jax_counts['f64'][i]}")
    for tag in ("f32", "f64"):
        got, want = port[tag], jax_counts[tag]
        gap = np.abs(got - want)
        over = np.nonzero(gap > np.maximum(2, 0.05 * want))[0]
        print(f"{tag}: means port {got.mean()} JAX {want.mean()}; largest "
              f"gap {gap.max()} at case {gap.argmax()} "
              f"({gap.max() / want[gap.argmax()]:.4f} of JAX's); cases "
              f"past max(2, 5%): {over.tolist()}")
    print(json.dumps({tag: c.tolist() for tag, c in port.items()}))


if __name__ == "__main__":
    main()
