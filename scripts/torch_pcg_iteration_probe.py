#!/usr/bin/env python3
"""Kernel-only time of the fused PCG iteration (``ops/pcg_iteration.py``,
``csrc/pcg_iteration.cu``) on the card, against its byte bound and against
its plain version, PyTorch's ops for the same work.

    python3 scripts/torch_pcg_iteration_probe.py [--out PATH]

At 256^3 and 128^3 (the HPCG and 128^3 cells' n, float32; 128^3 also
float64) and at the per-case cell's n 1024, on a random state with a fixed
Ap and z (rtol 0 and max_iter 2^31 - 1, so no iteration freezes), it
times with ``utils.profiling.time_graph`` (a CUDA graph of back-to-back
launches, operands resident) an iteration's two halves together
(``update_xr`` then ``update_p``: four launches above 16 384 entries, two
at or below), each half alone, and their plain versions on the card
(``update_xr_torch`` then ``update_p_torch``: PyTorch's ops, the chain
the solver ran before the fusion less its second r.z).  The bound is ``pcg_iteration_work``'s 13
n-vectors over the card's HBM bandwidth; at 128^3 and below the vectors
fit the 50 MB L2, so a share there can pass 1.  Prints one JSON line a
shape, and writes them all, with the card's name and power limit, to
``--out``.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from deeppreconditioning_tpu_torch import _backend  # noqa: E402
from deeppreconditioning_tpu_torch.ops import pcg_iteration  # noqa: E402
from deeppreconditioning_tpu_torch.utils.profiling import (  # noqa: E402
    card_peaks,
    fp64_tflop_s,
    pcg_iteration_work,
    time_graph,
)

SHAPES = (("256^3", 256 ** 3, torch.float32),
          ("128^3", 128 ** 3, torch.float32),
          ("128^3", 128 ** 3, torch.float64),
          ("per case", 1024, torch.float32))
NEVER = 2 ** 31 - 1  # max_iter: no iteration freezes


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False)
    return out.stdout.strip()


def _state(n, dtype, dev):
    gen = torch.Generator(device=dev).manual_seed(n)
    s = pcg_iteration.PCGState(torch.zeros(n, dtype=dtype, device=dev))
    for t in (s.x, s.r, s.p):
        t.copy_(torch.randn(n, generator=gen, dtype=dtype, device=dev))
    s.vals.copy_(torch.tensor([1.0, 0.0, 0.0, float(n), 1.0], dtype=dtype))
    s.flags.zero_()
    ap, z = (torch.randn(n, generator=gen, dtype=dtype, device=dev)
             for _ in range(2))
    return s, ap, z


def _plain(s, ap, z):
    """The plain halves on a second state holding ``s``'s values."""
    t = pcg_iteration.PCGState(s.x)
    for name in ("x", "r", "p", "vals", "flags"):
        getattr(t, name).copy_(getattr(s, name))

    def step():
        pcg_iteration.update_xr_torch(t, ap, 0.0, NEVER)
        pcg_iteration.update_p_torch(t, z, NEVER)
    return step


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--out", default="assets/results/torch/pcg_iteration_probe.json")
    args = parser.parse_args()
    dev = _backend.device()
    card = _card()
    peaks = card_peaks(torch.cuda.get_device_name(dev))
    rows = []
    for label, n, dtype in SHAPES:
        s, ap, z = _state(n, dtype, dev)

        def xr():
            pcg_iteration.update_xr(s, ap, 0.0, NEVER)

        def p():
            pcg_iteration.update_p(s, z, NEVER)

        def both():
            xr()
            p()

        itemsize = torch.empty((), dtype=dtype).element_size()
        flops = (peaks.fp32_tflop_s if dtype == torch.float32
                 else fp64_tflop_s(torch.cuda.get_device_name(dev)))
        bound, roof = pcg_iteration_work(n, itemsize).bound(peaks.hbm_gb_s,
                                                            flops)
        fused = time_graph(both, dev)
        plain = time_graph(_plain(s, ap, z), dev)
        row = {
            "shape": label, "n": n, "dtype": str(dtype).removeprefix("torch."),
            "grid": s.grid,
            "launches": 2 if s.grid == 1 else 4,
            "fused_ms": fused * 1e3,
            "xr_ms": time_graph(xr, dev) * 1e3,
            "p_ms": time_graph(p, dev) * 1e3,
            "bound_ms": bound * 1e3, "roof": roof,
            "share_of_bound": bound / fused,
            "plain_ms": plain * 1e3,
            "card": card,
        }
        print(json.dumps(row), flush=True)
        rows.append(row)
        del s, ap, z
        torch.cuda.empty_cache()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "rows": rows}, indent=1))


if __name__ == "__main__":
    main()
