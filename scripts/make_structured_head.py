"""Write a structured NeuralFSAI head with seeded random weights.

    python3 scripts/make_structured_head.py --width 14 --power 1 \\
        --degree 1 --seed 14 \\
        --out portbench/weights/structured_w14_deg1.msgpack

The head of ``models/neural_fsai.NeuralFSAI`` (features 4w -> hidden ->
hidden -> the alpha and beta heads of w, and the wrap's q coefficients)
as a Flax msgpack checkpoint (``train/checkpoint.save_checkpoint``), its
leaves float32 drawn from ``numpy.random.default_rng(seed)``: the hidden
layers N(0, 1 / fan_in), the heads at a tenth of that, their biases and
the q coefficients (the delta over q = 1) N(0, 0.05^2).  The refined
factor keeps a positive diagonal, so M = C q(B)^2 C^T stays SPD wherever
the safeguard keeps q.  Width and power must match the pattern the head
is run on (14 for the 27-point box at power 1).
"""

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from deeppreconditioning_tpu_torch.train.checkpoint import (  # noqa: E402
    save_checkpoint,
)


def head_payload(width: int, hidden: int, degree: int, power: int,
                 seed: int) -> dict:
    rng = np.random.default_rng(seed)

    def dense(fan_in, fan_out, scale):
        kernel = rng.standard_normal((fan_in, fan_out)) * scale / np.sqrt(
            fan_in)
        bias = rng.standard_normal(fan_out) * (0.05 if scale < 1 else 0.0)
        return {"kernel": kernel.astype(np.float32),
                "bias": bias.astype(np.float32)}

    params = {"dense0": dense(4 * width, hidden, 1.0),
              "dense1": dense(hidden, hidden, 1.0),
              "alpha": dense(hidden, width, 0.1),
              "beta": dense(hidden, width, 0.1),
              "q_coeffs": (rng.standard_normal(degree + 1) * 0.05).astype(
                  np.float32)}
    return {"params": {"params": params}, "width": width, "hidden": hidden,
            "poly_degree": degree, "power": power,
            "family": "structured_random", "seed": seed}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--width", type=int, required=True)
    parser.add_argument("--hidden", type=int, default=64)
    parser.add_argument("--degree", type=int, default=1)
    parser.add_argument("--power", type=int, required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)
    save_checkpoint(Path(args.out), head_payload(
        args.width, args.hidden, args.degree, args.power, args.seed))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
