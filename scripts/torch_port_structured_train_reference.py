"""Reference runs of the structured-grid trainer, for the port.

    JAX_PLATFORMS=cpu python scripts/torch_port_structured_train_reference.py

Runs ``scripts/train_structured.py``'s training loop, transcribed line for
line from its ``main`` (data, init, ``case_loss``, the vmapped mean, the
jitted optax Adam step and the best-loss pairing), on the CPU in float32
with the JAX package's ops, for two configurations:

  * ``w13``: the script's defaults (12^3, 32 samples, lr 2e-3, power 2,
    degree 1, hidden 64, 12 PCG steps, sigma 1.0, random rhs, seed 69),
    the first 100 of its 400 steps: pattern width 13, the
    ``deg1_random`` checkpoint's family;
  * ``w4``: ``--power 1 --degree 0 --steps 25``: pattern width 4, the
    ``deg0_p1`` checkpoint's.

Then it runs ``scripts/train_structured.py --platform cpu --steps 25``
itself (to a temporary file) and checks that the losses it prints at
steps 0 and 24 equal the transcription's, to the four decimals it prints.

Writes ``tests/fixtures/torch_port/structured_train_init_{w13,w4}.msgpack``
(each configuration's init parameters as the script's payload,
``flax.serialization.to_bytes``) and
``tests/fixtures/torch_port/structured_train.json`` (per configuration:
the settings, every step's loss, the best loss and its step; the script's
printed lines).  The tests import ``make_data``, ``init_params``,
``make_case_loss`` and ``make_loss_fn`` from here and run them in float64.
About 16 minutes on 8 CPU cores (each jitted step compiles for 3 minutes).
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

FIXTURES = REPO / "tests" / "fixtures" / "torch_port"
DEFAULTS = {"shape": [12, 12, 12], "samples": 32, "steps": 400,
            "lr": 2e-3, "power": 2, "degree": 1, "hidden": 64,
            "pcg_steps": 12, "sigma": [1.0, 1.0], "rhs": "random",
            "seed": 69}
CONFIGS = {"w13": dict(DEFAULTS, steps=100),
           "w4": dict(DEFAULTS, power=1, degree=0, steps=25)}
SCRIPT_STEPS = 25


def make_data(shape, samples, sigma, rhs, seed, dtype):
    """The script's training set: ``samples`` operators drawn from
    ``default_rng(seed)`` (sigma uniform in [lo, hi] per sample), bands
    sorted by offset, and their right-hand sides.  Returns (vals (S,
    n_diag, n_pad), b (S, n_pad), offsets, n)."""
    import jax.numpy as jnp

    from deeppreconditioning_tpu.data.poisson import poisson_coeff_dia
    from deeppreconditioning_tpu.ops.structured_fsai import (
        dia_sorted_by_offset,
    )

    lo, hi = sigma
    rng = np.random.default_rng(seed)
    mats, rhss = [], []
    for _ in range(samples):
        a = dia_sorted_by_offset(poisson_coeff_dia(
            shape, rng=rng, sigma=float(rng.uniform(lo, hi)), dtype=dtype,
        ))
        mats.append(np.asarray(a.vals))
        if rhs == "ax":
            x_star = np.zeros(a.n_pad, np.float32)
            x_star[:a.n] = rng.standard_normal(a.n)
            rhss.append(np.asarray(a.matvec(jnp.asarray(x_star, dtype))))
        else:
            b_np = np.zeros(a.n_pad, np.float32)
            b_np[:a.n] = rng.standard_normal(a.n)
            rhss.append(b_np)
    a0 = dia_sorted_by_offset(poisson_coeff_dia(
        shape, rng=np.random.default_rng(0), dtype=dtype))
    return (jnp.asarray(np.stack(mats), dtype),
            jnp.asarray(np.stack(rhss), dtype), a0.offsets, a0.n)


def init_params(width, hidden, degree, seed, dtype):
    """The script's init: lecun truncated-normal dense0 / dense1 from
    ``PRNGKey(seed)``, zero biases, zero heads and q."""
    import jax
    import jax.numpy as jnp

    def lecun(key, shape_):
        return (jax.random.truncated_normal(key, -2.0, 2.0, shape_)
                * np.sqrt(1.0 / shape_[0]) / 0.87962566103423978)

    k0, k1 = jax.random.split(jax.random.PRNGKey(seed))
    feat = 4 * width
    params = {
        "dense0": {"kernel": lecun(k0, (feat, hidden)),
                   "bias": jnp.zeros((hidden,))},
        "dense1": {"kernel": lecun(k1, (hidden, hidden)),
                   "bias": jnp.zeros((hidden,))},
        "alpha": {"kernel": jnp.zeros((hidden, width)),
                  "bias": jnp.zeros((width,))},
        "beta": {"kernel": jnp.zeros((hidden, width)),
                 "bias": jnp.zeros((width,))},
        "q_coeffs": jnp.zeros((degree + 1,)),
    }
    return jax.tree.map(lambda x: jnp.asarray(x, dtype), params)


def make_case_loss(plan, offsets_a, n, degree, pcg_steps):
    """The script's ``case_loss(params, vals, b)`` for one sample."""
    import jax.numpy as jnp

    from deeppreconditioning_tpu.ops.structured_fsai import (
        make_structured_poly_apply,
        structured_setup,
    )
    from deeppreconditioning_tpu.sparse.dia import DIAMatrix

    apply_fn = make_structured_poly_apply(plan.offsets, degree)

    def case_loss(params, vals, b):
        a = DIAMatrix(vals=vals, offsets=offsets_a, n=n)
        bands, q = structured_setup(
            a, plan, {"params": params}, safeguard=False
        )
        m_data = (bands, q, a)
        bb = jnp.maximum(jnp.sum(b * b), 1e-30)
        x = jnp.zeros_like(b)
        r = b
        z = apply_fn(m_data, r)
        p = r * 0 + z
        for _ in range(pcg_steps):
            ap = a.matvec(p)
            rz = jnp.sum(r * z)
            denom = jnp.sum(ap * p)
            alpha = rz / jnp.where(denom == 0, 1.0, denom)
            x = x + alpha * p
            r = r - alpha * ap
            z = apply_fn(m_data, r)
            beta = jnp.sum(r * z) / jnp.where(rz == 0, 1.0, rz)
            p = z + beta * p
        return jnp.log(jnp.maximum(jnp.sum(r * r) / bb, 1e-28))

    return case_loss


def make_loss_fn(case_loss):
    """The script's batch mean of ``case_loss`` (vmapped)."""
    import jax
    import jax.numpy as jnp

    def loss_fn(params, vals_b, b_b):
        return jnp.mean(jax.vmap(
            lambda v, b: case_loss(params, v, b)
        )(vals_b, b_b))

    return loss_fn


def train(cfg: dict, dtype=None):
    """The script's loop for ``cfg``; returns (init params, per-step
    losses, best loss, best step, width)."""
    import jax
    import jax.numpy as jnp
    import optax

    from deeppreconditioning_tpu.ops.structured_fsai import (
        build_structured_plan,
    )

    dtype = dtype or jnp.float32
    shape = tuple(cfg["shape"])
    plan = build_structured_plan(shape, power=cfg["power"])
    vals, b_all, offsets_a, n = make_data(
        shape, cfg["samples"], cfg["sigma"], cfg["rhs"], cfg["seed"], dtype)
    params = init_params(plan.width, cfg["hidden"], cfg["degree"],
                         cfg["seed"], dtype)
    init = params
    loss_fn = make_loss_fn(make_case_loss(plan, offsets_a, n, cfg["degree"],
                                          cfg["pcg_steps"]))
    tx = optax.adam(cfg["lr"])
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state, vals_b, b_b):
        loss, grads = jax.value_and_grad(loss_fn)(params, vals_b, b_b)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    losses, best, best_step = [], np.inf, -1
    t0 = time.time()
    for it in range(cfg["steps"]):
        params, opt_state, loss = step(params, opt_state, vals, b_all)
        loss = float(loss)
        losses.append(loss)
        if loss < best:
            best, best_step = loss, it
        if it % 25 == 0:
            print(f"  step {it:4d} loss {loss:+.4f} (best {best:+.4f}, "
                  f"{time.time() - t0:.0f}s)", flush=True)
    return init, losses, best, best_step, plan.width


def payload(params, width, cfg):
    """The script's checkpoint payload around ``params``."""
    import jax

    return {
        "params": {"params": jax.tree.map(np.asarray, params)},
        "width": width,
        "hidden": cfg["hidden"],
        "poly_degree": cfg["degree"],
        "power": cfg["power"],
        "family": "structured_poisson",
        "train_shape": list(cfg["shape"]),
        "sigma": list(cfg["sigma"]),
        "rhs": cfg["rhs"],
        "final_loss": float("nan"),
    }


def run_script(steps: int) -> dict:
    """``scripts/train_structured.py --platform cpu --steps <steps>`` in a
    subprocess; returns its printed losses by step."""
    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run(
            [sys.executable, str(REPO / "scripts" / "train_structured.py"),
             "--platform", "cpu", "--steps", str(steps),
             "--out", str(Path(tmp) / "script.msgpack")],
            capture_output=True, text=True, check=True, cwd=REPO,
        ).stdout
    printed = {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"step\s+(\d+) loss ([+-]\d+\.\d+)", out)}
    return {"stdout": out.splitlines(), "losses": printed}


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from flax import serialization

    out = {"what": "scripts/train_structured.py's loop, JAX CPU float32",
           "runs": {}}
    for tag, cfg in CONFIGS.items():
        print(f"{tag}: {cfg}", flush=True)
        t0 = time.time()
        init, losses, best, best_step, width = train(cfg)
        seconds = time.time() - t0
        FIXTURES.mkdir(parents=True, exist_ok=True)
        (FIXTURES / f"structured_train_init_{tag}.msgpack").write_bytes(
            serialization.to_bytes(payload(init, width, cfg)))
        out["runs"][tag] = {"config": cfg, "width": width,
                            "losses": losses, "best_loss": best,
                            "best_step": best_step,
                            "cpu_seconds": round(seconds, 1)}
        print(f"{tag}: width {width}, best {best:+.4f} at step {best_step},"
              f" {seconds:.0f} s", flush=True)
    script = run_script(SCRIPT_STEPS)
    mine = out["runs"]["w13"]["losses"]
    for it, printed in script["losses"].items():
        if f"{mine[it]:+.4f}" != f"{printed:+.4f}":
            raise SystemExit(f"step {it}: the script printed {printed:+.4f}, "
                             f"the transcription {mine[it]:+.4f}")
    print(f"the script's steps {sorted(script['losses'])} equal the "
          "transcription's", flush=True)
    out["script"] = {"argv": ["--platform", "cpu", "--steps",
                              str(SCRIPT_STEPS)],
                     "printed_losses": {str(k): v for k, v in
                                        script["losses"].items()}}
    (FIXTURES / "structured_train.json").write_text(
        json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    main()
