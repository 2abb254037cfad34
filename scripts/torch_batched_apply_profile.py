#!/usr/bin/env python3
"""The batched protocol's learned apply on a card, part by part.

    python3 scripts/torch_batched_apply_profile.py

Builds the sludge test split and the flagship checkpoint as ``python -m
deeppreconditioning_tpu_torch.bench`` does, then the batched learned setup
of its bf16 attempt (what ``run_batched`` settles on: bf16 bands, A~ held
as its bf16-rounded values in float32) and the classical fsai one (a bf16
M held the same way).  On the split's right-hand sides it measures

* one PCG iteration of each: a fixed-trip solve of ``TRIPS`` trips over
  ``TRIPS``;
* one preconditioner apply, and the parts of the learned apply: one C^T r
  band pass, one C t band pass, one inner matvec (A~ times a bf16-rounded
  vector) and the solver's own float32 matvec;

each per call (CUDA events around one call, median), kernel only (a CUDA
graph of back-to-back calls, ``utils/profiling.time_graph``) and by its
launches (the kernels, copies and sets one call puts on the card, counted
by ``torch.profiler``).  Beside each: the bytes the part must move as the
port holds its operands (every input read once, the output written once),
its bound at the card's HBM rate (``utils/profiling.card_peaks``), the
bytes of the temporaries the eager form writes and reads on top, and the
bound if A~ and M were held in bf16.  The apply's bound is the sum of its
passes' bounds: each pass needs the vector the one before it made, and no
operand fits in the L2.  Needs a CUDA device; ~3 minutes with the split's
generation.
"""

import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from deeppreconditioning_tpu_torch import _backend  # noqa: E402
from deeppreconditioning_tpu_torch.bench.__main__ import (  # noqa: E402
    flagship_suite,
)
from deeppreconditioning_tpu_torch.bench.suite import (  # noqa: E402
    _dense_apply_batched_bf16,
    _scaled_dense_matvec,
    _scaled_dense_matvec_fast,
)
from deeppreconditioning_tpu_torch.ops.banded_factor import (  # noqa: E402
    banded_lower_matvec,
    banded_upper_matvec,
)
from deeppreconditioning_tpu_torch.solvers.cg import (  # noqa: E402
    batched_pcg_fixed_trips,
)
from deeppreconditioning_tpu_torch.utils.profiling import (  # noqa: E402
    card_peaks,
    time_call,
    time_graph,
)

TRIPS = 12  # the learned technique's fixed trips on this split
REPS = 20
CHUNK = 100  # cases per setup call, as run_batched


def launches(fn, dev) -> tuple[int, float]:
    """(events, device ms) one call of ``fn`` puts on the card."""
    fn()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(dev)
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(events), sum(e.time_range.elapsed_us() for e in events) * 1e-3


def report(label, fn, dev, hbm, need, temp=0, need_bf16=None):
    """Print one part's times, launches, bytes and bounds (ms, MB)."""
    per_call = time_call(fn, dev, reps=REPS) * 1e3
    only = time_graph(fn, dev) * 1e3
    count, busy = launches(fn, dev)
    bound = need / hbm * 1e3
    line = (f"{label}: per call {per_call:.4f} ms, kernel only {only:.4f} "
            f"ms, launches {count} (profiled device time {busy:.4f} ms); "
            f"bytes {need / 1e6:.1f} MB, bound {bound:.4f} ms, share "
            f"{bound / only:.3f}")
    if temp:
        line += (f"; temporaries {temp / 1e6:.1f} MB more "
                 f"({(need + temp) / hbm * 1e3:.4f} ms at the HBM rate)")
    if need_bf16 is not None:
        line += (f"; held in bf16 {need_bf16 / 1e6:.1f} MB, bound "
                 f"{need_bf16 / hbm * 1e3:.4f} ms")
    print(line, flush=True)
    return per_call, only, count


@torch.no_grad()
def main() -> None:
    dev = _backend.device()
    _backend.kernel_library()
    hbm = card_peaks(torch.cuda.get_device_name(dev)).hbm_gb_s * 1e9
    suite = flagship_suite(dev, results_directory=REPO / "build"
                           / "batched_apply_profile")
    common = suite._batched_common()
    a_data = (common["a_tilde"], common["d_sqrt"])
    b = common["b"]
    n_cases, n = b.shape
    f32, vec = 4, n_cases * n * 4

    apply_fn, m_data, _ = suite._batched_setup("learned", 1, CHUNK,
                                               m_dtype=torch.bfloat16)
    bands, q, inner = m_data
    d_max, degree = bands.shape[1], q.shape[1] - 1
    print(f"{torch.cuda.get_device_name(dev)}; torch {torch.__version__}; "
          f"{n_cases} cases, n_pad {n}, bands {tuple(bands.shape)} "
          f"{bands.dtype}, A~ {tuple(common['a_tilde'].shape)} "
          f"{common['a_tilde'].dtype}, degree {degree}")
    band_b = bands.numel() * bands.element_size()
    a_b = n_cases * n * n * f32
    # one C^T r: bands + r in, t out; the eager form writes and reads the
    # (B, n, D) float32 products
    prod = n_cases * n * d_max * f32
    report("C^T r band pass (unfold)", lambda: banded_upper_matvec(bands, b),
           dev, hbm, band_b + 2 * vec, temp=2 * prod)
    # one C t: bands + t in, z out; the eager form writes the products,
    # copies them padded to n + D and reads the padded copy
    report("C t band pass (skew)", lambda: banded_lower_matvec(bands, b),
           dev, hbm, band_b + 2 * vec, temp=4 * prod)
    report("inner matvec (A~ bf16-rounded, held float32)",
           lambda: _scaled_dense_matvec_fast(inner, b), dev, hbm,
           a_b + 3 * vec, need_bf16=a_b // 2 + 3 * vec)
    report("solver matvec (A~ float32)",
           lambda: _scaled_dense_matvec(a_data, b), dev, hbm, a_b + 3 * vec)
    # the apply: 1 + 2 * degree passes of each band kind and 2 * degree
    # inner matvecs (Horner on q(B) and q(B)^T, each B = C^T A C)
    passes = 1 + 2 * degree
    apply_need = (2 * passes * (band_b + 2 * vec)
                  + 2 * degree * (a_b + 3 * vec))
    report(f"learned apply ({passes} + {passes} band passes, {2 * degree} "
           "inner matvecs)", lambda: apply_fn(m_data, b), dev, hbm,
           apply_need, temp=passes * 6 * prod,
           need_bf16=apply_need - degree * a_b)

    def learned_solve():
        return batched_pcg_fixed_trips(
            _scaled_dense_matvec, a_data, b, apply_fn, m_data,
            rtol=suite.rtol, max_iter=suite.max_iter, trips=TRIPS)

    solve = time_call(learned_solve, dev, reps=5) * 1e3
    count, busy = launches(learned_solve, dev)
    print(f"learned PCG iteration: {solve / TRIPS:.4f} ms ({TRIPS} trips "
          f"{solve:.3f} ms), launches {count / TRIPS:.1f} per iteration "
          f"(profiled device time {busy / TRIPS:.4f} ms per iteration); "
          f"bound {(apply_need + a_b) / hbm * 1e3:.4f} ms (apply and "
          "solver matvec)", flush=True)
    del m_data, bands, inner, apply_fn

    fsai_apply, m, _ = suite._batched_setup("fsai", 1, CHUNK,
                                            m_dtype=torch.bfloat16)
    report("fsai apply (M bf16-rounded, held float32)",
           lambda: fsai_apply(m, b), dev, hbm, a_b + 2 * vec,
           need_bf16=a_b // 2 + 2 * vec)
    assert fsai_apply is _dense_apply_batched_bf16
    fsai_trips = 30

    def fsai_solve():
        return batched_pcg_fixed_trips(
            _scaled_dense_matvec, a_data, b, fsai_apply, m,
            rtol=suite.rtol, max_iter=suite.max_iter, trips=fsai_trips)

    solve = time_call(fsai_solve, dev, reps=5) * 1e3
    count, busy = launches(fsai_solve, dev)
    print(f"fsai PCG iteration: {solve / fsai_trips:.4f} ms ({fsai_trips} "
          f"trips {solve:.3f} ms), launches {count / fsai_trips:.1f} per "
          f"iteration (profiled device time {busy / fsai_trips:.4f} ms per "
          f"iteration); bound {2 * a_b / hbm * 1e3:.4f} ms (apply and "
          "solver matvec)", flush=True)


if __name__ == "__main__":
    main()
