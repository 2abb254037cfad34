"""The reader of the port's fused PCG iteration (``deeppreconditioning_
tpu_torch/ops/pcg_iteration.py``): the share of the slice's PCG
iterations that ran through it.

A port without the counter ``pcg.fused_iterations`` (one whose iteration
is not fused) gives None, and the metric is left out of the line, as it
is for a slice that ran no iteration."""

from __future__ import annotations

from portbench.harness.program import recorded


def fused_share(view):
    """100 x the port's counter ``pcg.fused_iterations`` over its counter
    ``pcg.system_iterations``, in %."""
    snap = recorded(view)
    if snap is None or not view.records:
        return None
    counters = snap["counters"]
    executed = counters.get("pcg.system_iterations", 0)
    if "pcg.fused_iterations" not in counters or executed <= 0:
        return None
    return 100.0 * counters["pcg.fused_iterations"] / executed
