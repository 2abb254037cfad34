"""Arithmetic of the readers of the port's own spans and counters
(``deeppreconditioning_tpu_torch/utils/tracing.py``).

The port records them while a ``torch.profiler`` records, so over the
traced slice alone.  ``recorded`` takes the tracer's snapshot once per
view and resets the tracer, so that a later traced run in the process
starts clean, and keeps the snapshot on the view for every other reader.
A port without the tracer gives None, and so does a span or counter the
slice did not reach: the metric is then left out of the line.
"""

from __future__ import annotations


def recorded(view):
    """The tracer's snapshot of the slice (``tracing.snapshot()``), or
    None where the port has no tracer."""
    if "program" not in vars(view):
        try:
            from deeppreconditioning_tpu_torch.utils import tracing
        except ImportError:
            view.program = None
        else:
            view.program = tracing.snapshot()
            tracing.reset()
    return view.program


def _span(view, name: str):
    snap = recorded(view)
    if snap is None or not view.records:
        return None
    return snap["spans"].get(name)


def per_request(view, name: str, key: str):
    """``key`` (``host_ms``, ``self_host_ms``, ``device_ms``) summed over
    span ``name``'s calls, a traced request."""
    row = _span(view, name)
    return None if row is None else row[key] / len(view.records)


def per_call(view, name: str, key: str):
    """``key`` of span ``name``, mean a call."""
    row = _span(view, name)
    return None if row is None else row[key] / row["calls"]


def masked_share(view):
    """The share of the PCG iterations executed that came after their
    system had stopped, in %: 100 (1 - the iterations the port returned /
    ``pcg.system_iterations``)."""
    snap = recorded(view)
    if snap is None or not view.records:
        return None
    executed = snap["counters"].get("pcg.system_iterations", 0)
    if executed <= 0:
        return None
    useful = sum(i for r in view.records for i in r.iterations)
    return 100.0 * (1.0 - useful / executed)
