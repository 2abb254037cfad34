"""Arithmetic shared by the per-layer metrics' readers (``metrics/``).

Every reader takes the ``View`` of the traced slice and returns a number,
or None where the slice holds nothing to read (no request, no kernel of
the name, no card)."""

from __future__ import annotations


def mean_span(view, name: str):
    values = [r.spans[name] for r in view.records if name in r.spans]
    return sum(values) / len(values) if values else None


def roofline(view, word: str, counter: str, key: str):
    """A kernel's share of its roofline over the slice, in %: the least
    time of the work the slice's requests need (``cell.work(...)[key]``)
    over the device time of the kernels whose name holds ``word``.  None
    unless the trace holds every launch the port counted."""
    if view.peaks is None or not view.records:
        return None
    seconds, launches = view.trace.kernel_seconds(word)
    if launches == 0 or launches != view.launch_counts.get(counter):
        return None
    bound = sum(view.cell.work(r)[key].bound_s(view.peaks)
                for r in view.records)
    return 100.0 * bound / seconds


def idle_share(view):
    """The slice's share with no kernel, copy or set on the card, in %."""
    if view.peaks is None or view.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - view.trace.busy_s / view.trace.window_s)


def mfu(view):
    """The flops the slice's requests need over its length, against the
    card's float32 peak, in %."""
    if view.peaks is None or not view.records:
        return None
    flops = sum(view.cell.work(r)["flops"] for r in view.records)
    return 100.0 * flops / (view.trace.window_s
                            * view.peaks.fp32_tflop_s * 1e12)


def launches_per_request(view):
    if view.peaks is None or not view.records or not view.trace.launch_calls:
        return None
    return view.trace.launch_calls / len(view.records)


def mean_iterations(view):
    its = [i for r in view.records for i in r.iterations]
    return sum(its) / len(its) if its else None
