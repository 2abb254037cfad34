"""The reader of the port's graphed PCG chunks (``solvers/cg.py``): the
share of the slice's PCG chunks replayed from a CUDA graph.

A port whose solver declares no capture-safe callable (``capture_safe``)
has no graphed chunk: the share is then None and left out of the line,
as it is for a slice that ran no chunk."""

from __future__ import annotations

from portbench.harness.program import recorded


def graph_share(view):
    """100 x the port's counter ``pcg.graph_chunks`` over the calls of
    span ``pcg.chunk``, in %."""
    snap = recorded(view)
    if snap is None or not view.records:
        return None
    chunks = snap["spans"].get("pcg.chunk", {}).get("calls", 0)
    try:
        from deeppreconditioning_tpu_torch.solvers.cg import (  # noqa: F401
            capture_safe,
        )
    except ImportError:
        return None
    if chunks <= 0:
        return None
    return 100.0 * snap["counters"].get("pcg.graph_chunks", 0) / chunks
