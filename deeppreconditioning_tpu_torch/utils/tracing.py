"""Spans and counters of the port, on the profiler's clock.

Tracing is on exactly while a ``torch.profiler`` records
(``torch.autograd._profiler_enabled()``); there is no flag, environment
variable or exporter of its own, and the profiler's chrome trace is the
export.  Off, ``span`` returns one shared context manager that does
nothing and ``count`` returns, each after that one C call: no
``record_function``, no event, no allocation.

On, ``with span(name, device):``

* opens ``torch.profiler.record_function(name)``, so the span is a
  ``user_annotation`` of the trace beside the kernels it launched;
* takes the host clock (``perf_counter_ns``) at both ends;
* times the device with an ``Interval``: a CUDA event pair on the
  device's current stream, the host clock on the CPU (or with no
  device);
* keeps, in memory, its name, its parent span and its root id, which
  every span under one outermost span shares (a request's identifier).

``count(name, n)`` adds ``n`` to a counter.  ``snapshot()`` resolves the
intervals (a CUDA event is read only then) and sums by span name;
``reset()`` forgets every span and counter.  Spans nest per thread.

The spans and counters the port records, and what reads them:

============================  ===============================================
``pcg.solve``                 one chunked PCG solve (``solvers/cg.py``), single
                              or batched; its children ``pcg.chunk`` (the
                              ``check_every`` masked iterations enqueued) and
                              ``pcg.read`` (each host read of ``done``, the
                              last included)
``pcg.system_iterations``     counter: systems x ``check_every`` per chunk,
                              the iterations executed, masked or not
``pcg.fused_iterations``      counter: ``check_every`` per chunk of the
                              single-system solver that ran through
                              ``ops.pcg_iteration`` (eager or replayed),
                              ``trips`` per ``pcg_fixed_trips`` solve
``pcg.graph_chunks``          counter: the single-system solver's chunks
                              replayed from a CUDA graph (each also a
                              ``pcg.chunk`` span)
``pcg.graph_captures``        counter: the operand signatures whose start and
                              chunk that solver captured
``pcg.operator_products``     counter: the products with the system's
                              operator that both solvers enqueue, at the
                              start and in each chunk: one an iteration,
                              and those the preconditioner declares
                              (``operator_products``, 2 x degree in the
                              structured polynomial apply); a replayed start
                              or chunk adds what its capture enqueued
``gmg.setup``                 ``ops.gmg.build_gmg``; children
                              ``gmg.galerkin`` (the levels' inverse
                              diagonals and Galerkin coarse operators, the
                              smoothers' FSAI setups left out) and
                              ``gmg.root`` (the root's dense assembly,
                              inverse and symmetrisation), eager or on the
                              card each around one CUDA graph replay
``fsai.setup``                ``neural_fsai_dense_preconditioner``; children
                              ``fsai.forward`` (the model: columns, B1, MLP)
                              and ``fsai.wrap`` (factor or strips, Gram form,
                              polynomial wrap), eager or each one CUDA graph
                              replay
``fsai.graph_setups``         counter: the setups replayed from CUDA graphs
                              (each also an ``fsai.setup`` span)
``fsai.graph_captures``       counter: the setup signatures whose forward and
                              wrap graphs were captured (on a signature's
                              second call)
``structured.plan``           ``build_structured_plan`` (host): the stencil
                              read from the operator's offsets and the
                              cached pattern
``structured.setup``          ``structured_setup``; children
                              ``structured.columns`` (sort, scale, local
                              solves), ``structured.refine`` (the MLP) and
                              ``structured.safeguard`` (``poly_safeguard``)
``train.forward``,            the parts of a train step
``train.backward``,           (``train/trainer._optimize``): the objective,
``train.adam``                its backward, the optimizer's ``zero_grad``
                              and ``step``
============================  ===============================================

The benchmark's per-layer metrics read them (``portbench/harness/
program.py``).
"""

from __future__ import annotations

import itertools
import threading
import time

import torch

_enabled = torch.autograd._profiler_enabled


class Interval:
    """A stretch of device time, resolved when read: a CUDA event pair on
    the current stream of a CUDA device, the host clock on any other
    device (there the host clock is the device clock) or with none."""

    __slots__ = ("_stream", "_begun", "_ended")

    def __init__(self, device=None) -> None:
        self._stream = None
        if device is not None and torch.device(device).type == "cuda":
            self._stream = torch.cuda.current_stream(device)
            self._begun = torch.cuda.Event(enable_timing=True)
            self._begun.record(self._stream)
        else:
            self._begun = time.perf_counter_ns()
        self._ended = None

    def stop(self) -> "Interval":
        if self._stream is not None:
            self._ended = torch.cuda.Event(enable_timing=True)
            self._ended.record(self._stream)
        else:
            self._ended = time.perf_counter_ns()
        return self

    def ms(self) -> float:
        """Milliseconds from start to stop (waits for the end event)."""
        if self._stream is not None:
            self._ended.synchronize()
            return self._begun.elapsed_time(self._ended)
        return (self._ended - self._begun) * 1e-6


class _Off:
    """The context manager of a span while nothing records.  Its enter
    and exit are a builtin that takes any arguments and returns "" (false:
    an exception goes on), so neither runs a Python frame; as methods
    they cost a span a third more on the host."""

    __slots__ = ()
    __enter__ = __exit__ = "".format


_OFF = _Off()
_LOCK = threading.Lock()
_LOCAL = threading.local()
_ROOT_IDS = itertools.count()
_SPANS: list = []  # finished spans, in order of their ends
_COUNTERS: dict = {}


class _Span:
    __slots__ = ("name", "device", "parent", "root", "host_ns", "child_ns",
                 "interval", "_annotation", "_t0")

    def __init__(self, name: str, device) -> None:
        self.name, self.device = name, device
        self.child_ns = 0

    def __enter__(self) -> None:
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        self.parent = stack[-1] if stack else None
        self.root = (self.parent.root if self.parent is not None
                     else next(_ROOT_IDS))
        self._annotation = torch.profiler.record_function(self.name)
        self._annotation.__enter__()
        self.interval = Interval(self.device)
        stack.append(self)
        self._t0 = time.perf_counter_ns()

    def __exit__(self, *exc) -> bool:
        self.host_ns = time.perf_counter_ns() - self._t0
        self.interval.stop()
        _LOCAL.stack.pop()
        self._annotation.__exit__(*exc)
        self._annotation = None
        if self.parent is not None:
            self.parent.child_ns += self.host_ns
        _SPANS.append(self)
        return False


def span(name: str, device=None):
    """A context manager that records span ``name`` while a profiler
    records; ``device`` (a ``torch.device`` or its name) is where its
    device time is taken."""
    if not _enabled():
        return _OFF
    return _Span(name, device)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while a profiler records."""
    if _enabled():
        with _LOCK:
            _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def snapshot() -> dict:
    """What was recorded since the last ``reset``:
    ``{"spans": {name: {"calls", "host_ms", "self_host_ms", "device_ms",
    "parents", "roots"}}, "counters": {name: n}}``.  ``self_host_ms`` is
    ``host_ms`` less the children's; ``parents`` maps the parents' names
    (None for an outermost span) to calls; ``roots`` counts the distinct
    outermost spans the name ran under."""
    spans, roots = {}, {}
    for s in list(_SPANS):
        row = spans.setdefault(s.name, {
            "calls": 0, "host_ms": 0.0, "self_host_ms": 0.0,
            "device_ms": 0.0, "parents": {}})
        row["calls"] += 1
        row["host_ms"] += s.host_ns * 1e-6
        row["self_host_ms"] += (s.host_ns - s.child_ns) * 1e-6
        row["device_ms"] += s.interval.ms()
        parent = None if s.parent is None else s.parent.name
        row["parents"][parent] = row["parents"].get(parent, 0) + 1
        roots.setdefault(s.name, set()).add(s.root)
    for name, row in spans.items():
        row["roots"] = len(roots[name])
    with _LOCK:
        counters = dict(_COUNTERS)
    return {"spans": spans, "counters": counters}


def reset() -> None:
    """Forget every span and counter recorded."""
    _SPANS.clear()
    with _LOCK:
        _COUNTERS.clear()
