"""CUDA-graph replay for the port: which calls are replayed, under which
key, and how.

A caller (the single-system PCG chunk, ``solvers/cg.py``; the learned
setup, ``models/neural_fsai.py``) keeps one ``GraphEntry`` per key in a
``GraphCache``: at most ``GRAPH_KEYS`` keys, the least recently used
dropped first, each captured on its ``capture_on``-th call (the calls
before run eagerly and are only counted).

``walk`` turns a call's operand tree (tensors, tuples, None, dataclasses)
into a key part and its tensors.  A tensor enters by shape, strides,
dtype and device; a dataclass by its class and its ``init`` fields in
order, but for a field declared ``UNKEYED``: a field that holds a tensor,
a dataclass or a tuple with one of them inside (a multigrid's levels) is
walked, any other (an int, a float, a tuple of ints, None) enters by
value.  Which tensors and dataclasses are one object enters too, however
deep.  Anything else raises TypeError, and the call stays eager.  The
caller adds to the key what else its graphs bake in.

An entry rebuilds the tree over new tensors of the same layouts and
sharing (``static_copy``: an ``init=False`` field, such as a cached
launch plan, left at its default, an ``UNKEYED`` one carried from the
key's first call), copies each call's tensors in (``load``) and captures
its caller's stages (``capture_graphs``): a warm-up runs eagerly on a
side stream, then each stage is captured there, all in one memory pool.
A replay runs the same kernels in the same order on the static buffers,
so it gives the same bits.  A capture launches nothing: the ``_backend``
launch counts it made are taken back out, and each replay adds them.

A call stays eager (``eager_because``) under grad mode where an input
tensor or a given parameter needs a gradient ("grad"), and where an input
is not on a CUDA device ("device").  A callable replayed inside a graph
is declared ``capture_safe``.
"""

from __future__ import annotations

import itertools
from collections import OrderedDict
from dataclasses import fields, is_dataclass, replace
from typing import Callable

import torch

from deeppreconditioning_tpu_torch._backend import (
    add_launches,
    launch_state,
    launches_since,
)

GRAPH_KEYS = 8  # keys a ``GraphCache`` keeps, captured or waiting
UNKEYED = {"graph_key": False}  # a dataclass field's metadata: not keyed


def capture_safe(fn: Callable) -> Callable:
    """Declare ``fn`` safe to capture in a CUDA graph: it launches on the
    current stream, reads no device value on the host, and what it
    launched, replayed, recomputes from its operands' buffers.  Returns
    ``fn``."""
    fn.capture_safe = True
    return fn


def eager_because(tensors, params=()) -> str | None:
    """Why a call with input ``tensors`` (``walk``'s) and ``params`` runs
    eagerly ("grad": under grad mode one of them needs a gradient;
    "device": an input is not on a CUDA device), or None where it may be
    replayed from CUDA graphs."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in itertools.chain(tensors, params)):
        return "grad"
    if not all(t.is_cuda for t in tensors):
        return "device"
    return None


def _keyed(obj):
    """(field name, value) of ``obj``'s keyed ``init`` fields, in order."""
    return [(f.name, getattr(obj, f.name)) for f in fields(obj)
            if f.init and f.metadata.get("graph_key", True)]


def _walked(value) -> bool:
    """Whether a dataclass field's ``value`` is walked (a tensor, a
    dataclass, or a tuple holding one of them) rather than keyed by
    value."""
    if torch.is_tensor(value) or is_dataclass(value):
        return True
    return isinstance(value, tuple) and any(_walked(v) for v in value)


def walk(tree) -> tuple:
    """(key part, the tensors of ``tree`` in walk order, each once)."""
    tensors: list = []
    return _key(tree, tensors, {}), tensors


def _key(tree, tensors: list, memo: dict):
    if torch.is_tensor(tree) or is_dataclass(tree):
        if id(tree) in memo:
            return ("same", memo[id(tree)])
        memo[id(tree)] = len(memo)
        if torch.is_tensor(tree):
            tensors.append(tree)
            return ("tensor", tree.shape, tree.stride(), tree.dtype,
                    tree.device)
        return (type(tree), *(
            _key(value, tensors, memo) if _walked(value) else value
            for _, value in _keyed(tree)))
    if isinstance(tree, tuple):
        return ("tuple", *(_key(t, tensors, memo) for t in tree))
    if tree is None:
        return None
    raise TypeError(f"no graph key for {type(tree).__name__}")


def static_copy(tree) -> tuple:
    """(``tree`` rebuilt over new, empty tensors of each tensor's layout
    with the same sharing, those tensors in ``walk``'s order)."""
    tensors: list = []
    return _copy(tree, tensors, {}), tensors


def _copy(tree, tensors: list, memo: dict):
    if torch.is_tensor(tree) or is_dataclass(tree):
        if id(tree) in memo:
            return memo[id(tree)]
        if torch.is_tensor(tree):
            out = torch.empty_strided(tree.shape, tree.stride(),
                                      dtype=tree.dtype, device=tree.device)
            tensors.append(out)
        else:
            out = replace(tree, **{
                name: _copy(value, tensors, memo)
                for name, value in _keyed(tree) if _walked(value)})
        memo[id(tree)] = out
        return out
    if isinstance(tree, tuple):
        return tuple(_copy(t, tensors, memo) for t in tree)
    return tree


class CapturedGraph:
    """A captured CUDA graph and the counts its capture took back out
    (``launches_since``): a replay runs the graph and adds them."""

    def __init__(self, graph, counts: tuple) -> None:
        self.graph, self.counts = graph, counts

    def replay(self) -> None:
        self.graph.replay()
        add_launches(self.counts)


def capture_graphs(device, warm, *fns) -> tuple:
    """Run ``warm`` eagerly on a side stream of ``device``, then capture
    each of ``fns`` there into a CUDA graph, all in the first graph's
    memory pool, in order: (what ``warm`` returned, made usable on the
    caller's stream; the ``CapturedGraph``s).  ``capture_begin`` /
    ``capture_end`` and not ``torch.cuda.graph``, which before each
    capture synchronizes the device and empties the allocator's cache
    (and in some versions collects garbage): that costs more than the
    capture itself, and the side stream is idle already."""
    caller = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(caller)
    captured = []
    with torch.cuda.stream(side):
        warmed = warm()
        side.synchronize()
        for fn in fns:
            before = launch_state()
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(
                pool=captured[0].graph.pool() if captured else None)
            try:
                fn()
            finally:
                graph.capture_end()
            captured.append(CapturedGraph(graph, launches_since(before)))
    caller.wait_stream(side)
    if warmed is not None:
        warmed.record_stream(caller)
    return warmed, captured


class GraphEntry:
    """One key's static operand tree; a caller's subclass adds its state
    and stages, ``load``s the first call's tensors and keeps the graphs
    ``capture_graphs`` captures over them."""

    def __init__(self, operands, device) -> None:
        self.operands, self.statics = static_copy(operands)
        self.device = device

    def load(self, tensors) -> None:
        """Copy a call's tensors (``walk``'s) into the static ones."""
        for static, value in zip(self.statics, tensors):
            static.copy_(value)


def _drop_oldest(entries: OrderedDict) -> None:
    while len(entries) > GRAPH_KEYS:
        entries.popitem(last=False)


class GraphCache(OrderedDict):
    """A caller's entries by key, the least recently used first and
    dropped first beyond ``GRAPH_KEYS``.  A key is captured on its
    ``capture_on``-th call; the calls before are only counted
    (``waiting``, bounded likewise)."""

    def __init__(self, capture_on: int = 1) -> None:
        super().__init__()
        self.capture_on = capture_on
        self.waiting: OrderedDict = OrderedDict()  # key -> its calls

    def lookup(self, key, capture):
        """The entry of ``key``: the cached one, or ``capture()``'s on the
        key's ``capture_on``-th call; None on an earlier call."""
        if key in self:
            self.move_to_end(key)
            return self[key]
        calls = self.waiting.pop(key, 0) + 1
        if calls < self.capture_on:
            self.waiting[key] = calls
            _drop_oldest(self.waiting)
            return None
        entry = self[key] = capture()
        _drop_oldest(self)
        return entry

    def clear(self) -> None:
        super().clear()
        self.waiting.clear()
