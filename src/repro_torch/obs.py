"""Spans and counters of the training path: what the host does, and where
it waits for the device.

``span(name, wait=...)`` marks a stretch of host time.  It is off unless
a :func:`recording` is open: until then it returns one shared null
context, and the cost of a span is one module-level check.  While a
recording is open each span appends a :class:`Span` to its ``spans`` on
the host's Unix-epoch clock (``time.time_ns()``, the clock of the torch
profiler's host records), its ``parent`` the index of the span open
around it.
``wait=True`` marks a span in which the host blocks on the device.
Spans are never profiler ranges: a range would be drawn on the device's
timeline too, as a device record over the host's work.  Spans are
recorded from any thread: each thread nests its own, and a span's
``parent`` is the one open around it on its thread.  Autograd runs a
CUDA backward on a device thread of its own; :func:`backward_span`
records a stretch of that backward, opened and closed by gradient hooks.

Counters are plain integers, always on, like the kernel wrappers'
``.launches``; :func:`counters` is their snapshot, and a recording keeps
their change while it was open.  ``ssd_calls`` counts the SSD scan's
calls (``models.ssm``: a forward, and again where the backward recomputes
it), ``ssd_bwd_calls`` those made under grad outside a backward: each
one's backward is a ``model.ssd_bwd`` span once it has run.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import NamedTuple

import torch

_COUNTERS = dict.fromkeys(("steps", "chunks", "batches", "ckpt_saves",
                           "ssd_calls", "ssd_bwd_calls"), 0)


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int       # index of the enclosing span in the list, or -1
    wait: bool        # the host blocks on the device


@dataclasses.dataclass
class _Recording:
    opened_ns: int
    closed_ns: int = 0
    spans: list = dataclasses.field(default_factory=list)
    counters: dict = dataclasses.field(default_factory=dict)
    _open: dict = dataclasses.field(default_factory=dict)  # thread -> stack
    _lock: object = dataclasses.field(default_factory=threading.Lock)

    def slot(self, nest: bool, span) -> tuple:
        """(index, parent) of a span opening on this thread: its place in
        ``spans`` (filled in at its end), and the innermost span open on
        the thread; ``nest`` pushes it as the thread's innermost."""
        with self._lock:
            stack = self._open.setdefault(threading.get_ident(), [])
            parent = stack[-1].index if stack else -1
            index = len(self.spans)
            self.spans.append(None)
            if nest:
                stack.append(span)
        return index, parent


_NULL = contextlib.nullcontext()
_rec: _Recording | None = None


class _Open:
    __slots__ = ("rec", "name", "wait", "index", "parent", "start")

    def __init__(self, rec, name, wait):
        self.rec, self.name, self.wait = rec, name, wait

    def __enter__(self):
        self.index, self.parent = self.rec.slot(True, self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        rec = self.rec
        rec._open[threading.get_ident()].pop()
        rec.spans[self.index] = Span(self.name, self.start, end, self.parent,
                                     self.wait)
        return False


class _BackwardSpan:
    """The hooks of one :func:`backward_span`: the first output gradient
    to arrive opens the span, the last input gradient to complete closes
    it.  A hook that fires once the recording has closed records
    nothing."""

    def __init__(self, rec, name, n_inputs):
        self.rec, self.name, self.left = rec, name, n_inputs
        self.index = self.parent = self.start = None

    def open(self, grad):
        if self.start is None and _rec is self.rec:
            self.index, self.parent = self.rec.slot(False, self)
            self.start = time.time_ns()

    def close(self, grad):
        self.left -= 1
        if self.left == 0 and self.start is not None and _rec is self.rec:
            self.rec.spans[self.index] = Span(self.name, self.start,
                                              time.time_ns(), self.parent,
                                              False)


class _Through(NamedTuple):
    """:func:`backward_span`'s result: ``inputs`` to compute from, and
    ``mark(outputs)`` to call on what was computed from them."""
    inputs: tuple
    mark: object


def span(name: str, *, wait: bool = False):
    """A context that records ``name``'s stretch of host time while a
    recording is open (module docstring)."""
    if _rec is None:
        return _NULL
    return _Open(_rec, name, wait)


def _in_backward() -> bool:
    """Whether this thread runs inside a backward pass (where a
    checkpointed block is recomputed)."""
    return torch._C._current_graph_task_id() != -1


def backward_span(name: str, *inputs, counter: str) -> _Through:
    """Record ``name`` over the backward of what is computed from
    ``inputs``: compute from the returned ``inputs`` (views of the given
    ones, so that each one's gradient is that work's alone) and call
    ``mark(outputs)`` on the results.  A gradient hook on the outputs
    opens the span, on whatever thread autograd runs it; the hook of the
    last input whose gradient is complete closes it.  Nothing has a
    backward to record under ``no_grad``, inside a backward (a recompute's
    graph is never differentiated) or where no input needs a gradient;
    otherwise ``counter`` counts the call, and with a recording open the
    hooks are set."""
    live = [t.requires_grad for t in inputs]
    if not any(live) or _in_backward() or not torch.is_grad_enabled():
        return _Through(inputs, lambda *outputs: None)
    count(counter)
    rec = _rec
    if rec is None:
        return _Through(inputs, lambda *outputs: None)
    hooks = _BackwardSpan(rec, name, sum(live))
    views = tuple(t.view_as(t) if need else t
                  for t, need in zip(inputs, live))
    for t, need in zip(views, live):
        if need:
            t.register_hook(hooks.close)

    def mark(*outputs):
        for t in outputs:
            if t.requires_grad:
                t.register_hook(hooks.open)
    return _Through(views, mark)


def count(name: str, n: int = 1) -> None:
    _COUNTERS[name] += n


def counters() -> dict:
    return dict(_COUNTERS)


@contextlib.contextmanager
def recording():
    """``with recording() as rec:`` records spans until the block ends;
    then ``rec.counters`` holds each counter's change and
    ``rec.closed_ns`` the end."""
    global _rec
    if _rec is not None:
        raise RuntimeError("a recording is already open")
    before = counters()
    rec = _rec = _Recording(opened_ns=time.time_ns())
    try:
        yield rec
    finally:
        _rec = None
        rec.closed_ns = time.time_ns()
        rec.counters = {k: v - before[k] for k, v in _COUNTERS.items()}
