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
timeline too, as a device record over the host's work.  Spans are recorded from one thread, the one that launches the work.

Counters are plain integers, always on, like the kernel wrappers'
``.launches``; :func:`counters` is their snapshot, and a recording keeps
their change while it was open.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import NamedTuple

_COUNTERS = dict.fromkeys(("steps", "chunks", "batches", "ckpt_saves"), 0)


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
    _open: list = dataclasses.field(default_factory=list)


_NULL = contextlib.nullcontext()
_rec: _Recording | None = None


class _Open:
    __slots__ = ("rec", "name", "wait", "index", "parent", "start")

    def __init__(self, rec, name, wait):
        self.rec, self.name, self.wait = rec, name, wait

    def __enter__(self):
        rec = self.rec
        self.parent = rec._open[-1].index if rec._open else -1
        self.index = len(rec.spans)
        rec.spans.append(None)  # filled in at the span's end
        rec._open.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        rec = self.rec
        rec._open.pop()
        rec.spans[self.index] = Span(self.name, self.start, end, self.parent,
                                     self.wait)
        return False


def span(name: str, *, wait: bool = False):
    """A context that records ``name``'s stretch of host time while a
    recording is open (module docstring)."""
    if _rec is None:
        return _NULL
    return _Open(_rec, name, wait)


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
