"""The profiler's view of the measured window, and what the per-layer
readers read from it.

One profiler session (CPU and CUDA activity) spans the window.  The
profiler drops the first device records of some sessions, so the session
opens with a lead of small kernels, then a one-element int16 ``fill_`` as
a marker; device records before the marker are left out.  The window is
the ``torch_bench.window`` annotation's span on the trace's clock (the
profiler draws the annotation on the device's timeline too: that copy is
no device operation).

From the records: each device operation (kernel, copy, set) as ``(name,
start, end)`` in ns inside the window, the busy time (the union of their
intervals), and the idle gaps between them, each labelled with the
outermost host operation running at its middle.
"""

from __future__ import annotations

import bisect
import time

import torch

WINDOW = "torch_bench.window"
MARKER = "FillFunctor<short>"
LEAD_S = 0.3


class Trace:
    """What a traced window recorded; per-layer readers get it as
    ``ctx.trace``."""

    def __init__(self, device_ops, host_ops, window):
        self.window = window                       # (start, end) ns
        self.device_ops = device_ops               # [(name, start, end)]
        self.host_ops = host_ops                   # [(name, start, end)]
        self.window_s = (window[1] - window[0]) / 1e9
        self.busy_s = _union(device_ops) / 1e9

    def seconds(self, pick) -> tuple:
        """(seconds, count) of the device operations whose name ``pick``
        accepts."""
        sel = [e - s for n, s, e in self.device_ops if pick(n)]
        return sum(sel) / 1e9, len(sel)

    def top_ops(self, n: int = 10) -> list:
        by = {}
        for name, s, e in self.device_ops:
            by[name] = by.get(name, 0.0) + (e - s) / 1e9
        return sorted(([k[:120], v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """The idle seconds of the window summed by what the host was doing
        (the outermost host operation at each gap's middle), the largest
        ``n``."""
        outer = _outermost(self.host_ops)
        starts = [s for _, s, _ in outer]
        by = {}
        for s, e in _gaps(self.device_ops, self.window):
            mid = (s + e) // 2
            i = bisect.bisect_right(starts, mid) - 1
            label = (outer[i][0] if i >= 0 and mid < outer[i][2]
                     else "host Python, no op")
            by[label] = by.get(label, 0.0) + (e - s) / 1e9
        return sorted(([k[:120], v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]


def _outermost(ops) -> list:
    """The operations no other one encloses, by start: each later one
    starts after every earlier one has ended."""
    out, end = [], None
    for name, s, e in sorted(ops, key=lambda o: (o[1], -o[2])):
        if end is None or s >= end:
            out.append((name, s, e))
            end = e
        elif e > end:  # overlaps without nesting: extend the earlier
            end = e
    return out


def _union(ops) -> int:
    total, end = 0, None
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _gaps(ops, window) -> list:
    out, at = [], window[0]
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if window[1] > at:
        out.append((at, window[1]))
    return out


def _records(prof) -> list:
    """(name, is_device, start ns, end ns) of every record."""
    from torch.autograd import DeviceType
    try:
        evs = prof.profiler.kineto_results.events()
        return [(e.name(), e.device_type() == DeviceType.CUDA, e.start_ns(),
                 e.start_ns() + e.duration_ns()) for e in evs]
    except AttributeError:  # another torch: the slower public list
        return [(e.name, e.device_type == DeviceType.CUDA,
                 int(e.time_range.start * 1000), int(e.time_range.end * 1000))
                for e in prof.events()]


def traced(fn, device):
    """(``fn()``'s result, :class:`Trace` of it).  ``fn`` ends in a
    device synchronisation."""
    from torch.profiler import ProfilerActivity, profile, record_function

    lead = torch.zeros((1 << 16,), device=device)
    marker = torch.zeros((1,), dtype=torch.int16, device=device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        until = time.perf_counter() + LEAD_S
        while time.perf_counter() < until:
            lead.add_(1.0)
            torch.cuda.synchronize(device)
        marker.fill_(1)
        torch.cuda.synchronize(device)
        with record_function(WINDOW):
            ret = fn()
    recs = _records(prof)
    spans = [(s, e) for n, dev, s, e in recs if n == WINDOW and not dev]
    if not spans:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    window = spans[-1]
    marks = [s for n, dev, s, e in recs if dev and MARKER in n]
    after = marks[-1] if marks else window[0]
    device_ops = [(n, max(s, window[0]), min(e, window[1]))
                  for n, dev, s, e in recs
                  if dev and s >= after and e > window[0] and s < window[1]
                  and MARKER not in n and n != WINDOW]
    host_ops = [(n, s, e) for n, dev, s, e in recs
                if not dev and n != WINDOW and window[0] <= s < window[1]]
    return ret, Trace(device_ops, host_ops, window)
