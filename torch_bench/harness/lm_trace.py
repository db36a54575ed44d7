"""A traced window as ``harness/trace.py`` takes it (the same lead, marker
and ``torch_bench.window`` annotation), with each device operation's
launch on the host's clock, and the device time of the kernels launched
inside the program's spans (``repro_torch.obs``).

A kernel, copy or set carries the correlation id of the CUDA runtime call
that launched it (``cudaLaunchKernel`` and the like, a host record); where
the trace holds no such call, the host operation it is linked to (the
innermost PyTorch op around the launch) stands in.  Spans are laid on the
trace's clock as ``harness/spans.py`` lays them: the recording opens first
thing inside the window's annotation.  A device operation belongs to a
span when its launch lies inside it: one thread launches at a time here
(the training loop waits in autograd's call while autograd's device
thread runs the backward), so launches inside a span are its own.
"""

from __future__ import annotations

import time

import torch

from torch_bench.harness import spans as spans_mod
from torch_bench.harness import trace as trace_mod

SCAN = spans_mod.PREFIX + "model.ssd"
SCAN_BWD = spans_mod.PREFIX + "model.ssd_bwd"
RUNTIME = ("cuda", "cu")  # CUDA runtime and driver calls' names


class LaunchTrace(trace_mod.Trace):
    """A :class:`harness.trace.Trace` with ``launched``: the host-clock ns
    at which each device operation was launched, in ``device_ops``'s
    order (None where the trace links none)."""

    def __init__(self, device_ops, host_ops, window, launched):
        super().__init__(device_ops, host_ops, window)
        self.launched = launched

    def launched_inside(self, intervals) -> list:
        """The device operations launched inside the disjoint, sorted
        ``(start, end)`` ``intervals``: their indices in ``device_ops``."""
        import bisect
        starts = [s for s, _ in intervals]
        out = []
        for i, t in enumerate(self.launched):
            if t is None:
                continue
            k = bisect.bisect_right(starts, t) - 1
            if k >= 0 and t < intervals[k][1]:
                out.append(i)
        return out


def _records(prof) -> list:
    """(name, is_device, start ns, end ns, correlation id, linked
    correlation id) of every record."""
    from torch.autograd import DeviceType
    return [(e.name(), e.device_type() == DeviceType.CUDA, e.start_ns(),
             e.start_ns() + e.duration_ns(), e.correlation_id(),
             e.linked_correlation_id())
            for e in prof.profiler.kineto_results.events()]


def traced(fn, device):
    """(``fn()``'s result, :class:`LaunchTrace` of it).  ``fn`` ends in a
    device synchronisation."""
    from torch.profiler import ProfilerActivity, profile, record_function

    lead = torch.zeros((1 << 16,), device=device)
    marker = torch.zeros((1,), dtype=torch.int16, device=device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        until = time.perf_counter() + trace_mod.LEAD_S
        while time.perf_counter() < until:
            lead.add_(1.0)
            torch.cuda.synchronize(device)
        marker.fill_(1)
        torch.cuda.synchronize(device)
        with record_function(trace_mod.WINDOW):
            ret = fn()
    recs = _records(prof)
    wins = [(s, e) for n, dev, s, e, _, _ in recs
            if n == trace_mod.WINDOW and not dev]
    if not wins:
        raise RuntimeError(f"the trace holds no {trace_mod.WINDOW} span")
    window = wins[-1]
    marks = [s for n, dev, s, _, _, _ in recs
             if dev and trace_mod.MARKER in n]
    after = marks[-1] if marks else window[0]
    runtime, ops = {}, {}
    for n, dev, s, _, corr, _ in recs:
        if not dev:
            (runtime if n.startswith(RUNTIME) else ops)[corr] = s
    device_ops, launched = [], []
    for n, dev, s, e, corr, linked in recs:
        if (dev and s >= after and e > window[0] and s < window[1]
                and trace_mod.MARKER not in n and n != trace_mod.WINDOW):
            device_ops.append((n, max(s, window[0]), min(e, window[1])))
            launched.append(runtime.get(corr, ops.get(linked)))
    host_ops = [(n, s, e) for n, dev, s, e, _, _ in recs
                if not dev and n != trace_mod.WINDOW
                and window[0] <= s < window[1]]
    return ret, LaunchTrace(device_ops, host_ops, window, launched)


def scan_ops(trace, rec):
    """The indices of the device operations the SSD scan launched in its
    forward (and recompute) and backward spans, or None when the window
    holds none of either span, or another count of one than its counter
    (``ssd_calls``, ``ssd_bwd_calls``) says the program made."""
    if trace is None or rec is None or not isinstance(trace, LaunchTrace):
        return None
    spans = [s for s in spans_mod.mapped(trace, rec) if s is not None]
    fwd = [s for s in spans if s[0] == SCAN]
    bwd = [s for s in spans if s[0] == SCAN_BWD]
    c = rec.counters
    if (not fwd or not bwd or len(fwd) != c.get("ssd_calls")
            or len(bwd) != c.get("ssd_bwd_calls")):
        return None
    return trace.launched_inside(spans_mod.union(
        (s, e) for _, s, e, _, _ in fwd + bwd))


def scan_ms_per_step(trace, rec):
    """The device ms of the operations the scan launched (:func:`scan_ops`)
    over the steps the traced call made (the ``steps`` counter), or
    None."""
    idx = scan_ops(trace, rec)
    if not idx or rec.counters.get("steps", 0) <= 0:
        return None
    seconds = sum(trace.device_ops[i][2] - trace.device_ops[i][1]
                  for i in idx) / 1e9
    return seconds * 1e3 / rec.counters["steps"]


def breakdown(trace, rec, n: int = 10) -> dict:
    """The scan's share of the traced window: its device operations summed
    by name (the largest ``n``), their seconds and count, the spans and
    counters that select them, and the share of device operations whose
    launch the trace links."""
    idx = scan_ops(trace, rec) or []
    by = {}
    for i in idx:
        name, s, e = trace.device_ops[i]
        by[name] = by.get(name, 0.0) + (e - s) / 1e9
    named = [s for s in spans_mod.mapped(trace, rec) if s is not None] \
        if rec is not None else []
    return {"scan_ops": sorted(([k[:120], v] for k, v in by.items()),
                               key=lambda kv: -kv[1])[:n],
            "scan_s": sum(by.values()), "scan_op_count": len(idx),
            "spans": {name: sum(1 for s in named if s[0] == name)
                      for name in (SCAN, SCAN_BWD)},
            "counters": ({k: rec.counters.get(k) for k in
                          ("steps", "ssd_calls", "ssd_bwd_calls")}
                         if rec is not None else {}),
            "launch_linked_pct": (100.0 * sum(t is not None for t in
                                              trace.launched)
                                  / max(len(trace.launched), 1))}
