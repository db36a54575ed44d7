"""The program's spans and counters (``repro_torch.obs``) laid on a traced
window (``harness/trace.py``), and the four numbers read from them.

A recording opened first thing inside the window's annotation starts at
the annotation's start: the difference of the two is the offset from the
recorder's clock (``time.time_ns()``) to the trace's, by which every span
is moved onto the trace's clock.  Each number is ``None`` where the window
holds none of its spans, or another count of them than the program's
counter says it made (the spans then do not cover what was counted).

- ``staging_host_ms_per_step``: host time in ``data.stage`` spans, less
  their ``wait`` children, a step;
- ``staging_idle_pct``: the share of the window in which the device is idle
  while the host's innermost span is staging (not a wait in it), in %;
- ``host_wait_ms_per_step``: host time in outermost ``wait`` spans a step;
- ``ckpt_stall_ms``: device-idle time inside checkpoint spans (the
  runner's drain before a save, ``runner.checkpoint``, and the manager's
  save, ``ckpt.save``), a checkpoint saved.
"""

from __future__ import annotations

import collections

from torch_bench.harness import trace as trace_mod

PREFIX = "repro_torch."
STAGE = PREFIX + "data.stage"
BATCH = PREFIX + "data.batch"
DISPATCH = PREFIX + "runner.dispatch"
CHECKPOINT = PREFIX + "runner.checkpoint"
SAVE = PREFIX + "ckpt.save"


def mapped(trace, rec) -> list:
    """``rec``'s finished spans as ``(name, start, end, parent, wait)`` on
    the trace's clock, clipped to the window."""
    off = trace.window[0] - rec.opened_ns
    lo, hi = trace.window
    return [(s.name, min(max(s.start_ns + off, lo), hi),
             min(max(s.end_ns + off, lo), hi), s.parent, s.wait)
            if s is not None else None for s in rec.spans]


def innermost(spans) -> list:
    """``[(start, end, i)]``: each stretch of time some span covers, with
    the index of the innermost span open there (spans of one thread nest
    by time)."""
    order = sorted((i for i, s in enumerate(spans) if s is not None),
                   key=lambda i: (spans[i][1], -spans[i][2]))
    out, stack, at = [], [], None

    def advance(upto):
        nonlocal at
        while stack and (at is None or at < upto):
            end, i = stack[-1]
            stop = min(end, upto)
            if at is not None and stop > at:
                out.append((at, stop, i))
                at = stop
            if end <= upto:
                stack.pop()
            else:
                break
        at = upto if at is None else max(at, upto)

    for i in order:
        advance(spans[i][1])
        stack.append((spans[i][2], i))
    if stack:
        advance(max(end for end, _ in stack))
    return out


def overlaps(a, b) -> list:
    """For each interval of ``b``, the ns it shares with ``a``; both lists
    of ``(start, end, ...)``, each disjoint and sorted by start."""
    out, i, j = [0] * len(b), 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        out[j] += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def overlap(a, b) -> int:
    """ns in both of two lists as :func:`overlaps` takes them."""
    return sum(overlaps(a, b))


def union(intervals) -> list:
    """The union of ``(start, end)`` intervals, disjoint and sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def idle(trace) -> list:
    """The window's idle gaps, disjoint and sorted."""
    return trace_mod._gaps(trace.device_ops, trace.window)


def _staging(spans, i) -> bool:
    """Whether span ``i`` is staging host work: under a ``data.stage``
    span, with no ``wait`` span on the way up."""
    while i >= 0 and spans[i] is not None:
        name, _, _, parent, wait = spans[i]
        if wait:
            return False
        if name == STAGE:
            return True
        i = parent
    return False


def _named(spans, name) -> list:
    return [s for s in spans if s is not None and s[0] == name]


def _outermost_waits(spans) -> list:
    def under_wait(s):
        p = s[3]
        while p >= 0 and spans[p] is not None:
            if spans[p][4]:
                return True
            p = spans[p][3]
        return False
    return [s for s in spans if s is not None and s[4] and not under_wait(s)]


def _staged_segments(trace, rec):
    spans = mapped(trace, rec)
    c = rec.counters
    if (not _named(spans, STAGE) or len(_named(spans, STAGE)) != c["chunks"]
            or len(_named(spans, BATCH)) != c["batches"]):
        return None
    return [seg for seg in innermost(spans) if _staging(spans, seg[2])]


def staging_host_ms_per_step(trace, rec):
    segs = _staged_segments(trace, rec)
    if segs is None or rec.counters["steps"] <= 0:
        return None
    return sum(e - s for s, e, _ in segs) / 1e6 / rec.counters["steps"]


def staging_idle_pct(trace, rec):
    segs = _staged_segments(trace, rec)
    if segs is None:
        return None
    window = trace.window[1] - trace.window[0]
    return 100.0 * overlap(idle(trace), segs) / window


def host_wait_ms_per_step(trace, rec):
    spans = mapped(trace, rec)
    c = rec.counters
    waits = _outermost_waits(spans)
    if (not waits or c["steps"] <= 0
            or len(_named(spans, DISPATCH)) != (c["chunks"] or c["steps"])):
        return None
    return sum(e - s for _, s, e, _, _ in waits) / 1e6 / c["steps"]


def ckpt_stall_ms(trace, rec):
    spans = mapped(trace, rec)
    saves = _named(spans, SAVE)
    if not saves or len(saves) != rec.counters["ckpt_saves"]:
        return None
    under = union((s, e) for _, s, e, _, _ in saves + _named(spans, CHECKPOINT))
    return overlap(idle(trace), under) / 1e6 / len(saves)


READERS = {f.__name__: f for f in (staging_host_ms_per_step,
                                   staging_idle_pct, host_wait_ms_per_step,
                                   ckpt_stall_ms)}


def breakdown(trace, rec) -> dict:
    """By span name: the count, the host ms a step with it innermost, and
    the idle seconds under it; beside them the share of the window under
    any span and of the idle time under none."""
    spans = mapped(trace, rec)
    segs = innermost(spans)
    gaps = idle(trace)
    steps = max(rec.counters["steps"], 1)
    counts = collections.Counter(s[0] for s in spans if s is not None)
    by = {}
    for (s, e, i), idle_ns in zip(segs, overlaps(gaps, segs)):
        name = spans[i][0]
        row = by.setdefault(name[len(PREFIX):], {
            "count": counts[name], "self_ms_per_step": 0.0, "idle_s": 0.0})
        row["self_ms_per_step"] += (e - s) / 1e6 / steps
        row["idle_s"] += idle_ns / 1e9
    covered = union((s, e) for s, e, _ in segs)
    window = trace.window[1] - trace.window[0]
    idle_ns = sum(e - s for s, e in gaps)
    return {"spans": by,
            "covered_pct": 100.0 * sum(e - s for s, e in covered) / window,
            "idle_outside_spans_pct": (
                100.0 * (idle_ns - overlap(gaps, covered)) / idle_ns
                if idle_ns else 0.0)}
