"""The program's own spans in a traced loop: the ``rt.*`` host spans that
``raytpu_torch.utils.spans`` records under the profiler, read from the
window thread's host events of a :class:`profiling.Trace`, on the device
operations' clock, and the interval arithmetic the per-layer readers do
with them. A trace of a program without spans has none, and the readers
then report nothing.

Intervals are ``(start, end)`` in ns; a list of them is sorted and
disjoint (:func:`union`)."""

from __future__ import annotations

import bisect

STEP, LOOP, PREPASS = "rt.step", "rt.loop", "rt.prepass"


def union(intervals) -> list:
    """The sorted, disjoint union of ``intervals``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def intersect(a, b) -> list:
    """The intersection of two unions of intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(a, b) -> list:
    """``a`` less ``b``, both unions of intervals."""
    out = []
    for s, e in a:
        for bs, be in b:
            if be <= s or bs >= e:
                continue
            if bs > s:
                out.append((s, bs))
            s = max(s, be)
            if s >= e:
                break
        if s < e:
            out.append((s, e))
    return out


def length_ns(intervals) -> int:
    return sum(e - s for s, e in intervals)


def spans(trace, name: str) -> list:
    """The union of the window thread's host spans named ``name``."""
    return union((s, e) for s, e, n, _ in trace._host if n == name)


def idle(trace) -> list:
    """The device's idle intervals inside the traced window."""
    w0, w1 = trace.window
    edges = [w0] + [x for iv in trace.busy_intervals() for x in iv] + [w1]
    return [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]


def idle_ms_per_frame(trace, inside: str, outside: str = None):
    """Device-idle ms a frame that lies inside the spans ``inside`` and
    outside the spans ``outside``; None without device operations or
    without an ``inside`` span."""
    where = spans(trace, inside)
    if not trace.device or not where:
        return None
    if outside:
        where = subtract(where, spans(trace, outside))
    return length_ns(intersect(idle(trace), where)) * 1e-6 / trace.frames


def issued_inside(trace, name: str) -> list:
    """The device operations whose host runtime call (``DeviceOp.issued``)
    lies inside a span ``name``."""
    where = spans(trace, name)
    starts = [s for s, _ in where]
    out = []
    for d in trace.device:
        i = bisect.bisect_right(starts, d.issued) - 1
        if i >= 0 and d.issued <= where[i][1]:
            out.append(d)
    return out
