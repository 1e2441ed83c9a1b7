"""loop.graph_pct: how often the bounce loop replays CUDA graphs rather
than launching its waves from Python, x100: replays / (replays + eager wave
steps) over the traced loop. Replays are the program's host events named
``rt.graph.replay``; eager wave steps its ``rt.bounce`` events that lie in
no ``rt.graph.capture`` span (a capture records a bounce without running
it). Events are counted one by one, not as a union of intervals. Nothing
is read where neither event occurs (a program without graphs and spans)."""

import bisect

from rtbench import spans

REPLAY, BOUNCE, CAPTURE = "rt.graph.replay", "rt.bounce", "rt.graph.capture"


def read(ctx):
    host = ctx.trace._host
    captures = spans.spans(ctx.trace, CAPTURE)
    starts = [s for s, _ in captures]

    def captured(start, end):
        i = bisect.bisect_right(starts, start) - 1
        return i >= 0 and end <= captures[i][1]

    replays = sum(name == REPLAY for _, _, name, _ in host)
    eager = sum(name == BOUNCE and not captured(s, e) for s, e, name, _ in host)
    if not replays + eager:
        return None
    return 100.0 * replays / (replays + eager)
