"""loop.idle_ms: device-idle ms a frame inside the program's ``rt.loop``
spans: the host's issue and syncs of the bounce loops, by interval
intersection."""

from rtbench import spans


def read(ctx):
    return spans.idle_ms_per_frame(ctx.trace, spans.LOOP)
