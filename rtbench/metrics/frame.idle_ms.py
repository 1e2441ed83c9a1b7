"""frame.idle_ms: device-idle ms a frame inside the program's ``rt.step``
spans (``Renderer.step``) and outside its ``rt.loop`` spans (the bounce
loops): the idle the frame API, the raygen, the sky, the detile and the
readback's host side leave, by interval intersection."""

from rtbench import spans


def read(ctx):
    return spans.idle_ms_per_frame(ctx.trace, spans.STEP, spans.LOOP)
