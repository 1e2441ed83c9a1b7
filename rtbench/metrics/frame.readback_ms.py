"""frame.readback_ms: device ms a frame of the device-to-host copies of
the frame's image: copies that run inside a host copy operation with an
operand of the image's shape (H, W, 3), so the 4-byte reads of the bounce
loop's host syncs are not among them."""


def read(ctx):
    copies = ctx.trace.copies_during(ctx.image_shape)
    if not copies:
        return None
    return sum(d.end - d.start for d in copies) * 1e-6 / ctx.trace.frames
