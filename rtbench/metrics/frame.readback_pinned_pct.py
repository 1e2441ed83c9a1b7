"""frame.readback_pinned_pct: the share of the image's readback that lands
in page-locked host memory, x100: device time of the frame's image copies
(``frame.readback_ms``'s: device-to-host copies inside a host copy with an
operand of the image's shape (H, W, 3)) whose device operation names the
destination ``Pinned`` ("Memcpy DtoH (Device -> Pinned)"), over the device
time of all of them. Nothing is read where there is no such copy."""


def read(ctx):
    copies = ctx.trace.copies_during(ctx.image_shape)
    if not copies:
        return None
    pinned = sum(d.end - d.start for d in copies if "pinned" in d.name.lower())
    return 100.0 * pinned / sum(d.end - d.start for d in copies)
