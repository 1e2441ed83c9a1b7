"""device.idle_pct: the share of the traced window in which no operation
ran on the device, x100: 1 - (union of device-busy intervals) / (the
window's wall time)."""


def read(ctx):
    busy = ctx.trace.busy_s()
    if not busy:
        return None
    return 100.0 * (1.0 - busy / ctx.trace.window_s)
