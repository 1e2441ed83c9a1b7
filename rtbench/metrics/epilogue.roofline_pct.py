"""epilogue.roofline_pct: the shade and accumulate kernels' share of their
roofline, x100: the least time over the measured time. The least time is
the larger of the bytes (124 B of the shade pass and 40 B of the
accumulate pass a closest-hit lane, ``stats["closest_rays"]`` of the same
loop's frames) over the card's bytes a second and the f32 operations (100
and 18 a lane) over its unfused rate; the measured time is the device time
of ``shade_epilogue_kernel`` plus ``accumulate_epilogue_kernel``."""

KERNELS = ("shade_epilogue_kernel", "accumulate_epilogue_kernel")


def read(ctx):
    rf = ctx.roofline
    ms = ctx.trace.kernel_ms_per_frame(lambda n: n in KERNELS)
    lanes = ctx.stats.get("closest_rays", 0) / ctx.stats["frames"]
    if not ms or not lanes:
        return None
    least = rf.least_seconds((rf.SHADE_BYTES + rf.ACCUMULATE_BYTES) * lanes,
                             (rf.SHADE_OPS + rf.ACCUMULATE_OPS) * lanes,
                             ctx.ops_per_s)
    return 100.0 * least * 1e3 / ms
