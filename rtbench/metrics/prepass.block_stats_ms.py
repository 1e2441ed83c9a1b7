"""prepass.block_stats_ms: device ms a frame of the culling prepass's
kernel, ``block_stats_kernel`` (K7)."""


def read(ctx):
    ms = ctx.trace.kernel_ms_per_frame(lambda n: n == "block_stats_kernel")
    return ms or None
