"""sweeps.device_ms: device ms a frame of the per-lane closest and shadow
sweeps, ``perlane_closest_sweep_kernel`` (K1) and
``perlane_anyhit_sweep_kernel`` (K2)."""

SWEEPS = ("perlane_closest_sweep_kernel", "perlane_anyhit_sweep_kernel")


def read(ctx):
    ms = ctx.trace.kernel_ms_per_frame(lambda n: n in SWEEPS)
    return ms or None
