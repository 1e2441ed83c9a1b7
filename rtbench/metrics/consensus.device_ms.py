"""consensus.device_ms: device ms a frame of the consensus closest and
shadow sweeps, ``mega_closest_sweep_kernel`` (K8) and
``mega_anyhit_sweep_kernel`` (K9), in the traced loop. Read only where the
program counts the consensus sweeps' work (``_build.work_counts`` has
their entries), as its two companions ``consensus.roofline_pct`` and
``consensus.useful_pct`` are."""

SWEEPS = ("mega_closest_sweep_kernel", "mega_anyhit_sweep_kernel")
COUNTED = ("mega_closest_sweep", "mega_anyhit_sweep")


def read(ctx):
    from raytpu_torch import _build

    work = _build.work_counts() if hasattr(_build, "work_counts") else {}
    if not all(k in work for k in COUNTED):
        return None
    ms = ctx.trace.kernel_ms_per_frame(lambda n: n in SWEEPS)
    return ms or None
