"""consensus.later_ms: device ms a frame of the consensus closest and
shadow sweeps, ``mega_closest_sweep_kernel`` (K8) and
``mega_anyhit_sweep_kernel`` (K9), on the waves past the first bounce, in
the traced loop: those whose launch (``DeviceOp.issued``: the runtime
call that issued them, a graph's replay in a replayed frame) lies inside
an ``rt.later`` span, the program's span around each unit of the bounce
loop past the first bounce. Read only where the program counts the later
waves' work apart (``_build.work_counts`` has ``mega_closest_sweep.later``
and ``mega_anyhit_sweep.later``), as its two companions
``consensus.later_roofline_pct`` and ``consensus.later_useful_pct`` are."""

from rtbench import profiling, spans

SWEEPS = ("mega_closest_sweep_kernel", "mega_anyhit_sweep_kernel")
COUNTED = ("mega_closest_sweep.later", "mega_anyhit_sweep.later")


def later_ms(trace) -> float:
    """Device ms a frame of K8 and K9 launched inside ``rt.later``."""
    ns = sum(d.end - d.start for d in spans.issued_inside(trace, "rt.later")
             if d.kind == "kernel" and profiling.function_name(d.name) in SWEEPS)
    return ns * 1e-6 / trace.frames


def read(ctx):
    from raytpu_torch import _build

    work = _build.work_counts() if hasattr(_build, "work_counts") else {}
    if not all(k in work for k in COUNTED):
        return None
    return later_ms(ctx.trace) or None
