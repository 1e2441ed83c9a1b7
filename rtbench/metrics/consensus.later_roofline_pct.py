"""consensus.later_roofline_pct: the consensus sweeps' share of their
roofline on the waves past the first bounce, x100: the least time over
the measured time. The least time is the f32 operations of the work the
lanes' own walks need on those waves over the card's unfused rate: 23 a
node visit and 51 a triangle test, as ``consensus.roofline_pct`` counts,
the ``own_nodes`` and ``own_tests`` that K8 and K9 count into their later
entries (``mega_closest_sweep.later``, ``mega_anyhit_sweep.later`` of
``raytpu_torch._build.work_counts``) while the stats loop renders the
same frames; the measured time is ``consensus.later_ms``'s, the device
time of K8 and K9 launched inside the program's ``rt.later`` spans in the
traced loop."""

from rtbench import profiling, spans

SWEEPS = ("mega_closest_sweep_kernel", "mega_anyhit_sweep_kernel")
COUNTED = ("mega_closest_sweep.later", "mega_anyhit_sweep.later")
SLAB_OPS, MT_OPS = 23, 51


def later_ms(trace) -> float:
    """Device ms a frame of K8 and K9 launched inside ``rt.later``."""
    ns = sum(d.end - d.start for d in spans.issued_inside(trace, "rt.later")
             if d.kind == "kernel" and profiling.function_name(d.name) in SWEEPS)
    return ns * 1e-6 / trace.frames


def read(ctx):
    from raytpu_torch import _build

    work = _build.work_counts() if hasattr(_build, "work_counts") else {}
    if not all(k in work for k in COUNTED) or not ctx.ops_per_s:
        return None
    ops = sum(work[k]["own_nodes"] * SLAB_OPS + work[k]["own_tests"] * MT_OPS
              for k in COUNTED)
    ms = later_ms(ctx.trace)
    if not ops or not ms:
        return None
    least_ms = ops / ctx.ops_per_s * 1e3 / ctx.stats["frames"]
    return 100.0 * least_ms / ms
