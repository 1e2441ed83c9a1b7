"""sweeps.roofline_pct: the per-lane sweeps' share of their roofline, x100:
the least time over the measured time. The least time is the f32
operations of their work over the card's unfused rate: 23 a node visit and
51 a triangle test (``chip_smoke.SLAB_OPS``, ``MT_OPS``), the visits and
tests that K1 and K2 count on the card while the stats loop renders the
same frames (``raytpu_torch._build.work_counts``); the measured time is the
device time of ``perlane_closest_sweep_kernel`` plus
``perlane_anyhit_sweep_kernel`` in the traced loop."""

SWEEPS = ("perlane_closest_sweep_kernel", "perlane_anyhit_sweep_kernel")
COUNTED = ("perlane_closest_sweep", "perlane_anyhit_sweep")
SLAB_OPS, MT_OPS = 23, 51


def read(ctx):
    from raytpu_torch import _build

    if not hasattr(_build, "work_counts") or not ctx.ops_per_s:
        return None
    work = _build.work_counts()
    ops = sum(work[k]["nodes"] * SLAB_OPS + work[k]["tests"] * MT_OPS
              for k in COUNTED if k in work)
    ms = ctx.trace.kernel_ms_per_frame(lambda n: n in SWEEPS)
    if not ops or not ms:
        return None
    least_ms = ops / ctx.ops_per_s * 1e3 / ctx.stats["frames"]
    return 100.0 * least_ms / ms
