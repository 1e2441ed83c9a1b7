"""consensus.roofline_pct: the consensus sweeps' share of their roofline,
x100: the least time over the measured time. The least time is the f32
operations of the work the lanes' own walks need over the card's unfused
rate: 23 a node visit and 51 a triangle test (``chip_smoke.SLAB_OPS``,
``MT_OPS``, as ``sweeps.roofline_pct`` counts), the ``own_nodes`` and
``own_tests`` that K8 and K9 count on the card while the stats loop
renders the same frames (``raytpu_torch._build.work_counts``), not the
work the warps' votes drag the lanes through; the measured time is the
device time of ``mega_closest_sweep_kernel`` plus
``mega_anyhit_sweep_kernel`` in the traced loop."""

SWEEPS = ("mega_closest_sweep_kernel", "mega_anyhit_sweep_kernel")
COUNTED = ("mega_closest_sweep", "mega_anyhit_sweep")
SLAB_OPS, MT_OPS = 23, 51


def read(ctx):
    from raytpu_torch import _build

    work = _build.work_counts() if hasattr(_build, "work_counts") else {}
    if not all(k in work for k in COUNTED) or not ctx.ops_per_s:
        return None
    ops = sum(work[k]["own_nodes"] * SLAB_OPS + work[k]["own_tests"] * MT_OPS
              for k in COUNTED)
    ms = ctx.trace.kernel_ms_per_frame(lambda n: n in SWEEPS)
    if not ops or not ms:
        return None
    least_ms = ops / ctx.ops_per_s * 1e3 / ctx.stats["frames"]
    return 100.0 * least_ms / ms
