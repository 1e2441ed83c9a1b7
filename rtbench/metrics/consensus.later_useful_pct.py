"""consensus.later_useful_pct: the share of the consensus sweeps' f32 work
on the waves past the first bounce that their lanes needed, x100: the
operations of the box and triangle tests that the lanes' own walks need
(``own_nodes``, ``own_tests``) over those of every test the walking lanes
made (``nodes``, ``tests``), 23 a node visit and 51 a triangle test, as
K8 and K9 count them into their later entries
(``mega_closest_sweep.later``, ``mega_anyhit_sweep.later`` of
``raytpu_torch._build.work_counts``) while the stats loop renders.
Reflected and refracted rays diverge more than primary ones, so a warp's
one node pointer drags its lanes through more nodes there."""

COUNTED = ("mega_closest_sweep.later", "mega_anyhit_sweep.later")
SLAB_OPS, MT_OPS = 23, 51


def read(ctx):
    from raytpu_torch import _build

    work = _build.work_counts() if hasattr(_build, "work_counts") else {}
    if not all(k in work for k in COUNTED):
        return None
    own = sum(work[k]["own_nodes"] * SLAB_OPS + work[k]["own_tests"] * MT_OPS
              for k in COUNTED)
    made = sum(work[k]["nodes"] * SLAB_OPS + work[k]["tests"] * MT_OPS
               for k in COUNTED)
    return 100.0 * own / made if made else None
