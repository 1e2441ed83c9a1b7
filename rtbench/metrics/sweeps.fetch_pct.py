"""sweeps.fetch_pct: the per-lane sweeps' dependent record fetches per node
visit, x100: the fetches that K1 and K2 count on the card while the stats
loop renders (one for each walked entry's root and one for each child-pair
record their walk loads, ``fetches`` of ``raytpu_torch._build.work_counts``)
over their node visits (``nodes``, the nodes a stackless walk reads one
after the other). A walk that fetches every node it visits reads 100; the
pair walk about (1 + D) / (1 + 2D) for a lane that enters D inner nodes.
Nothing where the program counts no fetches."""

COUNTED = ("perlane_closest_sweep", "perlane_anyhit_sweep")


def read(ctx):
    from raytpu_torch import _build

    work = _build.work_counts() if hasattr(_build, "work_counts") else {}
    counted = [work[k] for k in COUNTED if "fetches" in work.get(k, {})]
    nodes = sum(w["nodes"] for w in counted)
    if not nodes:
        return None
    return 100.0 * sum(w["fetches"] for w in counted) / nodes
