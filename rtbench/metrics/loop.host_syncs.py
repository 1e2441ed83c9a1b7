"""loop.host_syncs: the bounce loop's host syncs a frame
(``stats["host_syncs"]`` of ``Renderer.render(stats=...)``, summed over
one loop of the path at the same poses, over the loop's frames)."""


def read(ctx):
    if "host_syncs" not in ctx.stats:
        return None
    return ctx.stats["host_syncs"] / ctx.stats["frames"]
