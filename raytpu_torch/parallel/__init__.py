from raytpu_torch.parallel.dist import (
    Mesh,
    make_mesh,
    render_frame_sharded,
    render_sharded,
    replicate,
)

__all__ = ["Mesh", "make_mesh", "render_frame_sharded", "render_sharded",
           "replicate"]
