"""prepass.torch_ops_ms: device ms a frame of the kernels that are not the
port's hand-written ones (the ``__global__`` functions of
``raytpu_torch/csrc/*.cu``) and whose launch lies inside one of the
program's ``rt.prepass`` spans: the culling prepass's PyTorch operations
around K7."""

from rtbench import profiling, spans


def read(ctx):
    if not ctx.trace.device or not spans.spans(ctx.trace, spans.PREPASS):
        return None
    ops = [d for d in spans.issued_inside(ctx.trace, spans.PREPASS)
           if d.kind == "kernel"
           and profiling.function_name(d.name) not in ctx.port_kernels]
    return sum(d.end - d.start for d in ops) * 1e-6 / ctx.trace.frames
