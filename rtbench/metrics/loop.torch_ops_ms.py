"""loop.torch_ops_ms: device ms a frame of every kernel that is not one of
the port's hand-written kernels (the ``__global__`` functions of
``raytpu_torch/csrc/*.cu``): the PyTorch operations of the bounce loop,
the prepass and the frame API. Copies and sets are not kernels."""


def read(ctx):
    if not any(d.kind == "kernel" for d in ctx.trace.device):
        return None
    return ctx.trace.kernel_ms_per_frame(lambda n: n not in ctx.port_kernels)
