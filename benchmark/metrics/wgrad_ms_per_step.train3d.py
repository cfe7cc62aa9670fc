"""Device milliseconds per 3D optimizer step in cuDNN's weight-gradient
kernels (a kernel whose name holds ``wgrad``, in any case) of the traced
steps."""
from benchmark.readers import kernel_ms_per_unit


def read(ctx):
    return kernel_ms_per_unit(ctx, ("wgrad", "Wgrad", "WGRAD"))
