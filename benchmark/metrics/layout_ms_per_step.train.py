"""Device milliseconds per optimizer step in cuDNN's layout transposes
(NCHW to NHWC and back) of the traced steps."""
from benchmark.readers import kernel_ms_per_unit


def read(ctx):
    return kernel_ms_per_unit(ctx, ("nchwToNhwc", "nhwcToNchw"))
