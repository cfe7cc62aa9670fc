"""Device milliseconds per 3D optimizer step of the GroupNorm operators,
``aten::native_group_norm`` and its backward: the device time of the
kernels each traced call launched."""

OPS = ("aten::native_group_norm", "aten::native_group_norm_backward")


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr.units <= 0:
        return None
    return 1e3 * sum(o.device_s for o in tr.ops if o.name in OPS) / tr.units
