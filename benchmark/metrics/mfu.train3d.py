"""Model FLOP utilization (%) of the untraced window of a 3D training
cell: the reference's FLOP per optimizer step (``counts3d``) over the
step's time, against the card's dense TF32 peak, the precision cuDNN runs
the float32 convolutions in."""
from benchmark.counts3d import tf32_peak


def read(ctx):
    res = ctx["result"]
    peak = tf32_peak(res.get("card", ""))
    if peak is None or not res.get("unit_s") \
            or not res.get("flop_per_unit"):
        return None
    return 100.0 * res["flop_per_unit"] / res["unit_s"] / peak
