"""sweep_roofline_pct (%): the least time of one iteration's sweep work at
the card's published peaks (work/<entry>.py) over the sweep kernels' busy
time an iteration, the union of their intervals."""

from . import device_intervals, union_s


def read(ctx):
    t = union_s(device_intervals(ctx, ctx["sweep_kernels"], kernels_only=True))
    if t <= 0:
        return None
    return 100.0 * ctx["least_s"] / (t / ctx["iters"])
