"""mfu_step (%): the least time of one iteration's work at the card's
published peaks (the larger of its bytes over the memory rate and its
float32 operations over the float32 rate; work/<entry>.py) over the
window's wall an iteration outside the profiled part (host clock)."""

from . import outside_iter_s


def read(ctx):
    wall = outside_iter_s(ctx)
    if not ctx["timeline"]["device"] or wall is None:
        return None
    return 100.0 * ctx["least_s"] / wall
