"""idle_pct (%): the share of an iteration's wall in which no operation runs
on the device: the device's busy time an iteration in the traced stretch
(the union of the device operations' intervals) against the window's wall
an iteration outside the profiled part (host clock), so that the
profiler's own host cost, which slows the stretch, is not read as idle."""

from . import device_intervals, outside_iter_s, union_s


def read(ctx):
    wall = outside_iter_s(ctx)
    if not ctx["timeline"]["device"] or wall is None:
        return None
    return 100.0 * (1.0 - union_s(device_intervals(ctx)) / ctx["iters"] / wall)
