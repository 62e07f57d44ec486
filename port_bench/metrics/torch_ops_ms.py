"""torch_ops_ms (ms): device time an iteration of every device operation
outside the cell's sweep kernels (the engine's pre- and post-sweep torch
ops, global updates, records), the union of their intervals."""

from . import device_intervals, union_s


def read(ctx):
    if not ctx["timeline"]["device"]:
        return None
    return 1e3 * union_s(device_intervals(ctx, ctx["sweep_kernels"], exclude=True)) / ctx["iters"]
