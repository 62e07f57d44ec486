"""sync_idle_ms (ms): the device's idle time an iteration that the program's
synchronising calls expose: from each such call made inside an
``engine.iteration`` span until the device next starts one of the cell's
sweep kernels.  The queue drains while the host waits, and the host's work
that follows, up to the sweep's launch, then runs with the device idle."""

from .. import program_spans


def read(ctx):
    its = program_spans.iterations(ctx)
    if its is None:
        return None
    gaps = program_spans.exposed(ctx, program_spans.syncs(ctx, its))
    return 1e3 * sum(b - a for a, b in gaps) / len(its)
