"""The program's own spans and counters in the traced stretch
(hibayes_tpu_torch/utils/profiling.py): the store of the latest profiling
session, read in the fit's process after the stretch, its perf-counter
stamps put on the trace's clock by the session's marker operator, found
among the timeline's host events.  Every reader returns None where the
program keeps no spans (a program without the store, or a stretch in which
it recorded none)."""

from __future__ import annotations

import re

from . import trace
from .metrics import device_intervals

# the CUDA runtime calls that block the host until the device (or a stream
# or event of it) has finished: a blocking copy waits for its stream too
SYNCS = re.compile(r"^cuda(Stream|Device|Event)Synchronize$|^cudaMemcpy(2D|3D)?$")
ITERATION = "engine.iteration"


def iterations(ctx):
    """[(t0, t1, counts)] of the program's ``engine.iteration`` spans that
    lie inside the stretch's window, in seconds on the trace's clock, with
    the counts of each iteration and every span under it; None where there
    are none to read."""
    from hibayes_tpu_torch.utils import profiling

    if not hasattr(profiling, "spans"):
        return None
    recs, clock = profiling.spans(), profiling.clock_ns()
    marker = next((h for h in ctx["timeline"]["host"] if h[0] == profiling.MARKER), None)
    if not recs or clock is None or marker is None:
        return None
    m0, md = 1e6 * marker[1], 1e6 * (marker[2] - marker[1])
    to_s = lambda t: 1e-6 * profiling.trace_us(t, m0, md, clock)
    w0, w1 = ctx["timeline"]["window"]
    top, out = {}, {}
    for r in recs:
        top[r.index] = r.index if r.name == ITERATION else top.get(r.parent)
        if r.name == ITERATION and r.t1 is not None:
            a, b = to_s(r.t0), to_s(r.t1)
            if w0 <= a and b <= w1:
                out[r.index] = (a, b, {})
        it = out.get(top[r.index])
        if it is not None and r.counts:
            for k, v in r.counts.items():
                it[2][k] = it[2].get(k, 0) + v
    return list(out.values()) or None


def syncs(ctx, its) -> list:
    """(name, t0, t1) of the synchronising runtime calls made inside the
    iteration spans ``its``."""
    return [h for h in ctx["timeline"]["host"] if SYNCS.match(h[0])
            and any(a <= h[1] <= b for a, b, _ in its)]


def exposed(ctx, calls) -> list:
    """The device's idle (t0, t1) spans from each of ``calls`` until the
    device next starts one of the cell's sweep kernels (the window's end
    where none follows): the queue drains while the host waits, and the
    host's work up to the sweep's launch then runs with the device idle."""
    w0, w1 = ctx["timeline"]["window"]
    starts = sorted(a for a, _ in device_intervals(ctx, ctx["sweep_kernels"], kernels_only=True))
    reach = trace.union([(h[1], next((s for s in starts if s >= h[2]), w1)) for h in calls])
    dev = [(a, b) for _, _, a, b in ctx["timeline"]["device"]]
    return [(max(g0, r0), min(g1, r1)) for g0, g1 in trace.gaps(dev, (w0, w1))
            for r0, r1 in reach if min(g1, r1) > max(g0, r0)]
