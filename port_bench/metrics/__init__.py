"""Per-layer metric readers: ``metrics/<name>.py`` holds ``read(ctx)``,
which returns the metric of the traced run, or None where the run holds
nothing to read it from.  ``ctx`` (harness.py:trace_context) holds the
stretch's timeline ("timeline": window, device and host intervals), the
iterations it spans ("iters"), the cell's sweep kernels ("sweep_kernels",
name patterns), the least time of one iteration's work at the card's peaks
("least_s"), the harness's spans ("spans"), the chain's extras ("extras"),
the window's iterations ("niter"), the window's wall and iterations
outside the profiled part ("outside", seconds and iterations: the wall the
profiler did not slow) and the configuration and cell."""

from __future__ import annotations

import re

from .. import trace


def device_intervals(ctx, pattern_list=None, exclude=False, kernels_only=False):
    """(t0, t1) of the stretch's device operations whose name matches one
    of the patterns (all where None; those that match none with exclude)."""
    out = []
    for cat, name, a, b in ctx["timeline"]["device"]:
        if kernels_only and cat != "kernel":
            continue
        hit = pattern_list is None or any(re.search(p, name) for p in pattern_list)
        if hit != exclude:
            out.append((a, b))
    return out


def window_s(ctx) -> float:
    w0, w1 = ctx["timeline"]["window"]
    return w1 - w0


def union_s(intervals) -> float:
    return trace.busy(intervals)


def outside_iter_s(ctx):
    """The window's wall an iteration outside its profiled part, None where
    no iteration lies outside it."""
    wall, iters = ctx["outside"]
    return wall / iters if iters > 0 and wall > 0 else None
