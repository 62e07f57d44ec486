"""The traced stretch of a window: a bounded run of iterations profiled by
``torch.profiler``, its events kept as intervals on one clock.

The stretch starts at one iteration and ends after a fixed number of them;
the device is synchronised at both ends and the host annotation
``STRETCH`` spans it, so every device operation of the stretch, and no
other, lies inside the annotation.  Busy time is the union of the device
operations' intervals (kernels, copies and fills), never their sum: a
K-chain sweep's kernels overlap.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import torch

STRETCH = "port_bench.stretch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "user_annotation")


class Stretch:
    """Profile iterations ``start`` .. ``start + iters - 1`` of a chain:
    :meth:`before` and :meth:`after` are called around each iteration.  The
    profiler starts ``LEAD`` iterations ahead of the stretch, so that its
    own start-up falls outside it.  The device is synchronised before the
    profiler starts too, and the host clock read there and once it has
    stopped: ``profiled_s`` and ``profiled_iters`` are the part of the window
    that the profiler slowed, so that the rest of the window gives the wall
    an iteration without it."""

    LEAD = 3

    def __init__(self, start: int, iters: int):
        self.start, self.iters = int(start), int(iters)
        self.prof = self.rf = None
        self.profiled_iters = self.LEAD + self.iters
        self.profiled_s = 0.0

    def before(self, it: int) -> None:
        if it == self.start - self.LEAD:
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            self.t_on = time.perf_counter()
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.start()
        elif it == self.start and self.prof is not None:
            torch.cuda.synchronize()
            self.rf = torch.autograd.profiler.record_function(STRETCH)
            self.rf.__enter__()

    def after(self, it: int) -> None:
        if self.rf is None or it != self.start + self.iters - 1:
            return
        torch.cuda.synchronize()
        self.rf.__exit__(None, None, None)
        self.rf = None
        self.prof.stop()
        self.profiled_s = time.perf_counter() - self.t_on

    def events(self) -> list:
        """The trace's complete events (Chrome trace format), read from a
        temporary file that is removed at once."""
        if self.prof is None or self.rf is not None:
            return []
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                raw = json.load(f)
        finally:
            os.unlink(path)
        evs = raw["traceEvents"] if isinstance(raw, dict) else raw
        return [e for e in evs if e.get("ph") == "X" and "dur" in e]


def timeline(events: list) -> dict:
    """{"window": (t0, t1) of the stretch, "device": [(category, name, t0,
    t1)], "host": [(name, t0, t1)]} in seconds, device intervals clipped to
    the window.  None where the trace holds no stretch."""
    win = [e for e in events if e.get("name") == STRETCH and e.get("cat") == "user_annotation"]
    if not win:
        return None
    w0 = float(win[0]["ts"]) * 1e-6
    w1 = w0 + float(win[0]["dur"]) * 1e-6
    dev, host = [], []
    for e in events:
        t0 = float(e["ts"]) * 1e-6
        t1 = t0 + float(e["dur"]) * 1e-6
        if e.get("cat") in DEVICE_CATS:
            a, b = max(t0, w0), min(t1, w1)
            if b > a:
                dev.append((e.get("cat"), e.get("name", ""), a, b))
        elif e.get("cat") in HOST_CATS and e.get("name") != STRETCH:
            host.append((e.get("name", ""), t0, t1))
    return {"window": (w0, w1), "device": dev, "host": host}


def union(intervals) -> list:
    """Merged (t0, t1) intervals of any (t0, t1) pairs."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def busy(intervals) -> float:
    return sum(b - a for a, b in union(intervals))


def gaps(intervals, window) -> list:
    """The idle (t0, t1) spans of ``window`` outside the union of ``intervals``."""
    out, t = [], window[0]
    for a, b in union(intervals):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if window[1] > t:
        out.append((t, window[1]))
    return out


def breakdown(tl: dict, top: int = 10) -> dict:
    """The device operations that took most time (by name, summed), and the
    longest idle gaps, each named by the host operation that overlaps it
    most."""
    per = {}
    for _, name, a, b in tl["device"]:
        per[name] = per.get(name, 0.0) + (b - a)
    ops = sorted(per.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps([(a, b) for _, _, a, b in tl["device"]], tl["window"]),
                  key=lambda g: -(g[1] - g[0]))[:top]
    named = []
    for a, b in idle:
        best, share = "host idle", 0.0
        for name, h0, h1 in tl["host"]:
            ov = min(b, h1) - max(a, h0)
            if ov > share:
                best, share = name, ov
        named.append([best, b - a])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}
