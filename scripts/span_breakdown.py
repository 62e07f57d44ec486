#!/usr/bin/env python3
"""Where a benchmark cell's traced stretch goes, by the program's own spans
(hibayes_tpu_torch/utils/profiling.py): one traced run of the cell, as
``port_bench/run.py --trace 1`` makes it, then for each innermost program
span the device time (union of intervals), the kernels launched and the
device's idle time, each an iteration, with "outside the program" as a row
of its own; and each synchronising runtime call of the stretch with the
span it was made in and the host operators around it.

    python3 scripts/span_breakdown.py --workload ibrm_bayesr_50k-k1 --seed 1 [--seconds 45]

A device operation belongs to the span in which the host launched it (the
runtime call that the trace correlates with it); an idle gap to the span
the host was in at the gap's midpoint.  Prints one JSON object.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from port_bench import harness, program_spans, trace  # noqa: E402

OUTSIDE = "outside the program"
DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")


def innermost(spans, t):
    """Name of the innermost span (t0, t1, name) holding time t: nested
    spans, so the one that opened last."""
    best = None
    for a, b, name in spans:
        if a <= t <= b and (best is None or a >= best[0]):
            best = (a, name)
    return OUTSIDE if best is None else best[1]


def analyse(events, spans, window, iters) -> dict:
    w0, w1 = window
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    per = {}

    def row(name):
        return per.setdefault(name, {"device_ms": [], "launches": 0, "idle_ms": 0.0})

    dev = []
    for e in events:
        if e.get("cat") not in DEVICE:
            continue
        a, b = max(e["ts"] * 1e-6, w0), min((e["ts"] + e["dur"]) * 1e-6, w1)
        if b <= a:
            continue
        dev.append((a, b))
        host = launch.get(e.get("args", {}).get("correlation"))
        r = row(OUTSIDE if host is None else innermost(spans, host["ts"] * 1e-6))
        r["device_ms"].append((a, b))
        r["launches"] += e["cat"] == "kernel"
    for g0, g1 in trace.gaps(dev, window):
        row(innermost(spans, 0.5 * (g0 + g1)))["idle_ms"] += g1 - g0
    out = {name: {"device_ms": 1e3 * trace.busy(r["device_ms"]) / iters,
                  "launches": r["launches"] / iters, "idle_ms": 1e3 * r["idle_ms"] / iters}
           for name, r in per.items()}

    ops = [e for e in events if e.get("cat") == "cpu_op"]
    syncs = []
    for e in events:
        if e.get("cat") != "cuda_runtime" or not program_spans.SYNCS.match(e["name"]):
            continue
        t = e["ts"] * 1e-6
        if not w0 <= t <= w1:
            continue
        around = sorted((o for o in ops if o["tid"] == e["tid"] and o["ts"] <= e["ts"]
                         and o["ts"] + o["dur"] >= e["ts"] + e["dur"]), key=lambda o: o["ts"])
        syncs.append({"call": e["name"], "span": innermost(spans, t),
                      "ops": [o["name"] for o in around], "ms": e["dur"] * 1e-3})
    return {"by_span": out, "syncs": syncs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=45.0)
    a = ap.parse_args(argv)
    # The harness keeps the trace's events to itself, so this takes them
    # through two of its internals: harness.run calls the module-level
    # trace_context(stretch, ...) once with the profiled Stretch first, and
    # Stretch.events() exports the profiler's trace, which can be done once.
    got = {}
    orig, export = harness.trace_context, trace.Stretch.events

    def capture(stretch, *args):
        got["events"] = export(stretch)      # a trace is exported once
        stretch.events = lambda: got["events"]
        got["ctx"] = orig(stretch, *args)
        return got["ctx"]

    harness.trace_context = capture
    result = harness.run(a.workload, a.seed, a.seconds, True)
    if result is None or not got.get("ctx"):
        return 1
    from hibayes_tpu_torch.utils import profiling

    ctx, events = got["ctx"], got["events"]
    marker = next(e for e in events if e["name"] == profiling.MARKER)
    clock = profiling.clock_ns()
    to_s = lambda t: 1e-6 * profiling.trace_us(t, marker["ts"], marker["dur"], clock)
    spans = [(to_s(r.t0), to_s(r.t1), r.name) for r in profiling.spans() if r.t1 is not None]
    out = analyse(events, spans, ctx["timeline"]["window"], ctx["iters"])
    out.update(workload=a.workload, seed=a.seed, iters=ctx["iters"],
               correct=result["correct"], metrics=result["metrics"],
               breakdown=result.get("breakdown"), device=result["device"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
