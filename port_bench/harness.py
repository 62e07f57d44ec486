"""One run of one cell: set-up, the timed window, the check, the result line.

    python port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: the cell's file
``workloads/<cell>.json`` (its configuration, traffic, traced stretch,
sweep kernels and the check's limits), the configuration's file
``configs/<config>.json`` (entry, inputs, sizes), the entry's module
``entries/<entry>.py`` (set-up and window through the program's model
layer and chain runner), the inputs' generator ``inputs/<inputs>.py``, the
work counts ``work/<entry>.py``, the plain reference ``reference/`` and one
reader ``metrics/<name>.py`` for each per-layer metric of BENCHMARK.json.

Set-up (``setup_s``) runs from the process's start to the window: imports,
the CUDA context, the inputs made on the card from the seed, the model
layer's preparation (span ``prepare_s``), the kernels loaded from the
checkout's build cache, and a warm-up chain of the cell's own spec.  The
window is one call to the chain runner with a fresh state and ``niter``
iterations, ``--seconds`` times the cell's fixed ``iters_per_second`` (so
that the window's records, which the chain runner keeps on the device until
the call ends, and with them the memory peak, do not follow the program's
speed); burn-in is the configured share, records every ``thin``.
``iter_ms`` is the window's host wall time, ending in a synchronise, over
its iterations.  With ``--trace 1`` a bounded stretch of the window is
profiled (trace.py) and the per-layer metrics are read from it and from the
window's wall outside it.
"""

from __future__ import annotations

import importlib
import json
import math
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "hibayes_tpu")


def process_seconds() -> float:
    """Seconds since this process started (its start time in /proc against
    the boot clock)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


def set_cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    program's nvcc libraries go to hibayes_tpu_torch/build/ already)."""
    cache = BENCH / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


def load(kind: str, name: str) -> dict:
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_metrics(bench: dict, cell: str) -> tuple:
    """(end-to-end, per-layer) metric entries that the cell reports."""
    pick = lambda ms: [m for m in ms if cell in m.get("workloads", [cell])]
    return pick(bench["end_to_end"]), pick(bench["per_layer"])


def metric_reader(name: str):
    return importlib.import_module(f"port_bench.metrics.{name}").read


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is JAX's or the
    JAX package's, compared whole (hibayes_tpu_torch is not hibayes_tpu)."""
    return sorted({k.split(".")[0] for k in list(sys.modules)} & set(FORBIDDEN))


def window_iters(iters_per_second: float, seconds: float, quantum: int) -> int:
    """Iterations of a window of ``seconds`` at the cell's fixed
    ``iters_per_second``, a multiple of ``quantum`` (so that burn-in and
    records divide it), at least one quantum."""
    return max(quantum, quantum * int(round(seconds * iters_per_second / quantum)))


class StepHook:
    """Wraps the engine's one-iteration function for the window: copies the
    chain's state before and after the planned iterations (and the guard
    counter around them) into buffers made before the window, so that the
    window's memory does not depend on which iterations the seed picks, and
    drives the traced stretch.  The chain runner looks the function up in
    its module at every iteration."""

    def __init__(self, module, name: str, plan: dict, template, tally_shape=None,
                 stretch=None):
        self.module, self.name, self.plan, self.stretch = module, name, plan, stretch
        self.want_in = {plan["b"][0]}
        self.want_out = set(plan["a"]) | set(plan["b"]) | set(plan["records"])
        import torch

        slots = 1 + len(plan["a"]) + len(plan["b"]) + len(plan["records"])
        self.pool = [self._clone(template) for _ in range(slots)]
        dev = template.g.device
        self.tallies = ([torch.zeros(tally_shape, dtype=torch.int64, device=dev)
                         for _ in range(slots)] if tally_shape else [])
        self.inp, self.out, self.dtally = {}, {}, {}
        self.spec = None

    @staticmethod
    def _clone(state):
        return state._replace(**{
            k: (tuple(e.clone() for e in v) if isinstance(v, tuple) else v.clone())
            for k, v in state._asdict().items() if k != "it"})

    def _keep(self, state):
        slot = self.pool.pop()
        for k, v in state._asdict().items():
            if k != "it":
                dst = getattr(slot, k)
                for d, e in (zip(dst, v) if isinstance(v, tuple) else ((dst, v),)):
                    d.copy_(e)
        return slot._replace(it=state.it)

    def __enter__(self):
        self.orig = getattr(self.module, self.name)
        setattr(self.module, self.name, self._step)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)

    def _step(self, spec, data, seed, state, *args, **kw):
        it = state.it
        if self.stretch is not None:
            self.stretch.before(it)
        if it in self.want_in:
            self.inp[it] = self._keep(state)
        tally = kw.get("tally")
        keep = it in self.want_out
        if keep and tally is not None:
            t0 = self.tallies.pop().copy_(tally)
        out = self.orig(spec, data, seed, state, *args, **kw)
        if keep:
            self.out[it] = self._keep(out)
            if tally is not None:
                self.dtally[it] = t0.neg_().add_(tally)
        if self.stretch is not None:
            self.stretch.after(it)
        return out


def trace_context(stretch, fit, cell, cfg, spans, extras, least_s, niter, wall) -> dict:
    from . import trace

    tl = trace.timeline(stretch.events())
    if tl is None:
        return None
    return {"timeline": tl, "iters": stretch.iters, "sweep_kernels": cell["sweep_kernels"],
            "least_s": least_s, "spans": spans, "extras": extras, "niter": niter,
            "chains": fit.K, "cfg": cfg, "cell": cell,
            "outside": (wall - stretch.profiled_s, niter - stretch.profiled_iters)}


def run(workload: str, seed: int, seconds: float, trace_on: bool, control: bool = False,
        device: str = "cuda", require_chip: bool = True, cell=None, cfg=None) -> dict:
    """One run of cell ``workload``; returns the result line's object (None
    where the run must print no result).  ``device``, ``require_chip`` and
    the ``cell`` and ``cfg`` dicts (in place of the files) exist for the CPU
    tests of the harness, which drive it at small sizes."""
    phases = {"start_s": process_seconds()}   # interpreter start and run.py's imports
    set_cache_dirs()
    import torch

    phases["torch_import_s"] = process_seconds() - sum(phases.values())

    cell = cell or load("workloads", workload)
    cfg = cfg or load("configs", cell["config"])
    chips = int(cell["chips"])
    if require_chip:
        if not torch.cuda.is_available():
            print("no CUDA device: the benchmark runs on the card only", file=sys.stderr)
            return None
        if torch.cuda.device_count() < chips:
            print(f"{torch.cuda.device_count()} CUDA devices, the cell needs {chips}",
                  file=sys.stderr)
            return None
    cuda = device == "cuda"
    dev = torch.device(device)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"])
    entry = importlib.import_module(f"port_bench.entries.{cfg['entry']}")
    inputs_mod = importlib.import_module(f"port_bench.inputs.{cfg['inputs']}")
    work_mod = importlib.import_module(f"port_bench.work.{cfg['entry']}")
    from . import check, work

    traffic = cell["traffic"]
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    inputs = inputs_mod.make(cfg, gen, dev)
    sync()
    phases["context_inputs_s"] = process_seconds() - sum(phases.values())
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    spans = {}
    t = time.perf_counter()
    fit = entry.Fit(cfg, cell, inputs, seed, dev)
    sync()
    spans["prepare_s"] = time.perf_counter() - t

    # warm-up: every shape of the window (records, chunk flushes, the f32
    # resync of the residual)
    quantum = int(traffic["quantum"])
    burn = float(traffic["burn_share"])
    wu = int(cell["warmup_iters"])
    wu_burn = min(int(wu * burn), wu - 2 * int(traffic["thin"]))   # two records at least
    phases["prepare_s"] = process_seconds() - sum(phases.values())
    template, _, _ = fit.run(fit.spec(wu, wu_burn, resync_every=max(2, wu // 4)))
    sync()
    niter = window_iters(float(cell["iters_per_second"]), seconds, quantum)
    nburn = int(round(niter * burn))
    spec = fit.spec(niter, nburn)
    plan = check.plan(seed, spec.niter_eff, nburn, spec.thin, int(cell["check"]["steps"]),
                      int(cell["check"]["records"]))
    stretch = None
    if trace_on:
        from .trace import Stretch

        stretch = Stretch(nburn, int(cell["trace_iters"]))
    hook = StepHook(fit.step_module, fit.step_name, plan, template, fit.tally_shape, stretch)
    hook.spec = spec
    del template

    setup_s = process_seconds()
    phases["warmup_s"] = setup_s - sum(phases.values())
    with hook:
        t = time.perf_counter()
        _, samples, extras = fit.run(spec)
        sync()
        wall = time.perf_counter() - t
    iter_ms = 1e3 * wall / spec.niter_eff
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    fit.free()
    if cuda:
        torch.cuda.empty_cache()

    limits = cell["limits"]
    readings = check.follow(fit, hook, seed, limits, control)
    n_rec, bad_rec = check.records(fit, hook, samples)
    chain = readings["chain"]
    chain["gaps"]["records_gap"] = bad_rec
    chain["attempted"] += n_rec
    chain["failed"] += bad_rec
    # with --control the control stands in the chain's place and is judged
    # by the same limits (the chain's records and guard counter are the
    # chain's own, and stay with it)
    side = readings["control"] if control else chain

    e2e, per_layer = cell_metrics(benchmark(), workload)
    units = {m["name"]: m["unit"] for m in e2e + per_layer}
    metrics = {}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": chips, "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace_on:
        peak_rates = work.peaks(device_info["kind"])
        least_s, _ = work.least_seconds(work_mod.iteration_work(cfg, fit.K), peak_rates)
        ctx = trace_context(stretch, fit, cell, cfg, spans, extras, least_s, spec.niter_eff,
                            wall)
        if ctx is not None:
            from . import trace

            for m in per_layer:
                v = metric_reader(m["name"])(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": float(v), "unit": units[m["name"]]}
            dev_iv = [(a, b) for _, _, a, b in ctx["timeline"]["device"]]
            w0, w1 = ctx["timeline"]["window"]
            device_info["busy_s"] = trace.busy(dev_iv)
            device_info["window_s"] = w1 - w0
            breakdown = trace.breakdown(ctx["timeline"])
    else:
        values = {"iter_ms": iter_ms, "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
        for m in e2e:
            if m["name"] in values:
                metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}

    against = lambda gaps: {k: {"value": v, "limit": limits.get(k, 0)} for k, v in gaps.items()}
    checks = against(side["gaps"])
    finite = all(math.isfinite(c["value"]) for c in checks.values())
    correct = bool(finite and side["failed"] == 0
                   and all(c["value"] <= c["limit"] for c in checks.values()))
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return None
    result = {"correct": correct, "attempted": side["attempted"], "failed": side["failed"],
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["niter"] = spec.niter_eff
    result["setup_phases"] = phases
    if control:
        result["chain_checks"] = against(chain["gaps"])
    result["checks"] = checks
    for line in side["worst"][:8]:
        print("failed draw: " + line, file=sys.stderr)
    for k, c in result.get("chain_checks", {}).items():
        print(f"chain check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return result
