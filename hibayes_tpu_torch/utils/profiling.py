"""Profiling and phase timing.

Counterpart of hibayes_tpu/utils/profiling.py.  The reference's only
observability is a nanosecond wall-clock timer feeding ETA prints
(reference: src/MyTimer.h:20-86, src/Bayes.cpp:884-914).  Here: per-phase
wall timing with derived throughput (:class:`PhaseTimer`), and device traces
through ``torch.profiler`` (:func:`device_trace`), which record the CUDA
kernels whenever the process has a card and write a Chrome/Perfetto trace;
:func:`annotate` names a phase in those traces and, on the card, in NVTX.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch


@dataclass
class PhaseTimer:
    """Accumulates named phase durations; prints a compact report.

    >>> t = PhaseTimer()
    >>> with t.phase("ingest"): ...
    >>> with t.phase("mcmc"): ...
    >>> t.report()

    A phase is host wall time: end a phase that launches device work with
    ``torch.cuda.synchronize()`` inside it to time the work itself.
    """

    phases: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0

    def total(self) -> float:
        return sum(self.phases.values())

    def report(self, *, items: dict | None = None, out=print):
        """items: optional {phase: count} to derive a rate column."""
        tot = self.total() or 1e-12
        out(f"{'phase':<16}{'seconds':>10}{'share':>8}{'rate':>14}")
        for name, sec in self.phases.items():
            rate = ""
            if items and name in items and sec > 0:
                rate = f"{items[name] / sec:,.0f}/s"
            out(f"{name:<16}{sec:>10.3f}{sec / tot:>7.1%}{rate:>14}")


@contextlib.contextmanager
def device_trace(logdir):
    """``torch.profiler`` trace scope; a no-op when ``logdir`` is None.

    Records the host's operators, and the CUDA kernels and copies whenever
    the process has a card; on exit writes ``trace.json`` (Chrome trace
    format, for Perfetto or chrome://tracing) into ``logdir`` and yields
    the profiler, whose ``key_averages()`` hold the totals:

    >>> with device_trace("traces") as prof:
    ...     ibrm(...)
    >>> print(prof.key_averages().table(sort_by="cuda_time_total"))
    """
    if logdir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named range: ``torch.profiler.record_function`` (so the phase
    shows up in :func:`device_trace`'s traces and totals) and, when the
    process has a card, an NVTX range of the same name."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
