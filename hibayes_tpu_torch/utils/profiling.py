"""Profiling and phase timing.

Counterpart of hibayes_tpu/utils/profiling.py.  The reference's only
observability is a nanosecond wall-clock timer feeding ETA prints
(reference: src/MyTimer.h:20-86, src/Bayes.cpp:884-914).  Here: per-phase
wall timing with derived throughput (:class:`PhaseTimer`), and device traces
through ``torch.profiler`` (:func:`device_trace`), which record the CUDA
kernels whenever the process has a card and write a Chrome/Perfetto trace;
:func:`annotate` names a phase in those traces and, on the card, in NVTX.

The program's own spans and counters (:func:`span`, :func:`spanned`,
:func:`count`) go to one in-memory store, and only while a
``torch.profiler`` records in this process: otherwise each is one check of
the profiler's flag.  They never enter the profiler as events of their own,
so a trace's host operators keep their names.  Stamps are
``time.perf_counter_ns()`` readings; the first record of a profiling
session enters one marker operator, ``hibayes.clock``, into the trace and
reads the perf counter inside it, so that a reader maps a stamp onto the
trace's clock by the marker's interval (:func:`trace_us`).  :func:`spans`
holds the latest session's records; a session ends once a span, a count or
:func:`spans` finds no profiler recording, and the next starts the store
afresh.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

MARKER = "hibayes.clock"   # the operator that puts the perf counter on the trace's clock
MAX_SPANS = 200_000        # records a session keeps; later spans are dropped
_on = torch._C._autograd._profiler_enabled
_MARK = torch._C._profiler._RecordFunctionFast   # a cpu_op, not a user_annotation


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


class Span:
    """One record of the store: ``name``; ``t0`` and ``t1``, perf-counter
    nanoseconds (``t1`` None while open); ``index``, its place in
    :func:`spans`; ``parent``, the index of the span it opened in (None at
    the top); ``it``, the
    iteration (a child takes its parent's where it names none); ``counts``,
    {counter: total} of the counts made while it was the innermost open span
    (None where none were)."""

    __slots__ = ("name", "t0", "t1", "index", "parent", "it", "counts")

    def __init__(self, name, t0, index, parent, it):
        self.name, self.t0, self.t1 = name, t0, None
        self.index, self.parent, self.it, self.counts = index, parent, it, None


class _Store:
    """The latest profiling session's records, its open spans, and the
    perf counter read inside its marker."""

    def __init__(self):
        self.live = False
        self.records, self.stack = [], []
        self.clock_ns = None

    def begin(self) -> None:
        self.records, self.stack = [], []
        self.live = True
        with _MARK(MARKER):
            self.clock_ns = time.perf_counter_ns()


_STORE = _Store()


class _Open:
    """An open span, while the profiler records."""

    __slots__ = ("name", "it", "rec")

    def __init__(self, name, it):
        self.name, self.it = name, it

    def __enter__(self):
        s = _STORE
        if not s.live:
            s.begin()
        top = s.stack[-1] if s.stack else None
        it = self.it if self.it is not None or top is None else top.it
        if len(s.records) < MAX_SPANS:
            self.rec = Span(self.name, time.perf_counter_ns(), len(s.records),
                            None if top is None else top.index, it)
            s.records.append(self.rec)
        else:
            self.rec = None
        s.stack.append(self.rec)
        return self.rec

    def __exit__(self, *exc):
        if self.rec is not None:
            self.rec.t1 = time.perf_counter_ns()
        s = _STORE
        if s.stack and s.stack[-1] is self.rec:
            s.stack.pop()
        return False


_NULL = contextlib.nullcontext()


def span(name: str, it=None):
    """A span of the program: a context manager that, while a
    ``torch.profiler`` records in this process, appends one :class:`Span`
    to the store (``it``: the iteration it belongs to); otherwise the
    shared null context, and the session, if one was open, is over."""
    if not _on():
        _STORE.live = False
        return _NULL
    return _Open(name, it)


def spanned(name: str):
    """Decorator: each call of the function is a :func:`span` ``name``."""
    def wrap(f):
        @functools.wraps(f)
        def call(*args, **kw):
            if not _on():
                _STORE.live = False
                return f(*args, **kw)
            with _Open(name, None):
                return f(*args, **kw)
        return call
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the innermost open span, while a
    ``torch.profiler`` records (a count with no span open is not kept)."""
    if not _on():
        _STORE.live = False
        return
    top = _STORE.stack[-1] if _STORE.live and _STORE.stack else None
    if top is not None:
        if top.counts is None:
            top.counts = {}
        top.counts[name] = top.counts.get(name, 0) + n


def spans() -> list:
    """The records of the latest profiling session, in the order the spans
    opened (a parent before its children).  Read with no profiler
    recording, it also closes that session: the next span starts anew."""
    if not _on():
        _STORE.live = False
    return list(_STORE.records)


def clock_ns():
    """The perf counter read inside the latest session's marker (None
    before the first session)."""
    return _STORE.clock_ns


def trace_us(t_ns: int, marker_ts_us: float, marker_dur_us: float, clock: int) -> float:
    """A perf-counter stamp on the trace's clock (microseconds), by the
    marker's interval in the trace: the perf counter was read inside it,
    so at its midpoint within half its duration (a few microseconds)."""
    return marker_ts_us + 0.5 * marker_dur_us + (t_ns - clock) * 1e-3


def _span_track(path: Path) -> None:
    """Add the session's spans to the Chrome trace at ``path``, mapped onto
    its clock, as a track of their own ("hibayes spans")."""
    raw = json.loads(path.read_text())
    evs = raw["traceEvents"] if isinstance(raw, dict) else raw
    marker = next((e for e in evs if e.get("name") == MARKER and e.get("ph") == "X"), None)
    records, clock = spans(), clock_ns()
    if marker is None or clock is None or not records:
        return
    pid, tid = os.getpid(), "hibayes spans"
    m0, md = float(marker["ts"]), float(marker.get("dur", 0.0))
    evs.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": tid}})
    for r in records:
        if r.t1 is None:
            continue
        t0 = trace_us(r.t0, m0, md, clock)
        args = {"index": r.index, "parent": r.parent, "it": r.it}
        if r.counts:
            args.update(r.counts)
        evs.append({"ph": "X", "cat": "hibayes_span", "name": r.name, "pid": pid,
                    "tid": tid, "ts": t0, "dur": (r.t1 - r.t0) * 1e-3, "args": args})
    path.write_text(json.dumps(raw))


@contextlib.contextmanager
def device_trace(logdir):
    """``torch.profiler`` trace scope; a no-op when ``logdir`` is None.

    Records the host's operators, and the CUDA kernels and copies whenever
    the process has a card; on exit writes ``trace.json`` (Chrome trace
    format, for Perfetto or chrome://tracing) into ``logdir`` and yields
    the profiler, whose ``key_averages()`` hold the totals.  The program's
    spans of the session (:func:`span`) are added to the trace as a track
    of their own, on its clock:

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
    _STORE.live = False     # the session's spans, and no earlier ones
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / "trace.json"))
    _span_track(out / "trace.json")


@contextlib.contextmanager
def annotate(name: str):
    """A named range: ``torch.profiler.record_function`` (so the phase
    shows up in :func:`device_trace`'s traces and totals), when the process
    has a card an NVTX range of the same name, and a :func:`span` in the
    program's store."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name), span(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
