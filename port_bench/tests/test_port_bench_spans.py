"""The readers of the program's spans and counters (program_spans.py) on a
synthetic timeline with a clock marker and a synthetic store: syncs made
inside an iteration span and one made outside, the idle that a sync exposes
up to the next sweep kernel, and a gap that no sync exposes."""

import pytest

from hibayes_tpu_torch.utils import profiling
from port_bench import harness, trace

CLOCK = 5_000_000_000          # the perf counter read inside the marker (ns)
MARK = (0.2, 2e-6)             # the marker's start and duration on the trace (s)


def ns(x):
    """The perf-counter stamp of trace second ``x``."""
    return int(round(CLOCK + (x - MARK[0] - MARK[1] / 2) * 1e9))


def store():
    """Two iterations inside the window (2-5 s, 6-9 s), one after it; 9
    generators each: 2 in the iteration, 3 in the pre-sweep, 4 in the
    post-sweep's own child."""
    recs = []

    def add(name, a, b, parent=None, it=None, counts=None):
        r = profiling.Span(name, ns(a), len(recs), parent, it)
        r.t1, r.counts = ns(b), counts
        recs.append(r)
        return r.index

    for k, (a, b) in enumerate([(2.0, 5.0), (6.0, 9.0), (11.5, 12.0)]):
        top = add("engine.iteration", a, b, it=k, counts={"rng.generators": 2})
        add("engine.pre_sweep", a, a + 0.5, top, k, {"rng.generators": 3})
        post = add("engine.post_sweep", b - 1.0, b, top, k)
        add("ops.inner", b - 0.9, b - 0.1, post, k, {"rng.generators": 4})
    add("engine.record", 9.2, 9.3)
    return recs


def events():
    us = lambda t: t * 1e6
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.STRETCH, "ts": us(1.0),
           "dur": us(10.0)},
          {"ph": "X", "cat": "cpu_op", "name": profiling.MARKER, "ts": us(MARK[0]),
           "dur": us(MARK[1])}]
    # busy 1-3, 3.5-4, 4.2-5.5 (a sweep), 7-8, 8.5-11 (a sweep):
    # gaps 3-3.5, 4-4.2, 5.5-7, 8-8.5
    for a, b, name in [(1.0, 3.0, "void k"), (3.5, 4.0, "void k"), (4.2, 5.5, "void sweep_k"),
                       (7.0, 8.0, "void k"), (8.5, 11.0, "void sweep_k")]:
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": us(a), "dur": us(b - a)})
    for name, a, b in [("cudaStreamSynchronize", 2.9, 3.1),    # in iteration 0: exposes 3-3.5, 4-4.2
                       ("cudaStreamSynchronize", 3.15, 3.2),   # again, in the same stretch
                       ("cudaDeviceSynchronize", 5.6, 5.7),    # between iterations: not counted
                       ("cudaEventSynchronize", 7.5, 8.05),    # in iteration 1: exposes 8-8.5
                       ("cudaMemcpyAsync", 4.0, 4.01),         # does not block
                       ("cudaStreamSynchronize", 11.6, 11.7)]:  # past the window
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": name, "ts": us(a),
                   "dur": us(b - a)})
    ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": us(6.2), "dur": us(0.1)})
    return ev


@pytest.fixture
def ctx(monkeypatch):
    monkeypatch.setattr(profiling, "spans", store)
    monkeypatch.setattr(profiling, "clock_ns", lambda: CLOCK)
    return {"timeline": trace.timeline(events()), "iters": 2, "sweep_kernels": [r"\bsweep_k\b"]}


@pytest.mark.parametrize("name, want", [
    ("rng_generators_per_iter", 9.0),
    ("host_syncs_per_iter", 1.5),                       # two in iteration 0, one in 1
    ("sync_idle_ms", 1e3 * (0.5 + 0.2 + 0.5) / 2),      # not the gap 5.5-7
])
def test_readers(ctx, name, want):
    assert harness.metric_reader(name)(ctx) == pytest.approx(want)


def test_iterations_inside_the_window_with_their_counts(ctx):
    from port_bench import program_spans

    its = program_spans.iterations(ctx)
    assert [(pytest.approx(a), pytest.approx(b)) for a, b, _ in its] == [(2.0, 5.0), (6.0, 9.0)]
    assert [c for _, _, c in its] == [{"rng.generators": 9}] * 2


def test_a_gap_no_sync_ends_is_left_out(ctx):
    from port_bench import program_spans

    calls = program_spans.syncs(ctx, program_spans.iterations(ctx))
    assert [h[0] for h in calls] == ["cudaStreamSynchronize"] * 2 + ["cudaEventSynchronize"]
    assert program_spans.exposed(ctx, calls) == [(3.0, 3.5), (4.0, pytest.approx(4.2)),
                                                 (8.0, pytest.approx(8.5))]


def test_no_sweep_after_a_sync_exposes_to_the_window_end(ctx):
    from port_bench import program_spans

    ctx["sweep_kernels"] = [r"\bnone\b"]
    calls = program_spans.syncs(ctx, program_spans.iterations(ctx))
    assert program_spans.exposed(ctx, calls) == [(3.0, 3.5), (4.0, pytest.approx(4.2)),
                                                 (5.5, 7.0), (8.0, pytest.approx(8.5))]


READERS = ["rng_generators_per_iter", "host_syncs_per_iter", "sync_idle_ms"]


@pytest.mark.parametrize("name", READERS)
def test_no_spans_reads_none(ctx, monkeypatch, name):
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert harness.metric_reader(name)(ctx) is None


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_the_store_reads_none(ctx, monkeypatch, name):
    monkeypatch.delattr(profiling, "spans")
    assert harness.metric_reader(name)(ctx) is None


@pytest.mark.parametrize("name", READERS)
def test_no_marker_reads_none(ctx, name):
    ctx["timeline"]["host"] = [h for h in ctx["timeline"]["host"] if h[0] != profiling.MARKER]
    assert harness.metric_reader(name)(ctx) is None
