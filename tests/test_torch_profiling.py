"""The port's profiling utilities (hibayes_tpu_torch/utils/profiling.py):
phase timing and torch.profiler trace capture, as tests/test_profiling.py
holds the JAX package's."""

import json
import time

import torch

from hibayes_tpu_torch.utils import PhaseTimer, annotate, device_trace


def test_phase_timer_accumulates_and_reports():
    t = PhaseTimer()
    with t.phase("a"):
        time.sleep(0.01)
    with t.phase("a"):
        time.sleep(0.01)
    with t.phase("b"):
        pass
    assert t.phases["a"] >= 0.02
    assert set(t.phases) == {"a", "b"}
    assert t.total() == sum(t.phases.values())
    lines = []
    t.report(items={"a": 1000}, out=lines.append)
    assert len(lines) == 3 and "/s" in lines[1]


def test_device_trace_none_is_noop():
    with device_trace(None) as prof:
        assert prof is None


def test_device_trace_writes_profile(tmp_path):
    """A trace file is written into the directory and holds the annotated
    name; the profiler's totals hold it too."""
    with device_trace(tmp_path / "tb") as prof:
        with annotate("matmul-phase"):
            x = torch.ones((64, 64))
            (x @ x).sum().item()
    trace = tmp_path / "tb" / "trace.json"
    assert trace.exists()
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert "matmul-phase" in names
    assert "matmul-phase" in {e.key for e in prof.key_averages()}


def test_annotate_nests_and_runs_outside_a_trace():
    with annotate("outer"):
        with annotate("inner"):
            pass
