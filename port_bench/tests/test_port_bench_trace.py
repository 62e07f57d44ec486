"""Busy and idle time from the union of device intervals, on a synthetic
timeline whose kernels overlap, and the per-layer readers on it."""

import pytest

from port_bench import harness, trace


def events():
    us = lambda t: t * 1e6
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.STRETCH, "ts": us(0.0),
           "dur": us(10.0)}]
    # two overlapping sweep kernels (1-5 and 3-7), a torch op inside them
    # (4-4.5), one alone (8-9), a copy (9-9.5), and one past the window
    for cat, name, a, b in [("kernel", "void hb::rows_mc_kernel<1>", 1, 5),
                            ("kernel", "void hb::draws_kernel<6, 4>", 3, 7),
                            ("kernel", "void at::native::reduce_kernel", 4, 4.5),
                            ("kernel", "void at::native::add_kernel", 8, 9),
                            ("gpu_memcpy", "Memcpy DtoH", 9, 9.5),
                            ("kernel", "void at::native::late", 11, 12)]:
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": us(a), "dur": us(b - a)})
    ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": us(7.2),
               "dur": us(0.7)})
    return ev


def ctx():
    return {"timeline": trace.timeline(events()), "iters": 2,
            "sweep_kernels": [r"\brows_mc_kernel\b", r"\bdraws_kernel\b"],
            "least_s": 0.5, "spans": {"prepare_s": 1.25}, "extras": {}, "niter": 100,
            "chains": 4, "cfg": {"m": 10}, "cell": {}, "outside": (40.0, 8)}


def test_union_not_sum():
    assert trace.union([(1, 5), (3, 7), (4, 4.5), (8, 9)]) == [(1, 7), (8, 9)]
    assert trace.busy([(1, 5), (3, 7), (4, 4.5), (8, 9)]) == 7.0
    assert trace.gaps([(1, 7), (8, 9)], (0, 10)) == [(0, 1), (7, 8), (9, 10)]


def test_timeline_clips_to_the_stretch():
    tl = trace.timeline(events())
    assert tl["window"] == (0.0, 10.0)
    assert len(tl["device"]) == 5           # the late kernel lies outside
    assert trace.timeline([e for e in events() if e["name"] != trace.STRETCH]) is None


@pytest.mark.parametrize("name, want", [
    ("idle_pct", 100.0 * (1 - 7.5 / 2 / 5.0)),       # busy: 1-7, 8-9.5; 5 s an iteration
    ("torch_ops_ms", 1e3 * (0.5 + 1.0 + 0.5) / 2),   # outside the sweep kernels
    ("launches_per_iter", 4 / 2),                    # kernels only, not the copy
    ("sweep_roofline_pct", 100.0 * 0.5 / (6.0 / 2)),  # the sweep's union 1-7
    ("mfu_step", 100.0 * 0.5 / 5.0),                 # outside the profiled part
    ("prepare_s", 1.25),
])
def test_readers(name, want):
    assert harness.metric_reader(name)(ctx()) == pytest.approx(want)


def test_readers_with_nothing_to_read_return_none():
    c = ctx()
    c["timeline"]["device"] = []
    for name in ("idle_pct", "torch_ops_ms", "launches_per_iter", "sweep_roofline_pct",
                 "mfu_step", "guard_redraw_pct"):
        assert harness.metric_reader(name)(c) is None


@pytest.mark.parametrize("name", ["idle_pct", "mfu_step"])
def test_readers_of_the_wall_outside_need_an_iteration_there(name):
    c = ctx()
    c["outside"] = (0.0, 0)
    assert harness.metric_reader(name)(c) is None


def test_guard_redraw_share():
    c = ctx()
    c["extras"] = {"guard": [[3, 1]]}
    c["chains"], c["niter"], c["cfg"] = 1, 100, {"m": 10}
    assert harness.metric_reader("guard_redraw_pct")(c) == pytest.approx(0.3)


def test_breakdown_names_the_host_op_in_a_gap():
    bd = trace.breakdown(trace.timeline(events()))
    assert bd["device_ops"][0] == ["void hb::rows_mc_kernel<1>", pytest.approx(4.0)]
    assert bd["idle_gaps"][0] == ["host idle", pytest.approx(1.0)]   # 0-1
    assert ["aten::item", pytest.approx(1.0)] in bd["idle_gaps"]    # 7-8
