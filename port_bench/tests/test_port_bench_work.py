"""The work counts of one iteration, against numbers reckoned by hand."""

import pytest

from port_bench import harness, work
from port_bench.work import ibrm, sbrm

H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("cell, bytes_, flops, least_ms", [
    # 50,000 x 65,536 int8 read once; 4 n m K float32 operations
    ("ibrm_bayesr_50k-k1", 3_276_800_000, 13_107_200_000, 3.2768e9 / 3.35e12 * 1e3),
    ("ibrm_bayesr_50k-k4", 3_276_800_000, 52_428_800_000, 3.2768e9 / 3.35e12 * 1e3),
    # 3,907 tile rows x 9 slots less 2 (4 + 3 + 2 + 1) off the ends = 35,143
    # tiles of 128^2 float32, and 2 T^2 operations a tile
    ("sbrm_bayescpi_tiled_500k-k1", 35_143 * 65_536, 35_143 * 32_768,
     35_143 * 65_536 / 3.35e12 * 1e3),
])
def test_iteration_work(cell, bytes_, flops, least_ms):
    w = harness.load("workloads", cell)
    cfg = harness.load("configs", w["config"])
    mod = {"ibrm": ibrm, "sbrm": sbrm}[cfg["entry"]]
    got = mod.iteration_work(cfg, w["traffic"]["chains"])
    assert got == {"bytes": bytes_, "flops": flops}
    secs, by = work.least_seconds(got, work.peaks(H100))
    assert by == "bytes"
    assert secs * 1e3 == pytest.approx(least_ms, rel=1e-12)


def test_valid_tiles_small_band():
    # 5 tile rows, a band of 3: rows 0 and 4 hold 2 tiles, the others 3
    assert sbrm.valid_tiles(5 * 128, 128, 3) == 13
    assert sbrm.valid_tiles(128, 128, 9) == 1


def test_operations_bound_where_they_dominate():
    secs, by = work.least_seconds({"bytes": 1.0, "flops": 6.7e13}, work.peaks(H100))
    assert by == "operations" and secs == pytest.approx(1.0)


def test_unknown_card_has_no_peaks():
    with pytest.raises(KeyError):
        work.peaks("a card with no published peaks")
