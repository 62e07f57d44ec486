"""The operations and bytes that one iteration's sweep needs, counted from a
configuration's shapes: ``work/<entry>.py`` holds ``iteration_work(cfg,
chains)`` for the configurations whose ``entry`` names it.  The counts are
the same whatever kernel does the work."""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = Path(__file__).resolve().parent.parent / "peaks.json"


def peaks(kind: str) -> dict:
    """The published peaks of the card named ``kind`` (peaks.json)."""
    table = json.loads(PEAKS.read_text())
    if kind not in table:
        raise KeyError(f"no published peaks for {kind!r} in {PEAKS.name}")
    return table[kind]


def least_seconds(work: dict, peak: dict) -> tuple:
    """(seconds, bound_by): the least time the card could take for ``work``,
    the larger of its bytes over the memory rate and its float32 operations
    over the float32 rate (the arithmetic of ``bound``, chip_smoke.py:488-494)."""
    t_b = work["bytes"] / peak["hbm_bytes_per_s"]
    t_f = work["flops"] / peak["f32_flops_per_s"]
    return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")
