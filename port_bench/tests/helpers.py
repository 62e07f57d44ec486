"""Small configurations of the benchmark's cells for the CPU tests: the
cell and configuration files, cut to sizes the plain sweeps run in
seconds."""

from __future__ import annotations

import copy

from port_bench import harness

TINY = {"ibrm": dict(n=300, m=256, n_causal=20), "sbrm": dict(m=1000, N=5000)}


def tiny(cell_name: str) -> tuple:
    cell = copy.deepcopy(harness.load("workloads", cell_name))
    cfg = copy.deepcopy(harness.load("configs", cell["config"]))
    cfg.update(TINY[cfg["entry"]])
    cell["warmup_iters"] = 20
    return cell, cfg


def run_tiny(cell_name: str, seed: int = 20260, seconds: float = 1.0, control=False) -> dict:
    cell, cfg = tiny(cell_name)
    return harness.run(cell_name, seed, seconds, False, control=control, device="cpu",
                       require_chip=False, cell=cell, cfg=cfg)
