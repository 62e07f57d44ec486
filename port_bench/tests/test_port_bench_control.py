"""The control on the card: the plain reference in float32 with TF32
products, put in the chain's place, comes out not correct by the cell's
limits where the chain passes them.  A cut size of each configuration (its
widths kept) holds it in a test run; ``run.py --control 1`` reads it at the
cells' full sizes (PERF.md lists those readings)."""

import copy

import pytest
import torch

from port_bench import harness

CUT = {"ibrm": dict(n=8192, m=8192), "sbrm": dict(m=64_000)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the chain runs the CUDA kernels")


@pytest.mark.gpu
@pytest.mark.parametrize("cell_name, seed", [
    ("ibrm_bayesr_50k-k1", 3735928559), ("ibrm_bayesr_50k-k4", 2863311530),
    ("sbrm_bayescpi_tiled_500k-k1", 4008636142)])
def test_control_fails_where_the_chain_passes(card, cell_name, seed):
    cell = copy.deepcopy(harness.load("workloads", cell_name))
    cfg = copy.deepcopy(harness.load("configs", cell["config"]))
    cfg.update(CUT[cfg["entry"]])
    r = harness.run(cell_name, seed, 2.0, False, control=True, cell=cell, cfg=cfg)
    assert all(c["value"] <= c["limit"] for c in r["chain_checks"].values())
    assert not r["correct"]
