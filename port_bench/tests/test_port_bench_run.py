"""Runs of the harness: without a card it prints no result; on the CPU at
small sizes (the plain sweeps in the card's place) a sound run is correct
and its last line has the required keys, and a run whose timed path is
broken underneath comes out not correct."""

import dataclasses
import json
import subprocess
import sys

import torch

from hibayes_tpu_torch.engine import gibbs as G
from hibayes_tpu_torch.ops import blockgibbs

from port_bench import harness
from port_bench.tests.helpers import run_tiny, tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_no_card_no_result():
    if torch.cuda.is_available():
        return   # the chip's machine: the other tests speak for it
    p = subprocess.run([sys.executable, str(harness.BENCH / "run.py"), "--workload",
                        "ibrm_bayesr_50k-k1", "--seed", "2147483648", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, timeout=300,
                       cwd=harness.ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_sound_run_is_correct_and_keyed():
    r = run_tiny("ibrm_bayesr_50k-k1")
    assert list(r)[:5] == KEYS and list(r)[-1] == "checks"
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"iter_ms", "peak_mem_gib", "setup_s"}
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(r)


def test_state_left_unchanged_fails(monkeypatch):
    orig = G.one_iteration
    monkeypatch.setattr(G, "one_iteration",
                        lambda spec, data, seed, state, **kw: orig(
                            spec, data, seed, state, **kw) if state.it < 2
                        else state._replace(it=state.it + 1))
    r = run_tiny("ibrm_bayesr_50k-k1")
    assert not r["correct"]


def test_effect_altered_where_drawn_fails(monkeypatch):
    orig = blockgibbs.sweep_mc

    def altered(*args, **kw):
        out = list(orig(*args, **kw))
        g = out[0].clone()
        g[..., 7] += 0.5
        return (g, *out[1:])

    monkeypatch.setattr(blockgibbs, "sweep_mc", altered)
    assert not run_tiny("ibrm_bayesr_50k-k1")["correct"]


def test_half_the_batch_left_out_fails(monkeypatch):
    orig = G.one_iteration_batch

    def half(spec, data, seed, states, **kw):
        out = orig(spec, data, seed, states, **kw)
        keep = lambda a, b: torch.cat([a[:2], b[2:]])
        return out._replace(**{k: (tuple(keep(x, y) for x, y in zip(v, getattr(states, k)))
                                    if isinstance(v, tuple) else keep(v, getattr(states, k)))
                                for k, v in out._asdict().items() if k != "it"})

    monkeypatch.setattr(G, "one_iteration_batch", half)
    assert not run_tiny("ibrm_bayesr_50k-k4")["correct"]


def test_summary_sweep_sound_and_altered(monkeypatch):
    assert run_tiny("sbrm_bayescpi_tiled_500k-k1")["correct"]
    orig = blockgibbs.sweep_s_tiled

    def altered(*args, **kw):
        dg, track, r_hat, rej = orig(*args, **kw)
        dg = dg.clone()
        dg[..., 3] -= 0.05
        return dg, track, r_hat, rej

    monkeypatch.setattr(blockgibbs, "sweep_s_tiled", altered)
    assert not run_tiny("sbrm_bayescpi_tiled_500k-k1")["correct"]


def test_guard_left_out_fails(monkeypatch):
    """Effects large enough that the SBayesS guard rejects draws (the cell's
    own never reach that): sound, the run is correct; with the sweep's
    rejection switched off underneath, it is not."""
    cell, cfg = tiny("sbrm_bayescpi_tiled_500k-k1")
    cfg["causal_sd"] = 2.0
    run = lambda: harness.run(cell["name"], 20260, 1.0, False, device="cpu",
                              require_chip=False, cell=cell, cfg=cfg)
    orig = blockgibbs.sweep_s_tiled
    rejected = []

    def counted(*args, **kw):
        out = orig(*args, **kw)
        rejected.append(int(out[3].sum()))
        return out

    monkeypatch.setattr(blockgibbs, "sweep_s_tiled", counted)
    assert run()["correct"] and sum(rejected) > 0
    monkeypatch.setattr(blockgibbs, "sweep_s_tiled", lambda spec, *args, **kw: orig(
        dataclasses.replace(spec, vary=float("inf")), *args, **kw))
    r = run()
    assert not r["correct"] and r["checks"]["choice_gap"]["value"] > 0.01


def test_control_stands_in_the_chains_place():
    """With --control 1 the control's readings decide ``correct`` by the
    chain's limits; at this size the TF32 control already fails ibrm's."""
    r = run_tiny("ibrm_bayesr_50k-k1", control=True)
    assert all(c["value"] <= c["limit"] for c in r["chain_checks"].values())
    assert set(r["checks"]) == {"choice_gap", "effect_gap"} and list(r)[-1] == "checks"
    assert not r["correct"] and r["failed"] > 0
