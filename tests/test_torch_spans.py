"""The port's spans and counters (hibayes_tpu_torch/utils/profiling.py): one
in-memory store, on only while a torch.profiler records, its stamps mapped
onto the trace's clock by one marker operator.  No JAX: the last test runs
on the card without the JAX conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_spans.py -q
"""

import json
import tempfile
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hibayes_tpu_torch.data.ld import DenseLD
from hibayes_tpu_torch.engine import gibbs as TG
from hibayes_tpu_torch.engine import sgibbs as TSG
from hibayes_tpu_torch.ops import blockgibbs as TB
from hibayes_tpu_torch.utils import profiling
from hibayes_tpu_torch.utils.profiling import MARKER, count, device_trace, span, spans

torch.set_num_threads(2)

PHASES = ["engine.pre_sweep", "engine.sweep", "engine.post_sweep"]
PROGRAM = ("engine.", "ops.", "model.")


def ibrm(niter=6, nburn=2, thin=2, device="cpu"):
    """A small BayesR fit with one covariate and one factor of 4 levels."""
    rng = np.random.default_rng(5)
    n, m = 120, 40
    M = rng.binomial(2, 0.3, size=(n, m)).astype(np.int8)
    y = M @ rng.normal(0, 0.1, m) + rng.normal(0, 1, n)
    pi = np.array([0.95, 0.02, 0.02, 0.01])
    fold = np.array([0.0, 1e-4, 1e-3, 1e-2])
    codes = (rng.integers(0, 4, n),)
    data = TG.prepare_gibbs_data(y, M, C=rng.normal(size=(n, 1)), r_codes=codes,
                                 r_nlevels=(4,), fold=fold, block=16, geno_dtype="int8",
                                 device=device)
    pr = TG.resolve_priors(y, float(data.vx.sum()), pi[0], nr=1)
    spec = TG.GibbsSpec(
        model="BayesR", n=n, m=m, m_pad=int(data.xpx.shape[0]), block=16, nc=1,
        nlevels=(4,), n_fold=4, niter=niter, nburn=nburn, thin=thin, nvar0=0,
        dfvara=pr.dfvara, s2vara=pr.s2vara, dfvare=pr.dfvare, s2vare=pr.s2vare,
        dfr=pr.dfr, s2r=pr.s2r, s2varg=pr.s2varg)
    return spec, data, pr, pi


def sbrm(niter=6):
    """A small guarded BayesCpi fit on dense LD (the SBayesS guard on)."""
    rng = np.random.default_rng(6)
    m = 48
    X = rng.binomial(2, 0.3, size=(400, m)).astype(np.float64)
    X = (X - X.mean(0)) / X.std(0)
    ld = DenseLD(X.T @ X / 400)
    ss = np.column_stack([np.full(m, 0.3), rng.normal(0, 0.02, m), np.full(m, 0.05),
                          np.full(m, 2000.0)])
    data, n_eff, vary, nvar0, seg_sizes, seg_real = TSG.prepare_sgibbs_data(
        ss, ld, block=16)
    pi = np.array([0.95, 0.05])
    pr = TG.resolve_priors(None, float(np.sum(ld.diag)), pi[0], nr=0, vary=vary)
    spec = TG.GibbsSpec(
        model="BayesCpi", n=n_eff, m=m, m_pad=int(sum(seg_sizes)), block=16, nc=0,
        nlevels=(), n_fold=2, niter=niter, nburn=2, thin=2, nvar0=nvar0,
        dfvara=pr.dfvara, s2vara=pr.s2vara, dfvare=pr.dfvare, s2vare=pr.s2vare,
        s2varg=pr.s2varg, vargl_strict_pos=True, real_excl_nvar0=True,
        reject_guard=True, vary=vary, seg_sizes=seg_sizes, seg_real=seg_real)
    return spec, data, pr, pi


def traced(fn, activities=(ProfilerActivity.CPU,)):
    """fn() under torch.profiler: (its result, the spans, the complete
    events of its Chrome trace)."""
    with profile(activities=list(activities)) as prof:
        out = fn()
    recs = spans()
    with tempfile.TemporaryDirectory() as d:
        prof.export_chrome_trace(f"{d}/trace.json")
        with open(f"{d}/trace.json") as f:
            raw = json.load(f)
    return out, recs, [e for e in raw["traceEvents"] if e.get("ph") == "X"]


def iterations(recs):
    return [r for r in recs if r.name == "engine.iteration"]


def generators(recs, top):
    """rng.generators counted in span ``top`` and every span under it."""
    inside = {top.index}
    total = 0
    for r in recs[top.index:]:
        if r.index in inside or r.parent in inside:
            inside.add(r.index)
            total += (r.counts or {}).get("rng.generators", 0)
    return total


def test_off_records_nothing():
    """No profiler: span is the shared null context and a chain adds no
    record to the store (it keeps the latest session's)."""
    assert span("a") is span("b", it=3) is profiling._NULL
    count("rng.generators")
    _, recs, _ = traced(lambda: span("probe").__enter__().__class__)
    probe = spans()
    assert [r.name for r in probe] == ["probe"]
    spec, data, pr, pi = ibrm(niter=4)
    TG.run_chain(spec, data, pr, pi, seed=3)
    assert spans() == probe


def test_chain_iterations_and_phases():
    """One engine.iteration a chain iteration, with its ``it``; the three
    phases its children in order, the sweep's wrapper under the sweep; a
    record every thin iterations after burn-in; 9 generators an iteration
    (intercept, covariate, factor effect and variance, SNP z, BayesR u,
    marker variance, pi, Ve)."""
    spec, data, pr, pi = ibrm(niter=6, nburn=2, thin=2)
    _, recs, _ = traced(lambda: TG.run_chain(spec, data, pr, pi, seed=11))
    its = iterations(recs)
    assert [r.it for r in its] == list(range(6))
    for top in its:
        kids = [r for r in recs if r.parent == top.index]
        assert [r.name for r in kids] == PHASES
        assert all(r.it == top.it and top.t0 <= r.t0 <= r.t1 <= top.t1 for r in kids)
        ops = [r for r in recs if r.parent == kids[1].index]
        assert [r.name for r in ops] == ["ops.sweep_mc"]
        assert generators(recs, top) == 9
    assert sum(r.name == "engine.record" for r in recs) == spec.n_records
    assert any(r.name == "engine.flush" for r in recs)
    assert all(r.t1 is not None for r in recs)


def test_batch_counts_each_chains_generators():
    spec, data, pr, pi = ibrm(niter=4)
    _, recs, _ = traced(lambda: TG.run_chains(spec, data, pr, pi, seed=11, nchains=4))
    its = iterations(recs)
    assert [r.it for r in its] == list(range(4))
    assert [generators(recs, r) for r in its] == [36] * 4


def test_guarded_summary_chain_counts_seven():
    """SNP z, u, the guard's candidates, marker variance, pi, Vg, Ve."""
    spec, data, pr, pi = sbrm(niter=4)
    _, recs, _ = traced(lambda: TSG.run_s_chain(spec, data, pr, pi, seed=5))
    its = iterations(recs)
    assert [r.it for r in its] == list(range(4))
    for top in its:
        assert [r.name for r in recs if r.parent == top.index] == PHASES
        assert generators(recs, top) == 7


def test_prepare_spans():
    _, recs, _ = traced(lambda: ibrm())
    top = [r for r in recs if r.name == "model.prepare"]
    assert len(top) == 1 and top[0].parent is None
    assert [r.name for r in recs if r.parent == top[0].index] == ["model.layout", "model.gram"]


def _mapped(recs, events):
    """{index: (t0, t1)} of the spans on the trace's clock (us), by the marker."""
    marks = [e for e in events if e["name"] == MARKER]
    assert len(marks) == 1
    ts, dur, clock = marks[0]["ts"], marks[0]["dur"], profiling.clock_ns()
    return {r.index: (profiling.trace_us(r.t0, ts, dur, clock),
                      profiling.trace_us(r.t1, ts, dur, clock)) for r in recs}


def _ops(events, name):
    return [(e["ts"], e["ts"] + e["dur"]) for e in events
            if e["name"] == name and e.get("cat") == "cpu_op"]


def _within(op, interval):
    return interval[0] - TOL_US <= op[0] and op[1] <= interval[1] + TOL_US


TOL_US = 20.0


def test_clock_puts_each_op_inside_its_span():
    """Once mapped, every operator issued inside a span lies inside its
    interval, and none issued between spans does, within 20 us."""
    x = torch.ones((64, 64))

    def work():
        for k in range(4):
            with span(f"t.{k}"):
                for _ in range(3):
                    x @ x
            time.sleep(0.002)
            x + x            # between spans
            time.sleep(0.002)

    _, recs, events = traced(work)
    iv = _mapped(recs, events)
    mms, adds = _ops(events, "aten::matmul"), _ops(events, "aten::add")
    assert len(mms) == 12 and len(adds) == 4
    for k, r in enumerate(recs):
        a, b = iv[r.index]
        assert sum(_within(op, (a, b)) for op in mms) == 3, k
        assert not any(a - TOL_US <= op[0] <= b + TOL_US for op in adds)


def test_clock_on_a_chain():
    """The normals of each iteration's pre-sweep (intercept, covariate,
    factor, SNP z: four randn) lie inside that iteration's mapped
    engine.pre_sweep span, within 20 us."""
    spec, data, pr, pi = ibrm(niter=5)
    _, recs, events = traced(lambda: TG.run_chain(spec, data, pr, pi, seed=2))
    iv = _mapped(recs, events)
    randn = _ops(events, "aten::randn")
    assert len(randn) == 4 * spec.niter_eff
    for r in recs:
        if r.name == "engine.pre_sweep":
            assert sum(_within(op, iv[r.index]) for op in randn) == 4


def test_no_program_span_is_a_profiler_event():
    """The profiler's annotations hold no program span: the only event of
    the store in the trace is the clock marker."""
    spec, data, pr, pi = ibrm(niter=4)
    _, recs, events = traced(lambda: TG.run_chain(spec, data, pr, pi, seed=2))
    names = {r.name for r in recs}
    assert names >= {"engine.iteration", "engine.sweep", "ops.sweep_mc"}
    assert not names & {e["name"] for e in events}
    assert not any(e["name"].startswith(PROGRAM) for e in events)
    assert not any(e.get("cat") == "user_annotation" for e in events)
    assert sum(e["name"] == MARKER for e in events) == 1


def test_chains_bit_for_bit_with_spans_on_and_off():
    spec, data, pr, pi = ibrm(niter=6)
    st0, s0, _ = TG.run_chain(spec, data, pr, pi, seed=9)
    (st1, s1, _), recs, _ = traced(lambda: TG.run_chain(spec, data, pr, pi, seed=9))
    assert recs
    assert set(s0) == set(s1)
    for k in s0:
        np.testing.assert_array_equal(s0[k], s1[k])
    for k, v in st0._asdict().items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, getattr(st1, k)), k
    sspec, sdata, spr, spi = sbrm(niter=4)
    a = TSG.run_s_chain(sspec, sdata, spr, spi, seed=5)
    b, _, _ = traced(lambda: TSG.run_s_chain(sspec, sdata, spr, spi, seed=5))
    for k in a[1]:
        np.testing.assert_array_equal(a[1][k], b[1][k])
    np.testing.assert_array_equal(a[2]["guard"], b[2]["guard"])


def test_device_trace_writes_the_spans(tmp_path):
    spec, data, pr, pi = ibrm(niter=4)
    with device_trace(tmp_path):
        TG.run_chain(spec, data, pr, pi, seed=2)
    evs = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    mine = [e for e in evs if e.get("cat") == "hibayes_span"]
    assert [e["args"]["it"] for e in mine if e["name"] == "engine.iteration"] == [0, 1, 2, 3]
    marker = next(e for e in evs if e.get("name") == MARKER)
    first = min(e["ts"] for e in mine)
    assert marker["ts"] <= first
    it0 = next(e for e in mine if e["name"] == "engine.iteration")
    assert sum(e["args"].get("rng.generators", 0) for e in mine
               if e["args"]["it"] == 0) == 9
    assert it0["dur"] > 0


def test_store_is_bounded_and_resets_each_session(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 5)
    spans()      # no profiler records: the latest session is over

    def many():
        for k in range(8):
            with span("s", it=k):
                count("c", 2)
    _, recs, _ = traced(many)
    assert [r.it for r in recs] == [0, 1, 2, 3, 4]
    assert all(r.counts == {"c": 2} for r in recs)
    _, recs, _ = traced(lambda: span("t").__enter__())
    assert [r.name for r in recs] == ["t"]


def test_collectives_open_their_spans_and_count_their_bytes(tmp_path):
    """Each collective of parallel/distributed.py that runs (an axis of more
    than one rank) is one ``parallel.*`` span, inside the caller's, with the
    counter ``parallel.bytes``: the bytes of this rank's own part (the
    tensor summed, its part of a gather, the tensors a hop sends; a
    broadcast's on its source alone).  A SnpShard set-up's gathers of xpx
    and vx lie in ``model.shard_stats``.  On a one-rank axis nothing runs
    and no span opens.  Two gloo ranks (tests/torch_dist.py)."""
    from .torch_dist import spawn

    rng = np.random.default_rng(4)
    M = rng.binomial(2, 0.3, (30, 40)).astype(np.int8)
    outs = spawn("tests.torch_dist:collective_spans", 2, tmp_path,
                 {"M": M, "y": rng.normal(size=30)}, timeout=120)
    for rank, (recs, one) in enumerate(outs):
        mine = [(n, p, (c or {}).get("parallel.bytes")) for n, p, c in recs
                if n.startswith("parallel.") and p == "test.calls"]
        assert mine == [("parallel.axis_sum", "test.calls", 48),
                        ("parallel.broadcast", "test.calls", 48 if rank == 0 else 0),
                        ("parallel.broadcast", "test.calls", 16 if rank == 1 else 0),
                        ("parallel.all_gather", "test.calls", 24),
                        ("parallel.all_gather", "test.calls", 32 - 8 * rank),
                        ("parallel.ring_hop", "test.calls", 52)]
        stats = [(n, p, (c or {}).get("parallel.bytes")) for n, p, c in recs
                 if p == "model.shard_stats"]
        assert stats == [("parallel.all_gather", "model.shard_stats", 4 * 24)] * 2
        assert any(n == "model.shard_stats" and p == "model.prepare" for n, p, _ in recs)
        assert [n for n, _, _ in one] == ["test.calls"]


@pytest.mark.gpu
def test_sweep_launches_lie_inside_their_span():
    """On the card: each CUDA launch of a one-chain and a four-chain sweep
    lies inside its ops.sweep_mc span on the trace's clock, within 20 us."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec, data, pr, pi = ibrm(niter=4, device="cuda")

    def run():
        TG.run_chain(spec, data, pr, pi, seed=4)
        TG.run_chains(spec, data, pr, pi, seed=4, nchains=4)
        torch.cuda.synchronize()

    run()   # builds and loads the kernels
    _, recs, events = traced(run, (ProfilerActivity.CPU, ProfilerActivity.CUDA))
    iv = _mapped(recs, events)
    sweeps = [iv[r.index] for r in recs if r.name == "ops.sweep_mc"]
    assert len(sweeps) == 2 * spec.niter_eff
    hb = {e["args"].get("correlation") for e in events
          if e.get("cat") == "kernel" and "hb::" in e["name"]}
    launches = [(e["ts"], e["ts"] + e["dur"]) for e in events
                if e.get("cat") == "cuda_runtime" and e["name"].startswith("cudaLaunch")
                and e["args"].get("correlation") in hb]
    assert len(launches) >= 2 * spec.niter_eff
    for op in launches:
        assert any(_within(op, iv) for iv in sweeps), op


@pytest.mark.gpu
def test_iterations_make_no_host_sync():
    """On the card: a small ibrm with a factor, one chain and four, makes no
    synchronising runtime call inside an engine.iteration span, so
    host_syncs_per_iter (port_bench/metrics) reads 0: the factor's sums
    read nothing back to the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from port_bench.program_spans import SYNCS

    spec, data, pr, pi = ibrm(niter=6, device="cuda")

    def run():
        TG.run_chain(spec, data, pr, pi, seed=4)
        TG.run_chains(spec, data, pr, pi, seed=4, nchains=4)
        torch.cuda.synchronize()

    run()   # builds and loads the kernels
    _, recs, events = traced(run, (ProfilerActivity.CPU, ProfilerActivity.CUDA))
    iv = _mapped(recs, events)
    its = [iv[r.index] for r in iterations(recs)]
    assert len(its) == 2 * spec.niter_eff
    syncs = [e for e in events if e.get("cat") == "cuda_runtime" and SYNCS.match(e["name"])]
    assert syncs, "the trace holds the chain's closing synchronise"
    inside = [e["name"] for e in syncs if any(a <= e["ts"] <= b for a, b in its)]
    assert inside == []


@pytest.mark.gpu
def test_one_chain_sweeps_count_their_lookahead():
    """On the card: each one-chain sweep counts its kernel blocks launched
    (ops.sweep1.blocks, nbg) and the blocks whose right-hand side the
    lookahead formed (ops.sweep1.lookahead, nbg - 1) in its ops.sweep_mc
    span; a four-chain sweep counts neither; sweep1_lookahead_pct reads
    100 (nbg - 1) / nbg of a chain's iterations."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec, data, pr, pi = ibrm(niter=4, device="cuda")
    nbg = data.X_blocks.shape[0]
    TG.run_chain(spec, data, pr, pi, seed=4)   # builds and loads the kernels
    _, recs, _ = traced(lambda: (TG.run_chain(spec, data, pr, pi, seed=4),
                                 TG.run_chains(spec, data, pr, pi, seed=4, nchains=4)))
    counts = [r.counts or {} for r in recs if r.name == "ops.sweep_mc"]
    assert len(counts) == 2 * spec.niter_eff
    one, four = counts[:spec.niter_eff], counts[spec.niter_eff:]
    assert all(c == {"ops.sweep1.blocks": nbg, "ops.sweep1.lookahead": nbg - 1} for c in one)
    assert all("ops.sweep1.blocks" not in c and "ops.sweep1.lookahead" not in c for c in four)
    blocks = sum(c.get("ops.sweep1.blocks", 0) for c in counts)
    ahead = sum(c.get("ops.sweep1.lookahead", 0) for c in counts)
    assert 100.0 * ahead / blocks == pytest.approx(100.0 * (nbg - 1) / nbg)
