"""Checkpoint and resume of the port's chains (hibayes_tpu_torch/engine/
checkpoint.py and the segmented ``run_loop``), the cases of
tests/test_checkpoint.py: a segmented chain equals the unsegmented one, and
a chain killed after a checkpoint and resumed equals the uninterrupted
chain, bit for bit in float64 and in float32 on the CPU.  One ``ibrm``
chain and a batch of 3, a summary chain on dense LD and on tile-64 LD (the
guard firing: its counts carried), a BlockDiagLD batch of 2, and ``ssbrm``.
The kill is a save that raises once it has written its checkpoint.  Also:
a mismatched checkpoint raises, and the files and meta keys are the JAX
module's."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hibayes_tpu_torch as ht
from hibayes_tpu.engine import gibbs as G
from hibayes_tpu.engine.checkpoint import save_checkpoint as jax_save_checkpoint
from hibayes_tpu_torch.engine import checkpoint as CK
from hibayes_tpu_torch.engine import gibbs as TG
from hibayes_tpu_torch.engine import sgibbs as TSG
from hibayes_tpu_torch.engine.convert import sgibbs_data_from_numpy

from .torch_parity import port_spec, s_setup

torch.set_num_threads(2)

DTYPES = {"f64": torch.float64, "f32": torch.float32}


class Killed(Exception):
    """Stands for the process being killed once a checkpoint is written."""


def kill_after(monkeypatch, saves):
    """Make the ``saves``-th checkpoint write the last: it is written, then
    the run dies."""
    real = CK.save_checkpoint
    count = [0]

    def save(path, state, samples):
        real(path, state, samples)
        count[0] += 1
        if count[0] == saves:
            raise Killed(f"killed after save {saves}")

    monkeypatch.setattr(CK, "save_checkpoint", save)
    return count


def build(dtype, n=120, m=64, B=32, model="BayesCpi"):
    """tests/test_checkpoint.py:build on the port: BayesCpi, 100 iterations,
    burn-in 40, thin 5; float32 resyncs its residuals every 16 iterations,
    so a resume crosses a resync."""
    rng = np.random.default_rng(2)
    M = rng.binomial(2, 0.3, size=(n, m)).astype(np.int8)
    y = M @ rng.normal(0, 0.1, m) + rng.normal(0, 1, n)
    data = TG.prepare_gibbs_data(y, M, block=B, dtype=dtype, geno_dtype="int8",
                                 device="cpu")
    pi = np.array([0.95, 0.05])
    pr = TG.resolve_priors(y, float(data.vx.sum()), pi[0], nr=0)
    spec = TG.GibbsSpec(
        model=model, n=n, m=m, m_pad=int(data.xpx.shape[0]), block=B,
        nc=0, nlevels=(), n_fold=2, niter=100, nburn=40, thin=5,
        nvar0=int((data.vx[:m] == 0).sum()),
        dfvara=pr.dfvara, s2vara=pr.s2vara, dfvare=pr.dfvare, s2vare=pr.s2vare,
        s2varg=pr.s2varg, lambda_rate0=pr.lambda_rate0,
        resync_every=16 if dtype == torch.float32 else 0,
    )
    return spec, data, pr, pi


def assert_same_run(a, b):
    """Two (state, samples, extras) runs equal bit for bit: every sample,
    the final state, PIP and the guard's counts."""
    (sa, pa, ea), (sb, pb, eb) = a, b
    assert pa.keys() == pb.keys()
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)
    assert sa.it == sb.it
    for name in sa._fields[1:]:
        x, y = getattr(sa, name), getattr(sb, name)
        for u, v in (zip(x, y) if isinstance(x, tuple) else [(x, y)]):
            assert torch.equal(u, v), name
    np.testing.assert_array_equal(ea["pip"], eb["pip"])
    if "guard" in ea:
        np.testing.assert_array_equal(ea["guard"], eb["guard"])


# ---------------------------------------------------------------- ibrm engine


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("nchains", [1, 3])
def test_segmented_matches_fast_path(dt, nchains, tmp_path):
    spec, data, pr, pi = build(DTYPES[dt])
    fast = TG.run_chains(spec, data, pr, pi, seed=9, nchains=nchains)
    seg = TG.run_chains(spec, data, pr, pi, seed=9, nchains=nchains,
                        checkpoint_path=str(tmp_path / "ck"), chunk_records=3)
    assert_same_run(fast, seg)
    meta = json.load(open(tmp_path / "ck.meta.json"))
    assert meta["it"] == spec.niter_eff


@pytest.mark.parametrize("saves", [2, 5], ids=["in_burn_in", "after_burn_in"])
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("nchains", [1, 3])
def test_resume_after_kill(nchains, dt, saves, tmp_path, monkeypatch):
    """Saves come every 15 iterations in burn-in (40) and every 3 records
    after it: the second save is at iteration 30, the fifth at 70 with 6
    records collected."""
    spec, data, pr, pi = build(DTYPES[dt])
    ck = str(tmp_path / "ck")
    kill_after(monkeypatch, saves)
    with pytest.raises(Killed):
        TG.run_chains(spec, data, pr, pi, seed=9, nchains=nchains, checkpoint_path=ck,
                      chunk_records=3)
    monkeypatch.undo()
    meta = json.load(open(ck + ".meta.json"))
    assert meta["it"] == (30 if saves == 2 else 70)
    resumed = TG.run_chains(spec, data, pr, pi, seed=9, nchains=nchains,
                            checkpoint_path=ck, chunk_records=3)
    full = TG.run_chains(spec, data, pr, pi, seed=9, nchains=nchains)
    assert_same_run(full, resumed)


def test_finished_checkpoint_reruns_as_a_no_op(tmp_path, capsys):
    """A run started again on a finished chain's checkpoint iterates no
    more and returns the same records."""
    spec, data, pr, pi = build(torch.float64)
    ck = str(tmp_path / "ck")
    first = TG.run_chain(spec, data, pr, pi, seed=9, checkpoint_path=ck)
    again = TG.run_chain(spec, data, pr, pi, seed=9, checkpoint_path=ck, progress=True)
    assert f"resumed from iteration {spec.niter_eff}" in capsys.readouterr().out
    assert_same_run(first, again)


# ------------------------------------------------------------- summary engine


def summary_setup(layout, dt, vary=None):
    """A summary chain on the port from tests/torch_parity.py:s_setup (m=200):
    BayesCpi, 60 iterations, burn-in 20, thin 5."""
    s = s_setup("BayesCpi", layout, m=200,
                dtype=jnp.float64 if dt == "f64" else jnp.float32)
    over = {"niter": 60, "nburn": 20, "thin": 5}
    if vary is not None:
        over["vary"] = vary
    spec = port_spec(s["spec"])
    spec = spec.__class__(**{**spec.__dict__, **over})
    return spec, sgibbs_data_from_numpy(s["data"]), s["pr"], s["pi"]


# a vary at which the guard rejects draws on these data
# (tests/test_torch_sgibbs_guard.py)
LOW_VARY = 4.5e-3


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("layout,nchains", [("dense", 1), ("tiled64", 1), ("blockdiag", 2),
                                            ("tiled64", 2)])
def test_summary_segmented_and_resume(layout, nchains, dt, tmp_path, monkeypatch):
    """Segmented equals unsegmented, and a run killed after its third save
    (iteration 30, two records) and resumed equals the uninterrupted run,
    guard counts included: on tile-64 and BlockDiagLD the guard fires at a
    lowered vary, so the counts carried across the kill are not zero (a
    batch's per chain)."""
    spec, data, pr, pi = summary_setup(layout, dt, None if layout == "dense" else LOW_VARY)
    run = lambda **kw: TSG.run_s_chains(spec, data, pr, pi, seed=5, nchains=nchains, **kw)
    full = run()
    assert_same_run(full, run(checkpoint_path=str(tmp_path / "seg"), chunk_records=2))
    if layout != "dense":
        assert full[2]["guard"][:, 0].sum() > 0, "the guard should fire"
    ck = str(tmp_path / "ck")
    kill_after(monkeypatch, 3)
    with pytest.raises(Killed):
        run(checkpoint_path=ck, chunk_records=2)
    monkeypatch.undo()
    assert json.load(open(ck + ".meta.json"))["it"] == 30
    assert_same_run(full, run(checkpoint_path=ck, chunk_records=2))


# --------------------------------------------------------------- entry points


def _ssbrm_kw(rng):
    nfound, nkid = 30, 120
    ids = np.array([f"f{i}" for i in range(nfound)] + [f"k{i}" for i in range(nkid)])
    sires = np.concatenate([np.full(nfound, "0"), rng.choice(ids[:nfound], nkid)])
    dams = np.concatenate([np.full(nfound, "0"), rng.choice(ids[:nfound], nkid)])
    geno_ids = ids[rng.random(len(ids)) < 0.6]
    M = rng.binomial(2, 0.35, (len(geno_ids), 48)).astype(np.int8)
    phe_ids = ids[rng.random(len(ids)) < 0.7]
    return dict(data={"id": phe_ids, "y": rng.normal(0, 1, len(phe_ids))}, M=M,
                M_id=geno_ids, pedigree={"id": ids, "sire": sires, "dam": dams},
                method="BayesCpi", niter=60, nburn=20, thin=5, verbose=False,
                printfreq=10, device="cpu")


@pytest.mark.parametrize("dt", list(DTYPES))
def test_ssbrm_checkpoint_resume(dt, tmp_path, monkeypatch):
    """tests/test_checkpoint.py's ssbrm case: a checkpointed fit equals the
    plain one, a fit killed after its fourth save (iteration 40) and
    resumed (its set-up redone) equals it too, bit for bit, and a rerun on
    the finished checkpoint is a no-op."""
    kw = {**_ssbrm_kw(np.random.default_rng(6)), "dtype": DTYPES[dt]}
    plain = ht.ssbrm("y~1", **kw)
    ck = str(tmp_path / "ssck")
    kill_after(monkeypatch, 4)
    with pytest.raises(Killed):
        ht.ssbrm("y~1", checkpoint=ck, **kw)
    monkeypatch.undo()
    assert json.load(open(ck + ".meta.json"))["it"] == 40
    for fit in (ht.ssbrm("y~1", checkpoint=ck, **kw), ht.ssbrm("y~1", checkpoint=ck, **kw)):
        for k in plain.MCMCsamples:
            np.testing.assert_array_equal(fit.MCMCsamples[k], plain.MCMCsamples[k], err_msg=k)
        np.testing.assert_array_equal(fit.g["gebv"], plain.g["gebv"])
        assert fit.Veps == plain.Veps


def test_ssbrm_batch_checkpoint_resume(tmp_path, monkeypatch):
    """An ssbrm batch of 3 chains (float64): a fit killed after its fourth
    save (iteration 28, past burn-in: a batch saves every tenth of its
    records, two of 20) and
    resumed, its set-up redone, equals the uninterrupted batch bit for bit,
    each chain's records, the pooled GEBV and R-hat."""
    kw = {**_ssbrm_kw(np.random.default_rng(6)), "nchains": 3, "niter": 100, "nburn": 20,
          "thin": 4}
    plain = ht.ssbrm("y~1", **kw)
    ck = str(tmp_path / "ssck3")
    kill_after(monkeypatch, 4)
    with pytest.raises(Killed):
        ht.ssbrm("y~1", checkpoint=ck, **kw)
    monkeypatch.undo()
    assert json.load(open(ck + ".meta.json"))["it"] == 28
    fit = ht.ssbrm("y~1", checkpoint=ck, **kw)
    for k in plain.MCMCsamples:
        np.testing.assert_array_equal(fit.MCMCsamples[k], plain.MCMCsamples[k], err_msg=k)
    np.testing.assert_array_equal(fit.g["gebv"], plain.g["gebv"])
    np.testing.assert_equal(fit.rhat, plain.rhat)   # nan where a trace is flat
    assert fit.MCMCsamples["Veps"].shape == (3 * 20,)


# ---------------------------------------------------------- files and checks


def test_files_and_meta_keys_match_the_jax_module(tmp_path):
    """The JAX engine's checkpoint of the same chain and the port's: the
    same two files, the same meta keys and values (the number of state
    leaves, the record keys, the iteration), the same npz keys."""
    spec, data, pr, pi = build(torch.float64)
    rng = np.random.default_rng(2)
    M = rng.binomial(2, 0.3, size=(120, 64)).astype(np.int8)
    y = M @ rng.normal(0, 0.1, 64) + rng.normal(0, 1, 120)
    jdata = G.prepare_gibbs_data(y, M, block=32, dtype=jnp.float64, geno_dtype="int8")
    jspec = G.GibbsSpec(**{k: getattr(spec, k) for k in spec.__dataclass_fields__})
    G.run_chain(jspec, jdata, pr, pi, seed=9, checkpoint_path=str(tmp_path / "jax"))
    TG.run_chain(spec, data, pr, pi, seed=9, checkpoint_path=str(tmp_path / "port"))
    files = sorted(os.listdir(tmp_path))
    assert files == ["jax.meta.json", "jax.npz", "port.meta.json", "port.npz"]
    mj = json.load(open(tmp_path / "jax.meta.json"))
    mp = json.load(open(tmp_path / "port.meta.json"))
    assert mj == mp and sorted(mp) == ["it", "n_leaves", "sample_keys"]
    # every field a leaf but estR, an empty tuple here (no factor)
    assert mp["it"] == spec.niter_eff and mp["n_leaves"] == len(TG.ChainState._fields) - 1
    with np.load(tmp_path / "jax.npz") as fj, np.load(tmp_path / "port.npz") as fp:
        assert sorted(fj.files) == sorted(fp.files)


def test_mismatched_checkpoint_raises(tmp_path):
    """A checkpoint of another spec, or one written by the JAX package,
    does not load: the ValueError names the field that differs."""
    spec, data, pr, pi = build(torch.float64)
    ck = str(tmp_path / "ck")
    TG.run_chain(spec, data, pr, pi, seed=9, checkpoint_path=ck)
    other, odata, opr, opi = build(torch.float64, m=72)
    with pytest.raises(ValueError, match="'g'"):
        TG.run_chain(other, odata, opr, opi, seed=9, checkpoint_path=ck)
    f32 = build(torch.float32)
    with pytest.raises(ValueError, match="'mu'"):
        TG.run_chain(*f32, seed=9, checkpoint_path=ck)
    with pytest.raises(ValueError, match="state leaves"):
        TSG.run_s_chain(*summary_setup("dense", "f64"), seed=5, checkpoint_path=ck)
    # the JAX package's checkpoint of the same chain: its iteration is int32
    jstate = G.init_state(G.GibbsSpec(**{k: getattr(spec, k)
                                         for k in spec.__dataclass_fields__}),
                          G.prepare_gibbs_data(np.zeros(120), np.zeros((120, 64)), block=32,
                                               dtype=jnp.float64), pr, pi)
    jck = str(tmp_path / "jck")
    jax_save_checkpoint(jck, jax.device_get(jstate), {})
    with pytest.raises(ValueError, match="'it'"):
        TG.run_chain(spec, data, pr, pi, seed=9, checkpoint_path=jck)
