"""Chain batches of the port's individual-level engine
(hibayes_tpu_torch/engine/gibbs.py) against the JAX reference: one batched
iteration in f64 for all six models driven by each chain's JAX random
numbers, R-hat, the independence of a chain from the size of its batch,
and the entry points.  The summary-level batches are in
tests/test_torch_multichain_sbrm.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hibayes_tpu_torch as ht
from hibayes_tpu.engine import gibbs as G
from hibayes_tpu_torch.engine import gibbs as TG
from hibayes_tpu_torch.engine.convert import chain_state_from_numpy, gibbs_data_from_numpy
from hibayes_tpu_torch.engine.rng import IterNoise

from .torch_parity import (MODELS, JaxNoise, assert_state_fields, model_setup, port_spec,
                           stack_states, with_sparse_effects)

torch.set_num_threads(2)

K = 3
# as tests/test_torch_gibbs.py: n=4,100 is row-padded to 4,608; m=40 with
# B=24 leaves a ragged last block; a covariate, a factor and windows
SIZES = dict(n=4100, m=40, B=24, nc=1, nfactor=1, windows=True, warm=2)


@pytest.mark.parametrize("model", MODELS)
def test_one_iteration_batch_f64_matches_jax(model):
    """One iteration of K=3 chains, each from its own mid-run state (its own
    sparse effects), with each chain's JAX random numbers: every ChainState
    field of the port's batch matches JAX's ``one_iteration_batch``
    (use_pallas=False: the vmapped XLA sweep) to rtol 1e-9, as
    test_one_iteration_f64_matches_jax holds one chain."""
    s = model_setup(model, dtype=jnp.float64, **SIZES)
    spec, data = s["spec"], s["data"]
    states = stack_states([with_sparse_effects(s, seed=5 + k)["state"] for k in range(K)])
    chain_keys = jax.random.split(jax.random.PRNGKey(5), K)
    ref = G.one_iteration_batch(spec, data, chain_keys, states)
    it = int(states.it[0])
    out = TG.one_iteration_batch(port_spec(spec), gibbs_data_from_numpy(data), 0,
                                 chain_state_from_numpy(states),
                                 noise=[JaxNoise(chain_keys[k], it) for k in range(K)])
    assert out.it == it + 1 and it >= spec.nburn
    assert not np.array_equal(np.asarray(ref.g[0]), np.asarray(ref.g[1]))
    assert_state_fields(ref, out, TG.ChainState._fields[1:])


def test_rhat_matches_jax():
    """gelman_rubin and rhat_diagnostics equal JAX's on the same samples:
    scalars, a vector parameter with more entries than are subsampled, too
    few records, a constant trace (no within-chain variance), no entries."""
    rng = np.random.default_rng(2)
    samples = {
        "Vg": rng.normal(1.0, 0.1, (4, 20)),
        "Ve": rng.normal(1.0, 0.1, (4, 20)) + np.arange(4)[:, None] * 0.05,
        "alpha": rng.normal(size=(4, 20, 300)),
        "short": rng.normal(size=(4, 3)),
        "flat": np.ones((4, 20)),
        "beta": np.zeros((4, 20, 0)),
    }
    ref, out = G.rhat_diagnostics(samples), TG.rhat_diagnostics(samples)
    assert ref.keys() == out.keys()
    for k in ref:
        np.testing.assert_equal(out[k], ref[k], err_msg=k)
    assert np.isfinite(out["Vg"]) and np.isnan(out["short"]) and np.isnan(out["flat"])
    for k in ("Vg", "Ve", "short"):
        assert TG.gelman_rubin(samples[k]) == G.gelman_rubin(samples[k]) or k == "short"


def test_chain_zero_hashes_as_a_single_chain():
    """Chain 0's streams are the single chain's; chain 1's are others."""
    one = IterNoise(7, 3, "cpu", torch.float64)
    zero = IterNoise(7, 3, "cpu", torch.float64, chain=0)
    other = IterNoise(7, 3, "cpu", torch.float64, chain=1)
    assert torch.equal(one.normal(2, (5,)), zero.normal(2, (5,)))
    assert torch.equal(one.chisq(8, 10.0), zero.chisq(8, 10.0))
    assert not torch.equal(one.normal(2, (5,)), other.normal(2, (5,)))


@functools.cache
def _chain_setup(model="BayesR", dtype=torch.float64, resync_every=None):
    """A small chain on the CPU (f64 unless named): a covariate, a factor,
    windows."""
    s = model_setup(model, n=120, m=40, B=16, nc=1, nfactor=1, windows=True, warm=0)
    data = TG.prepare_gibbs_data(
        s["y"], s["M"], C=s["C"], r_codes=s["codes"], r_nlevels=s["nlev"],
        fold=s["fold"], windindx=s["windindx"], nw=s["nw"], block=16,
        dtype=dtype, geno_dtype="int8", device="cpu")
    spec = port_spec(s["spec"])
    over = {"niter": 30, "nburn": 10, "thin": 5}
    if resync_every is not None:
        over["resync_every"] = resync_every
    spec = spec.__class__(**{**spec.__dict__, **over})
    return spec, data, s["pr"], s["pi"]


def test_chain_k_does_not_depend_on_the_batch():
    """Chain k of a K=2 run is chain k of a K=3 run, bit for bit (samples
    and final state); chain 0 of the batch is the single chain to f64
    round-off (its streams are the single chain's); run_chains(nchains=1)
    is run_chain bit for bit."""
    spec, data, pr, pi = _chain_setup()
    s2, smp2, ex2 = TG.run_chains(spec, data, pr, pi, seed=3, nchains=2)
    s3, smp3, ex3 = TG.run_chains(spec, data, pr, pi, seed=3, nchains=3)
    assert smp3["alpha"].shape == (3, spec.n_records, spec.m)
    for k in smp2:
        np.testing.assert_array_equal(smp2[k], smp3[k][:2], err_msg=k)
    for name in ("g", "yadj", "vare", "nzrate", "wppa"):
        assert torch.equal(getattr(s2, name), getattr(s3, name)[:2]), name
    assert not np.array_equal(smp3["alpha"][0], smp3["alpha"][1])
    single, smp1, ex1 = TG.run_chain(spec, data, pr, pi, seed=3)
    for k in smp1:
        np.testing.assert_allclose(smp2[k][0], smp1[k], rtol=1e-9,
                                   atol=1e-9 * (np.abs(smp1[k]).max() + 1e-300), err_msg=k)
    b1, bsmp1, bex1 = TG.run_chains(spec, data, pr, pi, seed=3, nchains=1)
    for k in smp1:
        np.testing.assert_array_equal(bsmp1[k][0], smp1[k], err_msg=k)
    assert torch.equal(b1.g[0], single.g) and set(bex1["rhat"]) == set(ex3["rhat"])
    np.testing.assert_allclose(ex3["pip"], TG.posterior_rates(spec, s3)[0].mean(0)[: spec.m])


def test_batch_resync_in_f32():
    """In f32 the drift resync recomputes every chain's yadj and u from its
    effects each resync_every iterations, under one predicate for the batch
    (hibayes_tpu/engine/gibbs.py:2442-2469): right after one, each chain's
    residuals are its own single-chain recompute, to f32 rounding."""
    spec, data, pr, pi = _chain_setup(dtype=torch.float32, resync_every=4)
    runs = {}
    for every in (4, 0):
        sp = spec.__class__(**{**spec.__dict__, "resync_every": every})
        st = TG.stack_state(TG.init_state(sp, data, pr, pi), K)
        for _ in range(4):
            st = TG.one_iteration_batch(sp, data, 5, st)
        runs[every] = st
    st = runs[4]
    assert st.it == 4 and not torch.equal(st.yadj, runs[0].yadj)   # the resync ran
    for k in range(K):
        y_k, u_k = TG._recompute_residuals(spec, data, st.mu[k], st.beta[k],
                                           tuple(e[k] for e in st.estR), st.g[k])
        for got, want in ((st.yadj[k], y_k), (st.u[k], u_k)):
            torch.testing.assert_close(got, want, rtol=0,
                                       atol=1e-5 * float(want.abs().max()))


def test_run_chains_refuses_what_is_not_ported():
    spec, data, pr, pi = _chain_setup()
    for kw, item in ((dict(checkpoint_path="ck.npz"), "item 7"),
                     (dict(progress=True), "item 7"), (dict(mesh=object()), "item 13")):
        with pytest.raises(NotImplementedError, match=item):
            TG.run_chains(spec, data, pr, pi, nchains=2, **kw)


def test_ibrm_nchains_on_the_cpu():
    """ibrm(nchains=3): finite R-hat of Vg and Ve, the samples of all chains
    pooled (3 x n_records rows), posterior summaries from them."""
    rng = np.random.default_rng(0)
    n, m = 200, 64
    M = rng.binomial(2, 0.3, (n, m)).astype(np.int8)
    y = M @ np.where(rng.random(m) < 0.2, rng.normal(0, 0.3, m), 0.0) + rng.normal(0, 1, n)
    ids = np.array([f"i{k}" for k in range(n)])
    fit = ht.ibrm("T1 ~ 1", data={"id": ids, "T1": y}, M=M, M_id=ids, method="BayesCpi",
                  niter=80, nburn=40, nchains=3, verbose=False, device="cpu")
    assert np.isfinite(fit.rhat["Vg"]) and np.isfinite(fit.rhat["Ve"])
    assert fit.MCMCsamples["alpha"].shape == (3 * 8, m)
    assert fit.MCMCsamples["Vg"].shape == (3 * 8,)
    assert np.isfinite(fit.g["gebv"]).all() and 0 < fit.h2 < 1
    np.testing.assert_allclose(fit.Vg, fit.MCMCsamples["Vg"].mean())


def test_ssbrm_batches_still_raise():
    """ssbrm chain batches raise, naming their item."""
    rng = np.random.default_rng(0)
    ids = np.array([f"p{k}" for k in range(40)])
    with pytest.raises(NotImplementedError, match="item 6"):
        ht.ssbrm("y ~ 1", data={"id": ids, "y": rng.normal(size=40)},
                 M=rng.binomial(2, 0.3, (20, 8)).astype(np.int8), M_id=ids[:20],
                 pedigree={"id": ids, "sire": np.full(40, "0"), "dam": np.full(40, "0")},
                 niter=20, nburn=10, nchains=2, verbose=False, device="cpu")
