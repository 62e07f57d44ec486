"""BSLMM on the port against the JAX reference: the GRM (math/grm.py), one
iteration of one chain and of a batch in float64 with the polygenic block
draw in JAX's own eigenbasis and on JAX's own random numbers, the
pseudo-inverse map of the polygenic effect into SNP space, and a short fit
on the synthetic data of tests/test_bslmm.py."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hibayes_tpu_torch as ht
from hibayes_tpu.engine import gibbs as G
from hibayes_tpu.math.grm import make_grm as jax_make_grm
from hibayes_tpu.model.ibrm import _assemble_results as jax_assemble_results
from hibayes_tpu_torch.engine import gibbs as TG
from hibayes_tpu_torch.engine.convert import chain_state_from_numpy, gibbs_data_from_numpy
from hibayes_tpu_torch.math.grm import make_grm
from hibayes_tpu_torch.model.ibrm import bslmm_snp_effects

from .torch_parity import (JaxNoise, assert_state_fields, port_spec, stack_states,
                           with_sparse_effects)

torch.set_num_threads(2)


def _geno(n=150, m=64, seed=3):
    rng = np.random.default_rng(seed)
    M = rng.binomial(2, rng.uniform(0.1, 0.5, m), size=(n, m)).astype(np.int8)
    M[:, 5] = 1   # monomorphic
    return M


# ------------------------------------------------------------------ the GRM


@pytest.mark.parametrize("kind", ["int8", "float"])
@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_make_grm_matches_jax(dt, kind):
    """G, G + lambda I's eigenvalues and inv(G + lambda I) against JAX's
    make_grm on int8 and float input.  float64: G and the inverse to rtol
    1e-10, the eigenvalues to 1e-10 of the largest; float32: 1e-5 (the
    mean corrections and the products round in other orders)."""
    M = _geno()
    X = M if kind == "int8" else M.astype(np.float32 if dt == "f32" else np.float64)
    jdt, tdt = (jnp.float64, torch.float64) if dt == "f64" else (jnp.float32, torch.float32)
    tol = 1e-10 if dt == "f64" else 1e-5
    Gj = np.asarray(jax_make_grm(X, dtype=jdt))
    Gt = make_grm(X, dtype=tdt).numpy()
    assert Gt.dtype == Gj.dtype
    np.testing.assert_allclose(Gt, Gj, rtol=0, atol=tol * np.abs(Gj).max())
    vj, _ = jax_make_grm(X, lambda_=0.1, eigen=True, dtype=jdt)
    vt, Kt = make_grm(X, lambda_=0.1, eigen=True, dtype=tdt)
    vj = np.asarray(vj)
    assert (np.diff(vt.numpy()) >= 0).all()
    np.testing.assert_allclose(vt.numpy(), vj, rtol=0, atol=tol * np.abs(vj).max())
    # an orthonormal eigenbasis of G + 0.1 I
    np.testing.assert_allclose((Kt * vt) @ Kt.T, Gt + 0.1 * np.eye(len(Gt)), rtol=0,
                               atol=10 * tol * np.abs(Gj).max())
    Ij = np.asarray(jax_make_grm(X, lambda_=0.5, inverse=True, dtype=jdt))
    It = make_grm(X, lambda_=0.5, inverse=True, dtype=tdt).numpy()
    np.testing.assert_allclose(It, Ij, rtol=0, atol=10 * tol * np.abs(Ij).max())


def test_make_grm_int8_product_is_exact():
    """The int8 path's MM' is the exact integer product: G equals the float64
    formula applied to it, and the default type is JAX's float32."""
    M = _geno(n=40, m=300)
    S = M.astype(np.int64) @ M.astype(np.int64).T
    G = make_grm(M, dtype=torch.float64).numpy()
    mu = M.mean(0)
    v = M.astype(np.float64) @ mu
    ref = S - v[:, None] - v[None, :] + mu @ mu
    np.testing.assert_allclose(G, ref / np.diag(ref).mean(), rtol=1e-12, atol=1e-12)
    assert make_grm(M).dtype == torch.float32


# ---------------------------------------------------------- one iteration


def _bslmm_setup(n=120, m=200, B=16, warm=2, seed=4):
    """JAX data of a BSLMM chain (a covariate, a factor) with the GRM
    eigenbasis of JAX's make_grm in float64, and a state after ``warm``
    JAX iterations.  m > n, BSLMM's regime: the centred GRM has rank
    n - 1."""
    rng = np.random.default_rng(seed)
    M = _geno(n, m, seed)
    y = M.astype(np.float64) @ rng.normal(0, 0.1, m) + rng.normal(0, 1, n)
    C = rng.normal(size=(n, 1))
    codes = (rng.integers(0, 5, n),)
    Kval, K = jax_make_grm(M, eigen=True, dtype=jnp.float64)
    data = G.prepare_gibbs_data(y, M, C=C, r_codes=codes, r_nlevels=(5,), K=K, Kval=Kval,
                                block=B, dtype=jnp.float64, geno_dtype="int8")
    pi = np.array([0.95, 0.05])
    pr = G.resolve_priors(y, float(np.asarray(data.vx).sum()), pi[0], nr=1)
    spec = G.GibbsSpec(
        model="BSLMM", n=n, m=m, m_pad=int(data.xpx.shape[0]), block=B, nc=1,
        nlevels=(5,), n_fold=2, niter=40, nburn=2, thin=5,
        nvar0=int((np.asarray(data.vx)[:m] == 0).sum()),
        dfvara=pr.dfvara, s2vara=pr.s2vara, dfvare=pr.dfvare, s2vare=pr.s2vare,
        dfr=pr.dfr, s2r=pr.s2r, s2varg=pr.s2varg, lambda_rate0=pr.lambda_rate0,
        resync_every=0, use_bslmm=True)
    state = G.init_state(spec, data, pr, pi)
    base = jax.random.PRNGKey(seed)
    for _ in range(warm):
        state = G.one_iteration(spec, data, base, state)
    return dict(M=M, y=y, data=data, spec=spec, state=state, pr=pr, pi=pi)


def _vb_rounding(ref, data, spec):
    """How far vbtmp (and vb) may sit from the reference's by rounding alone.
    The polygenic variance is quad = sum_i Kg_i^2 / Kval_i with Kg = K' k;
    each Kg_i is a sum of n products, off by up to n eps max|k| between two
    orders of summation, and the centred GRM's null eigenvalue is
    round-off, so that error is amplified by 1/|Kval_i|.  To first order
    vbtmp = (quad + s2) / chi moves by vbtmp dquad / (quad + s2)."""
    K, Kv = np.asarray(data.K), np.asarray(data.Kval)
    k = np.asarray(ref.k_estR)
    Kg = k @ K
    err = k.shape[-1] * np.finfo(np.float64).eps * np.abs(k).max(-1, keepdims=True)
    dquad = (2 * np.abs(Kg) * err / np.abs(Kv)).sum(-1)
    quad = (Kg * Kg / Kv).sum(-1)
    dv = np.abs(np.asarray(ref.vbtmp)) * dquad / np.abs(quad + spec.s2vara * spec.dfvara)
    return {"vbtmp": dv, "vb": dv}


def test_one_iteration_bslmm_f64_matches_jax():
    """One BSLMM iteration from a mid-run JAX state (the polygenic term
    already drawn twice) with JAX's random numbers and eigenbasis: every
    ChainState field, k_estR, va included, to rtol 1e-9; vbtmp and vb to
    rtol 1e-9 plus their rounding bound (:func:`_vb_rounding`)."""
    s = _bslmm_setup()
    spec, data, state = s["spec"], s["data"], s["state"]
    assert np.abs(np.asarray(state.k_estR)).max() > 0
    key = jax.random.PRNGKey(5)
    ref = G.one_iteration(spec, data, key, state)
    out = TG.one_iteration(port_spec(spec), gibbs_data_from_numpy(data), 0,
                           chain_state_from_numpy(state), noise=JaxNoise(key, int(state.it)))
    assert out.it == int(ref.it)
    assert float(out.va) == float(out.varg)   # BSLMM: Va is the marker variance
    assert_state_fields(ref, out, TG.ChainState._fields[1:],
                        spread=_vb_rounding(ref, data, spec))


def test_one_iteration_batch_bslmm_f64_matches_jax():
    """One iteration of 3 BSLMM chains, each from its own mid-run state, with
    each chain's JAX numbers: the batch's polygenic draws (products over the
    chain axis) match JAX's ``one_iteration_batch`` to rtol 1e-9, vbtmp and
    vb with their rounding bound (:func:`_vb_rounding`): the batch's
    products sum in another order than the single chain's."""
    s = _bslmm_setup()
    spec, data = s["spec"], s["data"]
    states = stack_states([with_sparse_effects(s, seed=5 + k)["state"] for k in range(3)])
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    ref = G.one_iteration_batch(spec, data, keys, states)
    it = int(states.it[0])
    out = TG.one_iteration_batch(port_spec(spec), gibbs_data_from_numpy(data), 0,
                                 chain_state_from_numpy(states),
                                 noise=[JaxNoise(keys[k], it) for k in range(3)])
    assert not np.array_equal(np.asarray(ref.k_estR[0]), np.asarray(ref.k_estR[1]))
    assert_state_fields(ref, out, TG.ChainState._fields[1:],
                        spread=_vb_rounding(ref, data, spec))


def test_bslmm_snp_effects_match_jax():
    """The pseudo-inverse map of the posterior-mean polygenic effect into
    SNP space (JAX model/ibrm.py:319-330) on the same samples and
    eigenbasis: JAX's fit adds it to every effect sample, the port's
    ``bslmm_snp_effects`` returns it; equal to rtol 1e-9.  The centred
    GRM's null eigenvalue is below the 1e-6 cut."""
    s = _bslmm_setup(warm=0)
    M, y, data = s["M"], s["y"], s["data"]
    n, m = M.shape
    Kv = np.asarray(data.Kval)
    assert (Kv <= 1e-6 * Kv.max()).sum() >= 1
    rng = np.random.default_rng(8)
    recs = 6
    samples = {"alpha": rng.normal(0, 0.01, (recs, m)), "mu": rng.normal(size=recs),
               "pi": np.full((recs, 2), 0.5), "beta": np.zeros((recs, 0)),
               "Vr": np.zeros((recs, 0)), "r": np.zeros((recs, 0)),
               "Vg": np.ones(recs), "Ve": np.ones(recs), "h2": np.full(recs, 0.5),
               "Va": np.ones(recs), "Vb": np.ones(recs),
               "k_estR": rng.normal(0, 0.3, (recs, n))}
    spec = types.SimpleNamespace(nc=0, nlevels=())
    mf = types.SimpleNamespace(X=None, X_names=[], R_levels=[], R_codes=[], R_names=[])
    sumvx = float(np.asarray(data.vx).sum())
    ids = np.array([f"i{k}" for k in range(n)])
    res = jax_assemble_results("BSLMM", "y~1", spec, samples, {"pip": None, "wppa": None},
                               mf, y, ids, np.ones(n, bool), M, None, None,
                               K=np.asarray(data.K), Kval=Kv, sumvx=sumvx)
    ref = res.alpha - samples["alpha"].mean(0)
    out = bslmm_snp_effects(gibbs_data_from_numpy(data), n, m,
                            samples["k_estR"].mean(0), sumvx)
    np.testing.assert_allclose(out, ref, rtol=1e-9, atol=1e-12 * np.abs(ref).max())


# ------------------------------------------------------------------- a fit


def test_bslmm_synthetic_fit():
    """The synthetic data of tests/test_bslmm.py (polygenic background and 5
    large effects, n=300, m=400) at 300 iterations: Va and Vb finite and
    non-negative, finite effects, and the GEBV accuracy over that test's
    0.55; a batch of 2 chains runs too."""
    rng = np.random.default_rng(31)
    n, m = 300, 400
    M = rng.binomial(2, rng.uniform(0.1, 0.5, m), size=(n, m)).astype(np.float32)
    b_small = rng.normal(0, 0.03, m)
    b_big = np.zeros(m)
    b_big[rng.choice(m, 5, replace=False)] = rng.normal(0, 0.8, 5)
    gv = M @ (b_small + b_big)
    gv = (gv - gv.mean()) / gv.std()
    y = gv + rng.normal(0, 1.0, n)
    ids = np.array([f"i{k}" for k in range(n)])
    kw = dict(data={"id": ids, "y": y}, M=M.astype(np.int8), M_id=ids, method="BSLMM",
              verbose=False, device="cpu")
    fit = ht.ibrm("y~1", niter=300, nburn=150, **kw)
    assert fit.Va is not None and fit.Vb is not None
    assert np.isfinite([fit.Va, fit.Vb]).all() and fit.Va >= 0 and fit.Vb >= 0
    assert np.isfinite(fit.alpha).all() and fit.MCMCsamples["k_estR"].shape == (30, n)
    corr = np.corrcoef(fit.g["gebv"], gv)[0, 1]
    assert corr > 0.55, f"BSLMM GEBV corr too low: {corr}"
    fits = ht.ibrm("y~1", niter=40, nburn=20, nchains=2, lambda_=0.5, **kw)
    assert fits.MCMCsamples["Vb"].shape == (8,) and np.isfinite(fits.Vb)
