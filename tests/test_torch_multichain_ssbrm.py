"""Chain batches of the port's single-step path (the J and epsilon terms in
hibayes_tpu_torch/engine/gibbs.py, ssbrm(nchains>1)) against the JAX
reference on the CPU: one batched iteration in f64 for all six models on
the sparse and dense A-inverse layouts, driven by each chain's JAX random
numbers; the K-chain epsilon sweep's plain version against its one-chain
calls; and ssbrm(nchains=3) against the JAX package's batch."""

import jax
import numpy as np
import pytest
import torch

import hibayes_tpu_torch as htt
from hibayes_tpu.engine import gibbs as G
from hibayes_tpu.model.ssbrm import ssbrm as jax_ssbrm
from hibayes_tpu_torch.engine import gibbs as TG
from hibayes_tpu_torch.engine.convert import chain_state_from_numpy, gibbs_data_from_numpy
from hibayes_tpu_torch.ops import blockgibbs as TB

from .test_torch_ssbrm import _partition, _ss_problem, _ss_setup
from .torch_parity import MODELS, JaxNoise, assert_state_fields, port_spec, stack_states

torch.set_num_threads(2)

K = 3


def _chain_states(spec, data, state, K):
    """K mid-run states of one single-step problem (tests/test_torch_ssbrm.py:
    _ss_setup's recipe, each chain from its own seed): sparse g, J_beta,
    epsilon, Veps and residuals consistent with them."""
    n, ne, qe = spec.n, spec.ne, spec.qe
    base = np.asarray(state.yadj) + np.asarray(state.u)   # y - mu as init_state left it
    Xb = np.asarray(data.X_blocks)
    X = Xb.transpose(1, 0, 2).reshape(n, -1)
    yJ, codes = np.asarray(data.epsl_yJ), np.asarray(data.epsl_codes)
    out = []
    for k in range(K):
        rng = np.random.default_rng(40 + k)
        g = np.where((rng.random(spec.m_pad) < 0.3) & np.asarray(data.real),
                     rng.normal(0, 0.05, spec.m_pad), 0.0)
        eps = np.zeros_like(np.asarray(state.epsl_estR))
        eps[:qe] = rng.normal(0, 0.2, qe)
        J = 0.3 + 0.1 * k
        u = X @ g + J * yJ
        u[n - ne:] += eps[codes]
        out.append(state._replace(
            g=np.asarray(g), J_beta=np.asarray(J), epsl_estR=eps,
            vepstmp=np.asarray(0.4 + 0.05 * k), veps=np.asarray(0.4 + 0.05 * k),
            yadj=base - u, u=u))
    return stack_states(out)


@pytest.mark.parametrize("layout", ["sparse", "dense"])
@pytest.mark.parametrize("model", MODELS)
def test_one_iteration_batch_with_epsilon_f64_matches_jax(model, layout):
    """One iteration of K=3 chains with the J and epsilon terms (A-inverse
    sparse, or dense as on the direct path), each chain from its own
    mid-run state, with each chain's JAX random numbers: every ChainState
    field of the port's batch matches JAX's ``one_iteration_batch``
    (gibbs.py:2382; the epsilon sweep its XLA scan, use_pallas=False, as
    the JAX package's tests run it on the CPU) to rtol 1e-9."""
    spec, data, state, _ = _ss_setup(model, layout)
    states = _chain_states(spec, data, state, K)
    chain_keys = jax.random.split(jax.random.PRNGKey(8), K)
    ref = G.one_iteration_batch(spec, data, chain_keys, states)
    it = int(states.it[0])
    out = TG.one_iteration_batch(port_spec(spec), gibbs_data_from_numpy(data), 0,
                                 chain_state_from_numpy(states),
                                 noise=[JaxNoise(chain_keys[k], it) for k in range(K)])
    assert out.it == it + 1
    assert not np.array_equal(np.asarray(ref.epsl_estR[0]), np.asarray(ref.epsl_estR[1]))
    assert (np.asarray(ref.J_beta) != np.asarray(states.J_beta)).all()   # the term was drawn
    assert_state_fields(ref, out, TG.ChainState._fields[1:])


@pytest.mark.parametrize("T", [16, 64])
def test_mme_sweep_batch_is_each_chain_alone(T):
    """The K-chain plain epsilon sweep (the kernel's contract): chain k's
    x_new and residual bit for bit the one-chain call on chain k's z, x,
    residual, scale and ve, in f64 (qe not a multiple of T: padded sites)."""
    nn, _ = _partition(40, 300, n_g=60, seed=2)
    sp_t, qp = TG._build_epsl_sparse(nn, T, torch.float64)
    rng = np.random.default_rng(T)
    q = nn.shape[0]
    counts = torch.zeros(qp, dtype=torch.float64)
    counts[:q] = torch.from_numpy(rng.integers(0, 3, q).astype(np.float64))
    z, x, res = (torch.zeros((K, qp), dtype=torch.float64) for _ in range(3))
    z[:, :q] = torch.from_numpy(rng.normal(size=(K, q)))
    x[:, :q] = torch.from_numpy(rng.normal(0, 0.3, (K, q)))
    res[:, :q] = torch.from_numpy(rng.normal(size=(K, q)))
    scale = torch.tensor([0.7, 1.1, 0.4], dtype=torch.float64)
    ve = torch.tensor([1.3, 0.9, 2.0], dtype=torch.float64)
    xb, rb = TB.mme_sweep(sp_t, counts, scale, ve, z, x, res)
    assert xb.shape == rb.shape == (K, qp) and not torch.equal(xb[0], xb[1])
    for k in range(K):
        xk, rk = TB.mme_sweep(sp_t, counts, scale[k], ve[k], z[k], x[k], res[k])
        assert torch.equal(xb[k], xk) and torch.equal(rb[k], rk)
        assert (xk[q:] == 0).all()


def test_ssbrm_nchains_agrees_with_jax():
    """ssbrm(nchains=3) on the CPU against the JAX package's batch
    (hibayes_tpu/model/ssbrm.py:298-310) on the same data, 300 iterations
    each (100 burn-in): the records of all chains are pooled (3 x 40), R-hat
    covers every scalar, and since the packages draw different streams the
    pooled posterior-mean GEBV of all 600 pedigree ids and the epsilon of
    every non-genotyped id differ by Monte Carlo error only: over data seeds
    7-9 corr 0.991-0.995 (bar 0.97) and 0.941-0.981 (bar 0.9; epsilon has
    one record at most per id, so its mean is noisier)."""
    prob = _ss_problem()
    kw = dict(method="BayesCpi", niter=300, nburn=100, verbose=False, impute="pcg",
              chunk_cols=32, nchains=3)
    keys = ("data", "M", "M_id", "pedigree")
    ref = jax_ssbrm("y~1", **{k: prob[k] for k in keys}, **kw)
    out = htt.ssbrm("y~1", **{k: prob[k] for k in keys}, device="cpu", **kw)
    assert out.MCMCsamples["alpha"].shape == ref.MCMCsamples["alpha"].shape == (120, 100)
    assert out.MCMCsamples["epsilon"].shape == (120, 400)
    assert set(ref.rhat) == set(out.rhat)
    assert all(np.isfinite(out.rhat[k]) for k in ("Vg", "Ve", "Veps", "J"))
    assert list(out.g["id"]) == list(ref.g["id"])
    corr = np.corrcoef(ref.g["gebv"], out.g["gebv"])[0, 1]
    eps_corr = np.corrcoef(ref.epsilon["epsilon"], out.epsilon["epsilon"])[0, 1]
    assert corr >= 0.97 and eps_corr >= 0.9, (corr, eps_corr)
    assert abs(ref.h2 - out.h2) < 0.1 and out.Veps > 0 and np.isfinite(out.J)
