"""Chain batches of the port's summary-level engine
(hibayes_tpu_torch/engine/sgibbs.py) against the JAX reference: one batched
iteration in f64 on dense LD and on tiled LD (tiles of 16 and 64, the
guard silent and firing) for all six models driven by each chain's JAX
random numbers, the K-chain segment sweep against its Pallas contract, the
K-chain tiled sweep's plain version against its one-chain calls, and the
entry point on dense and tiled LD."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hibayes_tpu_torch as ht
from hibayes_tpu.data.sparse_ld import TiledSparseLD as JaxTiledSparseLD
from hibayes_tpu.engine import sgibbs as SG
from hibayes_tpu.model.sbrm import sbrm as jax_sbrm
from hibayes_tpu.ops import blockgibbs as JB
from hibayes_tpu_torch.engine import sgibbs as TSG
from hibayes_tpu_torch.engine.convert import s_chain_state_from_numpy, sgibbs_data_from_numpy
from hibayes_tpu_torch.ops import blockgibbs as TB

from .test_torch_sgibbs import _sweep_inputs
from .test_torch_sgibbs_guard import LOW_VARY, JaxRedrawNoise
from .torch_parity import (MODELS, JaxNoise, assert_kernel_bar, assert_state_fields, port_spec,
                           s_setup, s_sumstats, stack_states, tt)

torch.set_num_threads(2)

K = 3


@pytest.mark.parametrize("model", MODELS)
def test_one_s_iteration_batch_f64_matches_jax(model):
    """One summary iteration of K=3 chains on dense LD after burn-in, the
    chains apart after a first batched iteration: every SChainState field
    matches JAX's ``one_s_iteration_batch`` (the vmapped scalar chains) to
    rtol 1e-9.  BayesL's local variances come from the inverse-Gaussian
    transform, which cancels for effects near zero: there JAX's batch and
    its single chain differ by up to 1e-6 relative, so each entry of them
    and of lambda2 (whose rate sums them) may also differ by that spread of
    the reference."""
    s = s_setup(model, "dense", m=200, dtype=jnp.float64)
    spec, data = s["spec"], s["data"]
    chain_keys = jax.random.split(jax.random.PRNGKey(5), K)
    step = jax.jit(lambda st: SG.one_s_iteration_batch(spec, data, chain_keys, st))
    state0 = SG.init_s_state(spec, data, s["pr"], s["pi"])
    states = step(jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (K,) + x.shape),
                                         state0))
    ref = step(states)
    it = int(states.it[0])
    out = TSG.one_s_iteration_batch(port_spec(spec), sgibbs_data_from_numpy(data), 0,
                                    s_chain_state_from_numpy(states),
                                    noise=[JaxNoise(chain_keys[k], it) for k in range(K)])
    assert out.it == it + 1 and it >= spec.nburn
    spread = None
    if model == "BayesL":
        one = jax.jit(lambda key, st: SG.one_s_iteration(spec, data, key, st))
        singles = stack_states([one(chain_keys[k], jax.tree_util.tree_map(lambda x: x[k], states))
                          for k in range(K)])
        spread = {name: np.abs(np.asarray(getattr(singles, name), np.float64)
                               - np.asarray(getattr(ref, name), np.float64))
                  for name in ("vargL", "lambda2")}
        assert spread["vargL"].max() < 1e-6 * np.abs(np.asarray(ref.vargL)).max()
    assert_state_fields(ref, out, TSG.SChainState._fields[1:], spread)


@pytest.mark.parametrize("model", ["BayesCpi", "BayesR", "BayesL"])
def test_segment_sweep_k3_matches_pallas(model):
    """The K-chain sweep_s_segment (its plain version) against JAX
    ``sweep_s_segment_t`` (interpret mode; its draws are TPU kernel 7), f32:
    each chain from its own mid-run state, at the kernel bar (m=100: two
    blocks of 64)."""
    s = s_setup(model, "dense", m=100)
    spec, data = s["spec"], s["data"]
    ins = [_sweep_inputs(s, seed=3 + k) for k in range(K)]
    consts = {c: jnp.stack([i[0][c] for i in ins]) for c in ins[0][0]}
    P = np.stack([i[1] for i in ins])                 # (K, R, m_pad)
    r = jnp.stack([i[2] for i in ins])
    B, mc = spec.block, spec.m_pad
    dg_j, tr_j, r_j = JB.sweep_s_segment_t(spec, consts, data.ld_segs[0], r,
                                           JB.to_block_layout(jnp.asarray(P), mc // B, B),
                                           spec.n, interpret=True)
    dg_t, tr_t, r_t = TB.sweep_s_segment(port_spec(spec), tt(data.ld_segs[0]), tt(r),
                                         tt(P), spec.n)
    assert dg_t.shape == tr_t.shape == r_t.shape == (K, mc)
    for k in range(K):
        g = ins[k][3]
        assert_kernel_bar((g - np.asarray(dg_j[k]), tr_j[k], r_j[k]),
                          (g - dg_t[k].numpy(), tr_t[k], r_t[k]),
                          names=["g", "track", "yadj"])


def test_sbrm_nchains_on_the_cpu():
    ss, R, _, b = s_sumstats(256)
    fit = ht.sbrm(ss, R, method="BayesCpi", niter=80, nburn=40, nchains=3,
                  verbose=False, device="cpu")
    assert np.isfinite(fit.rhat["Vg"]) and np.isfinite(fit.rhat["Ve"])
    assert fit.MCMCsamples["alpha"].shape == (3 * 8, 256)
    assert np.corrcoef(fit.alpha, b)[0, 1] > 0.9


def test_tiled_batches_still_raise():
    """A chain batch on a tiled LD runs through the K-chain tiled sweep:
    sbrm(nchains=2) at tiles of 128 gives each chain's records, the guard's
    counts per chain and finite R-hat."""
    ss, _, Rp, b = s_sumstats(256, pruned=True)
    fit = ht.sbrm(ss, ht.TiledSparseLD.from_scipy(sp.csr_matrix(Rp), tile=128),
                  niter=40, nburn=20, nchains=2, verbose=False, device="cpu")
    assert fit.MCMCsamples["alpha"].shape == (2 * 4, 256) and fit.guard.shape == (2, 2)
    assert np.isfinite(fit.rhat["Vg"]) and np.isfinite(fit.rhat["Ve"])
    assert np.isfinite(fit.alpha).all()


# ---------------------------------------------------------------------------
# chain batches on tiled LD
# ---------------------------------------------------------------------------

TILES = ["tiled16", "tiled64"]


@functools.cache
def _tiled_setup(model, layout, vary=None):
    s = s_setup(model, layout, m=200, dtype=jnp.float64)
    if vary is not None:
        s = {**s, "spec": s["spec"].__class__(**{**s["spec"].__dict__, "vary": vary})}
    return s


def _tiled_batch_iteration(s, key=5):
    """JAX's batched iteration 2 (vmapped single chains through the guarded
    XLA scan) from its own iteration 1, and the port's K-chain iteration
    from the same states with each chain's JAX numbers, its guard
    candidates JAX's own first 8 redraws.  Returns (ref, out, tally)."""
    spec, data = s["spec"], s["data"]
    chain_keys = jax.random.split(jax.random.PRNGKey(key), K)
    step = jax.jit(lambda st: SG.one_s_iteration_batch(spec, data, chain_keys, st))
    state0 = SG.init_s_state(spec, data, s["pr"], s["pi"])
    states = step(jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (K,) + x.shape),
                                         state0))
    ref = step(states)
    it = int(states.it[0])
    tally = torch.zeros((K, 2), dtype=torch.int64)
    out = TSG.one_s_iteration_batch(port_spec(spec), sgibbs_data_from_numpy(data), 0,
                                    s_chain_state_from_numpy(states),
                                    noise=[JaxRedrawNoise(chain_keys[k], it) for k in range(K)],
                                    tally=tally)
    assert out.it == it + 1 and it >= spec.nburn
    assert not np.array_equal(np.asarray(ref.g[0]), np.asarray(ref.g[1]))
    return ref, out, tally


@pytest.mark.parametrize("layout", TILES)
@pytest.mark.parametrize("model", MODELS)
def test_one_s_iteration_batch_tiled_f64_matches_jax(model, layout):
    """One summary iteration of K=3 chains on a tiled LD (tiles of 16 and
    64, the guard on for BayesC/Cpi and BayesR at the chains' own vary):
    every SChainState field matches JAX's ``one_s_iteration_batch`` to
    rtol 1e-9, and no draw exhausted its 8 candidates."""
    ref, out, tally = _tiled_batch_iteration(_tiled_setup(model, layout))
    assert int(tally[:, 1].sum()) == 0
    assert_state_fields(ref, out, TSG.SChainState._fields[1:])


@pytest.mark.parametrize("layout", TILES)
@pytest.mark.parametrize("model", ["BayesCpi", "BayesR"])
def test_one_s_iteration_batch_tiled_guard_fires_matches_jax(model, layout):
    """The guard firing in a batch on tiled LD (a lowered vary): with JAX's
    own first 8 redraws as each chain's candidates the port's batch equals
    JAX's vmapped chains to rtol 1e-9, which needs JAX to have accepted
    within 8 tries: no draw of any chain exhausted its candidates."""
    ref, out, tally = _tiled_batch_iteration(_tiled_setup(model, layout, LOW_VARY))
    assert int(tally[:, 0].sum()) > 0, "the guard should fire at the lowered vary"
    assert int(tally[:, 1].sum()) == 0, "JAX would have redrawn past the 8th candidate"
    assert_state_fields(ref, out, TSG.SChainState._fields[1:])


@pytest.mark.parametrize("layout", TILES)
@pytest.mark.parametrize("model", ["BayesCpi", "BayesR", "BayesL"])
def test_tiled_sweep_batch_is_each_chain_alone(model, layout):
    """The K-chain plain tiled sweep (the kernel's contract): chain k's dg,
    track, r_hat, rejected count and tally bit for bit the one-chain call
    on chain k's inputs, in f64, the guard firing where it is on."""
    s = _tiled_setup(model, layout, 2e-4)
    spec = port_spec(s["spec"])
    ins = [_sweep_inputs(s, seed=3 + k) for k in range(K)]
    P = torch.from_numpy(np.stack([np.asarray(i[1], np.float64) for i in ins]))
    r = torch.from_numpy(np.stack([i[2] for i in ins]))
    data = sgibbs_data_from_numpy(s["data"])
    lay = (data.ld_tiles, data.ld_cols, data.ld_valid)
    tally = torch.zeros((K, 2), dtype=torch.int64)
    batch = TB.sweep_s_tiled(spec, *lay, r, P, spec.n, tally=tally)
    assert [o.shape[0] for o in batch] == [K] * 4
    if TB.guard_on(spec):
        assert int(tally[:, 0].sum()) > 0
    for k in range(K):
        one_tally = torch.zeros(2, dtype=torch.int64)
        one = TB.sweep_s_tiled(spec, *lay, r[k], P[k], spec.n, tally=one_tally)
        for a, b in zip(batch, one):
            assert torch.equal(a[k], b)
        assert torch.equal(tally[k], one_tally)


def test_sbrm_tiled_nchains_agrees_with_jax():
    """sbrm(nchains=3) on a tile-64 LD on the CPU against the JAX package's
    batch (tests/test_tiled_ld.py:273's call), BayesCpi, 200 iterations: the
    packages draw different streams, so the pooled posterior-mean effects
    differ by Monte Carlo error only (corr 0.99994-0.99998 over data seeds
    21-23, bar 0.99); both track b_true (0.998-0.999, bar 0.95).  Each
    chain's records, R-hat of every scalar and the per-chain guard counts
    are there."""
    ss, _, Rp, b = s_sumstats(256, pruned=True)
    kw = dict(method="BayesCpi", niter=200, nburn=100, nchains=3, verbose=False)
    ref = jax_sbrm(ss, JaxTiledSparseLD.from_scipy(sp.csr_matrix(Rp), tile=64), **kw)
    out = ht.sbrm(ss, ht.TiledSparseLD.from_scipy(sp.csr_matrix(Rp), tile=64),
                  device="cpu", **kw)
    assert out.MCMCsamples["alpha"].shape == ref.MCMCsamples["alpha"].shape == (3 * 20, 256)
    assert out.guard.shape == (3, 2)
    assert set(ref.rhat) <= set(out.rhat) and np.isfinite(out.rhat["Vg"])
    corr = np.corrcoef(out.alpha, ref.alpha)[0, 1]
    acc = [np.corrcoef(f.alpha, b)[0, 1] for f in (ref, out)]
    assert corr >= 0.99 and min(acc) > 0.95, (corr, acc)
