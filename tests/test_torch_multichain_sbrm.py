"""Chain batches of the port's summary-level engine
(hibayes_tpu_torch/engine/sgibbs.py) against the JAX reference: one batched
iteration in f64 on dense LD for all six models driven by each chain's JAX
random numbers, the K-chain segment sweep against its Pallas contract, and
the entry point."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hibayes_tpu_torch as ht
from hibayes_tpu.engine import sgibbs as SG
from hibayes_tpu.ops import blockgibbs as JB
from hibayes_tpu_torch.engine import sgibbs as TSG
from hibayes_tpu_torch.engine.convert import s_chain_state_from_numpy, sgibbs_data_from_numpy
from hibayes_tpu_torch.ops import blockgibbs as TB

from .test_torch_sgibbs import _sweep_inputs
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
    """Chain batches on a tiled LD raise, naming item 6 (segment layouts
    with the guard now run batches)."""
    ss, _, Rp, _ = s_sumstats(256, pruned=True)
    with pytest.raises(NotImplementedError, match="item 6"):
        ht.sbrm(ss, ht.TiledSparseLD.from_scipy(sp.csr_matrix(Rp), tile=128),
                niter=20, nburn=10, nchains=2, verbose=False, device="cpu")
