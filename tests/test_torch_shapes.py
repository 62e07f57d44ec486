"""Blocks, fold counts and tiles that the port's kernels do not take as they
are, against the JAX package in f64 on the CPU.

The JAX package runs any block, fold count and tile (its XLA scan where no
Pallas kernel fits).  The port's kernels take blocks of at most 128 SNPs
that are a multiple of 4: a wider block, or one that is not a multiple of
4, runs as consecutive sub-blocks with inert pad slots
(ops/blockgibbs.py:SubBlocks), a tile store of another tile is re-tiled
(sub_block_tiles), and BayesR above 8 folds runs the draw chain's run-time
fold instance.  The plain versions take the same route as the card, so
these tests hold the route the card runs: one iteration from the same
state with JAX's random numbers, every state field to rtol 1e-9 (atol
1e-9 of the field's scale), at one chain and at K=3; on tiled LD the guard
candidates are JAX's own first 8 redraws, and no draw may exhaust them.
The summary sweeps' shapes are in tests/test_torch_shapes_sbrm.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hibayes_tpu.engine import gibbs as G
from hibayes_tpu_torch.engine import gibbs as TG
from hibayes_tpu_torch.engine.convert import chain_state_from_numpy, gibbs_data_from_numpy
from hibayes_tpu_torch.ops import blockgibbs as TB

from .test_torch_ssbrm import _ss_setup
from .torch_parity import (JaxNoise, assert_state_fields, model_setup, port_spec,
                           stack_states, with_sparse_effects)

torch.set_num_threads(2)

K = 3
# each block with a model: 30 and 250 are not multiples of 4 (pad slots);
# 192, 250 and 256 are above 128 (two sub-blocks of 96, 128 and 128)
BLOCKS = [(30, "BayesCpi"), (192, "BayesL"), (250, "BayesR"), (256, "BayesA")]
WIDTH = {30: (1, 32), 192: (2, 96), 250: (2, 128), 256: (2, 128), 64: (1, 64)}


def test_kernel_widths():
    """The sub-blocks each block gets on every device: the fewest of at
    most 128 SNPs, a multiple of 4; a block the kernels take stays as it
    is; with 16 folds the rows of a SNP (63, and 184 with the guard) narrow
    the summary sweeps' sub-blocks to what their shared memory holds; the
    pad slots draw nothing."""
    spec = port_spec(model_setup("BayesR", n=64, m=40, B=8, warm=0)["spec"])
    for B, (S, W) in WIDTH.items():
        sb = TB.mc_sub_blocks(TB.n_rows(spec), 50_000, B, 1)
        assert (sb.S, sb.W) == (S, W), B
        assert TB.segment_sub_blocks(spec, B) == TB.tiled_sub_blocks(spec, B) == sb
    spec = port_spec(model_setup("BayesR", n=64, m=40, B=8, warm=0, nf=16)["spec"])
    assert TB.mc_sub_blocks(TB.n_rows(spec), 50_000, 128, 1).same
    assert TB.segment_sub_blocks(spec, 128).W < 128
    guarded = spec.__class__(**{**spec.__dict__, "reject_guard": True})
    assert (TB.tiled_sub_blocks(guarded, 128).S, TB.tiled_sub_blocks(guarded, 128).W) == (2, 64)
    P = torch.zeros((1, TB.summary_rows(guarded), 4), dtype=torch.float64)
    P[:] = TB.inert_rows(guarded, P.shape[1], torch.float64, "cpu")[None, :, None]
    gi, dg, tr = TB._draws_plain(guarded, TB.to_block_layout(P, 1, 4)[0],
                                 torch.eye(4, dtype=torch.float64), torch.ones((4, 1)).double(),
                                 torch.tensor(1e-12, dtype=torch.float64),
                                 torch.zeros((1, 2), dtype=torch.int64))
    assert not gi.any() and not dg.any() and not tr.any()


# ---------------------------------------------------------------------------
# individual level: ibrm and ssbrm sweeps
# ---------------------------------------------------------------------------


@functools.cache
def _ibrm_setup(B, model, nf=4):
    m = 100 if B <= 64 else 300
    return model_setup(model, n=300, m=m, B=B, dtype=jnp.float64, nc=1, nfactor=1,
                       windows=True, warm=2, nf=nf)


def _ibrm_iteration(s, nchains, key=5):
    """JAX's iteration and the port's from the same state (K chains, each
    from its own sparse effects) with JAX's numbers."""
    spec, data = s["spec"], s["data"]
    if nchains == 1:
        state = with_sparse_effects(s)["state"]
        k = jax.random.PRNGKey(key)
        ref = G.one_iteration(spec, data, k, state)
        out = TG.one_iteration(port_spec(spec), gibbs_data_from_numpy(data), 0,
                               chain_state_from_numpy(state), noise=JaxNoise(k, int(state.it)))
        return ref, out
    states = stack_states([with_sparse_effects(s, seed=5 + c)["state"] for c in range(nchains)])
    keys = jax.random.split(jax.random.PRNGKey(key), nchains)
    it = int(states.it[0])
    ref = G.one_iteration_batch(spec, data, keys, states)
    out = TG.one_iteration_batch(port_spec(spec), gibbs_data_from_numpy(data), 0,
                                 chain_state_from_numpy(states),
                                 noise=[JaxNoise(keys[c], it) for c in range(nchains)])
    return ref, out


@pytest.mark.parametrize("nchains", [1, K])
@pytest.mark.parametrize("B,model", BLOCKS)
def test_ibrm_iteration_at_any_block_matches_jax(B, model, nchains):
    """One ibrm iteration (a covariate, a factor, windows, n=300, m=300 in
    blocks of 192, 250 or 256, or m=100 in blocks of 30) at one chain and
    at K=3: every ChainState field equals JAX's to rtol 1e-9, the port
    sweeping each block as its sub-blocks."""
    s = _ibrm_setup(B, model)
    assert s["spec"].block == B
    assert not TB.mc_sub_blocks(TB.n_rows(port_spec(s["spec"])), 300, B, 1).same
    ref, out = _ibrm_iteration(s, nchains)
    assert out.g.shape == tuple(np.asarray(ref.g).shape)
    assert_state_fields(ref, out, TG.ChainState._fields[1:])


@pytest.mark.parametrize("nchains", [1, K])
def test_bayesr_twelve_folds_matches_jax(nchains):
    """BayesR with 12 folds (above the 8 compiled into the draw chain; the
    packed rows 3 + 4 x 11 = 47 a SNP): one iteration at one chain and at
    K=3 equals JAX's to rtol 1e-9."""
    s = _ibrm_setup(64, "BayesR", nf=12)
    assert s["spec"].n_fold == 12
    ref, out = _ibrm_iteration(s, nchains)
    assert_state_fields(ref, out, TG.ChainState._fields[1:])


@pytest.mark.parametrize("B", [30, 250])
def test_ssbrm_iteration_at_any_block_matches_jax(B):
    """One single-step iteration (J and epsilon terms, sparse A-inverse)
    with SNP blocks of 30 or 250 (m=300; the epsilon blocks min(B, 128)):
    every ChainState field equals JAX's to rtol 1e-9."""
    spec, data, state, _ = _ss_setup("BayesCpi", "sparse", block=B, m=300)
    assert spec.block == B
    key = jax.random.PRNGKey(8)
    ref = G.one_iteration(spec, data, key, state)
    out = TG.one_iteration(port_spec(spec), gibbs_data_from_numpy(data), 0,
                           chain_state_from_numpy(state), noise=JaxNoise(key, int(state.it)))
    assert_state_fields(ref, out, TG.ChainState._fields[1:])
