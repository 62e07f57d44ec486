"""The port's engine (hibayes_tpu_torch/engine/gibbs.py) against the JAX
reference: data preparation, initial state, and one full iteration in f64
for all six models driven by JAX's own random numbers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hibayes_tpu.engine import gibbs as G
from hibayes_tpu_torch.engine import gibbs as TG
from hibayes_tpu_torch.engine.convert import (chain_state_from_numpy,
                                              gibbs_data_from_numpy)
from hibayes_tpu_torch.ops import blockgibbs as TB

from .torch_parity import MODELS, JaxNoise, model_setup, port_spec

torch.set_num_threads(2)

# n=4,100 > 4,096 is row-padded to 4,608 by both packages; m=64 with B=24
# leaves a ragged last block; SNP 3 is monomorphic.
SIZES = dict(n=4100, m=64, B=24, nc=1, nfactor=1, windows=True, warm=0)


def _port_data(s, dtype, int8):
    M = s["M"] if int8 else s["M"].astype(np.float32)
    return TG.prepare_gibbs_data(
        s["y"], M, C=s["C"], r_codes=s["codes"], r_nlevels=s["nlev"],
        fold=s["fold"], windindx=s["windindx"], nw=s["nw"], block=24,
        dtype=dtype, geno_dtype="int8" if int8 else None, device="cpu")


def _assert_data_equal(ref, out, int8):
    """Every field of the port's GibbsData equal to JAX's, the genotype and
    its Gram blocks laid out in the port's sub-blocks; the port's own
    segments of the sums by level are the stable sort order and the level
    counts of JAX's codes, every row held (padded ones in level 0); the
    port's own cross-Grams of consecutive sub-blocks are the float64
    products of its genotype's."""
    assert out.block == np.asarray(ref.X_blocks).shape[2]
    lay = TB.sub_block_genotype(torch.from_numpy(np.array(ref.X_blocks)),
                                torch.from_numpy(np.array(ref.W_blocks)),
                                TB.SubBlocks.of(out.block, out.X_blocks.shape[2]))
    for c, k, seg in zip(ref.r_codes, ref.r_counts, out.r_segs):
        c = np.asarray(c)
        np.testing.assert_array_equal(seg.order.numpy(), np.argsort(c, kind="stable"))
        np.testing.assert_array_equal(np.diff(seg.offsets.numpy()),
                                      np.bincount(c, minlength=np.asarray(k).shape[0]))
        assert seg.offsets[0] == 0 and seg.offsets[-1] == c.shape[0]
    Xd = out.X_blocks.to(torch.float64)
    assert float(out.C_blocks[0].abs().max()) == 0.0
    assert torch.equal(out.C_blocks[1:].to(torch.float64),
                       torch.bmm(Xd[1:].transpose(1, 2), Xd[:-1]))
    assert out.plans == {}   # the sweeps' state, made at the first sweep
    for name in TG.GibbsData._fields:
        if name in ("block", "r_segs", "epsl_segs", "C_blocks", "plans"):
            continue
        r, o = getattr(ref, name), getattr(out, name)
        if name in ("X_blocks", "W_blocks"):
            r = lay[name == "W_blocks"]
        if o is None:   # epsl_sp: no single-step term here
            assert r is None, name
            continue
        if isinstance(o, tuple):
            assert len(r) == len(o)
            pairs = zip(r, o)
        else:
            pairs = [(r, o)]
        for a, b in pairs:
            if name == "vx" and not int8:
                # a float sum of squares over 4,100 rows: XLA and torch sum
                # in other orders, so the last bit may differ
                np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
            else:
                np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)


@pytest.mark.parametrize("int8", [True, False], ids=["int8", "f32"])
def test_prepare_gibbs_data_matches_jax(int8):
    s = model_setup("BayesR", int8=int8, **SIZES)
    ref, out = s["data"], _port_data(s, torch.float32, int8)
    assert s["spec"].row_padded and s["spec"].m % s["spec"].block
    _assert_data_equal(ref, out, int8)
    assert np.asarray(ref.vx)[3] == 0 and out.vx[3] == 0


@pytest.mark.parametrize("int8", [True, False], ids=["int8", "f32"])
@pytest.mark.parametrize("B", [30, 250])
def test_prepare_gibbs_data_lays_out_sub_blocks(B, int8):
    """At blocks the kernels do not take as they are (30: not a multiple of
    4; 250: above 128) the genotype is stored once, as the sweeps' sub-blocks
    (32; 128 and 128, pad columns zero), with each sub-block's Gram; the
    per-SNP statistics equal JAX's, and so does the genotype laid out."""
    s = model_setup("BayesR", int8=int8, n=200, m=300, B=B, warm=0)
    ref = s["data"]
    out = TG.prepare_gibbs_data(s["y"], s["M"] if int8 else s["M"].astype(np.float32),
                                fold=s["fold"], block=B, geno_dtype="int8" if int8 else None,
                                device="cpu")
    sb = TB.SubBlocks.of(out.block, out.X_blocks.shape[2])
    assert (sb.S, sb.W) == {30: (1, 32), 250: (2, 128)}[B]
    assert tuple(out.X_blocks.shape) == (-(-300 // B) * sb.S, 200, sb.W)
    for name in ("xpx", "vx", "real"):
        if name == "vx" and not int8:   # a float sum of squares, as above
            np.testing.assert_allclose(out.vx.numpy(), np.asarray(ref.vx), rtol=1e-6)
        else:
            np.testing.assert_array_equal(getattr(out, name).numpy(),
                                          np.asarray(getattr(ref, name)), err_msg=name)
    X, W = TB.sub_block_genotype(torch.from_numpy(np.array(ref.X_blocks)),
                                 torch.from_numpy(np.array(ref.W_blocks)), sb)
    assert torch.equal(out.X_blocks, X) and torch.equal(out.W_blocks, W)
    g = torch.from_numpy(np.random.default_rng(1).normal(size=(out.xpx.shape[0], 2)))
    Xd = np.asarray(ref.X_blocks, np.float64).transpose(1, 0, 2).reshape(200, -1)
    np.testing.assert_allclose(TG.genotype_matmul(out.X_blocks, g, torch.float64, B).numpy(),
                               Xd @ g.numpy(), rtol=1e-12)
    w = torch.from_numpy(np.random.default_rng(2).normal(size=200))
    np.testing.assert_allclose(TG.genotype_rmatmul(out.X_blocks, w, torch.float64, B).numpy(),
                               Xd.T @ w.numpy(), rtol=1e-12, atol=1e-12)


def test_init_state_matches_jax():
    """Integer-valued and constant fields exactly; mu and yadj (a mean over
    4,100 rows, summed in another order) to f64 round-off."""
    s = model_setup("BayesL", dtype=jnp.float64, **SIZES)
    data = _port_data(s, torch.float64, True)
    ref = s["state"]
    out = TG.init_state(port_spec(s["spec"]), data, s["pr"], s["pi"])
    assert out.it == int(ref.it)
    for name in TG.ChainState._fields[1:]:
        r, o = getattr(ref, name), getattr(out, name)
        for a, b in (zip(r, o) if isinstance(o, tuple) else [(r, o)]):
            a, b = np.asarray(a), b.numpy()
            if name in ("mu", "yadj"):
                np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-12, err_msg=name)
            else:
                np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize("model", MODELS)
def test_one_iteration_f64_matches_jax(model):
    """One full iteration (intercept, a covariate, an environmental factor,
    the sweep, the global updates, PIP/WPPA counters after burn-in, row
    padding) from the same state with JAX's random numbers: every ChainState
    field of the port matches ``one_iteration(use_pallas=False)`` to rtol
    1e-9 (atol 1e-9 of the field's scale, for entries that cancel to ~0)."""
    s = model_setup(model, dtype=jnp.float64, **{**SIZES, "m": 40, "warm": 2})
    spec, data, state = s["spec"], s["data"], s["state"]
    key = jax.random.PRNGKey(5)
    ref = G.one_iteration(spec, data, key, state)
    out = TG.one_iteration(port_spec(spec), gibbs_data_from_numpy(data), 0,
                           chain_state_from_numpy(state),
                           noise=JaxNoise(key, int(state.it)))
    assert out.it == int(ref.it) == int(state.it) + 1
    for name in TG.ChainState._fields[1:]:
        r, o = getattr(ref, name), getattr(out, name)
        for a, b in (zip(r, o) if isinstance(o, tuple) else [(r, o)]):
            a, b = np.asarray(a), b.numpy()
            if name == "track":
                np.testing.assert_array_equal(b, a)
            else:
                np.testing.assert_allclose(
                    b, a, rtol=1e-9, atol=1e-9 * (np.abs(a).max() if a.size else 0),
                    err_msg=name)
