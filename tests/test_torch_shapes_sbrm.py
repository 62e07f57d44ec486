"""Blocks, fold counts and tiles that the port's summary sweeps do not take
as they are, against the JAX package in f64 on the CPU: the dense segment
sweep at blocks of 30, 192, 250 and 256, the guarded segment sweep with 12
BayesR folds, and tiled LD in tiles of 10 and 256 (re-tiled), at one chain
and at K=3; and a tiled batch run in groups of chains equal to one call.
The individual-level shapes are in tests/test_torch_shapes.py, whose
docstring says how each shape runs."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hibayes_tpu.engine import sgibbs as SG
from hibayes_tpu_torch.engine import sgibbs as TSG
from hibayes_tpu_torch.engine.convert import s_chain_state_from_numpy, sgibbs_data_from_numpy
from hibayes_tpu_torch.ops import blockgibbs as TB

from .test_torch_sgibbs_guard import LOW_VARY, JaxRedrawNoise
from .torch_parity import assert_state_fields, port_spec, s_setup

torch.set_num_threads(2)

K = 3


# ---------------------------------------------------------------------------
# summary level: dense segments and tiled LD
# ---------------------------------------------------------------------------


@functools.cache
def _s_setup(model, layout, m, block=64, nf=4, vary=None):
    s = s_setup(model, layout, m=m, block=block, nf=nf)
    if vary is not None:
        s = {**s, "spec": s["spec"].__class__(**{**s["spec"].__dict__, "vary": vary})}
    return s


def _s_iteration(s, nchains, key=5):
    """JAX's iteration 2 from its own iteration 1 and the port's from the
    same state(s), each chain with JAX's numbers and JAX's first 8 redraws
    as its guard candidates.  Returns (ref, out, tally)."""
    spec, data = s["spec"], s["data"]
    if nchains == 1:
        k = jax.random.PRNGKey(key)
        step = jax.jit(lambda st: SG.one_s_iteration(spec, data, k, st))
        state = step(SG.init_s_state(spec, data, s["pr"], s["pi"]))
        tally = torch.zeros(2, dtype=torch.int64)
        out = TSG.one_s_iteration(port_spec(spec), sgibbs_data_from_numpy(data), 0,
                                  s_chain_state_from_numpy(state),
                                  noise=JaxRedrawNoise(k, int(state.it)), tally=tally)
        return step(state), out, tally[None]
    keys = jax.random.split(jax.random.PRNGKey(key), nchains)
    step = jax.jit(lambda st: SG.one_s_iteration_batch(spec, data, keys, st))
    state0 = SG.init_s_state(spec, data, s["pr"], s["pi"])
    states = step(jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (nchains,) + x.shape), state0))
    it = int(states.it[0])
    tally = torch.zeros((nchains, 2), dtype=torch.int64)
    out = TSG.one_s_iteration_batch(port_spec(spec), sgibbs_data_from_numpy(data), 0,
                                    s_chain_state_from_numpy(states),
                                    noise=[JaxRedrawNoise(keys[c], it) for c in range(nchains)],
                                    tally=tally)
    return step(states), out, tally


@pytest.mark.parametrize("nchains", [1, K])
@pytest.mark.parametrize("B", [30, 192, 250, 256])
def test_dense_sbrm_iteration_at_any_block_matches_jax(B, nchains):
    """One sbrm iteration on a dense LD (m=300, one segment in blocks of B,
    BayesCpi) at one chain and at K=3: every SChainState field equals
    JAX's segment sweep to rtol 1e-9, the port sweeping the segment in its
    sub-blocks (the segment itself at 192 and 256, a copy with pad rows at
    30 and 250)."""
    s = _s_setup("BayesCpi", "dense", 300, block=B)
    assert s["spec"].block == B
    ref, out, _ = _s_iteration(s, nchains)
    assert_state_fields(ref, out, TSG.SChainState._fields[1:])


def test_guarded_segment_twelve_folds_matches_jax():
    """BayesR with 12 folds on a BlockDiagLD (the guarded segment sweep,
    summary rows 47 + 89 a SNP) in blocks of 250: one iteration equals
    JAX's scan to rtol 1e-9, no draw exhausting its candidates."""
    s = _s_setup("BayesR", "blockdiag", 600, block=250, nf=12)
    ref, out, tally = _s_iteration(s, 1)
    assert int(tally[:, 1].sum()) == 0
    assert_state_fields(ref, out, TSG.SChainState._fields[1:])


TILED = [("tiled10", 200), ("tiled256", 200), ("tiled256", 520)]


@pytest.mark.parametrize("nchains", [1, K])
@pytest.mark.parametrize("layout,m", TILED)
@pytest.mark.parametrize("model", ["BayesCpi", "BayesR"])
def test_tiled_iteration_at_any_tile_matches_jax(model, layout, m, nchains):
    """One sbrm iteration on a TiledSparseLD in tiles of 10 (re-tiled to
    12, two pad slots a tile) or 256 (re-tiled to 128): with JAX's first 8
    redraws as the candidates every SChainState field equals JAX's (its
    guarded XLA scan, vmapped for a batch) to rtol 1e-9, and no draw
    exhausted its candidates.  At m=200 a lowered vary makes the guard
    fire; at m=520 (3 tile rows of 256, 6 of 128) the chain's own vary,
    where lowered bounds make some draws exhaust all 8 candidates (the
    rules' one difference, counted in the tally and not compared)."""
    s = _s_setup(model, layout, m, vary=LOW_VARY if m == 200 else None)
    ref, out, tally = _s_iteration(s, nchains)
    if m == 200:
        assert int(tally[:, 0].sum()) > 0, "the guard should fire at the lowered vary"
    assert int(tally[:, 1].sum()) == 0, "JAX would have redrawn past the 8th candidate"
    assert_state_fields(ref, out, TSG.SChainState._fields[1:])


def test_retiled_store_is_the_same_ld():
    """The re-tiled store of a tile-256 and of a tile-10 LD is the same
    matrix: its tiled product equals the original's, every row keeps its
    diagonal tile first, and invalid slots point at their own row."""
    from hibayes_tpu_torch.data.sparse_ld import _tiled_matvec

    for layout, m in TILED:
        data = sgibbs_data_from_numpy(_s_setup("BayesCpi", layout, m)["data"])
        tiles, cols, valid = data.ld_tiles, data.ld_cols, data.ld_valid
        sb = TB.tiled_sub_blocks(port_spec(_s_setup("BayesCpi", layout, m)["spec"]),
                                 tiles.shape[2])
        tk, ck, vk = TB.sub_block_tiles(tiles, cols, valid, sb)
        assert tk.shape[2] == sb.W and tk.shape[0] == tiles.shape[0] * sb.S
        v = torch.from_numpy(np.random.default_rng(1).normal(size=tiles.shape[0] * tiles.shape[2]))
        ref = _tiled_matvec(tiles, cols, valid, v)
        out = sb.gather(_tiled_matvec(tk, ck, vk, sb.spread(v)))
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-12, atol=1e-12)
        rows = torch.arange(tk.shape[0])
        assert torch.equal(ck[:, 0].long(), rows) and bool(vk[:, 0].all())
        assert bool((ck.long()[~vk.bool()] == rows[:, None].expand_as(ck)[~vk.bool()]).all())


@pytest.mark.parametrize("layout,m", TILED)
def test_tiled_batch_in_groups_is_one_launch(layout, m):
    """A tiled batch run in groups of chains (as the card runs a batch it
    cannot hold at once: a call per group of :func:`_chain_groups`, the
    outputs joined in order) equals the one call, bit for bit: K=5 chains
    in groups of 2, f64, the guard firing."""
    s = _s_setup("BayesCpi", layout, m, vary=2e-4)
    spec = port_spec(s["spec"])
    data = sgibbs_data_from_numpy(s["data"])
    rng = np.random.default_rng(3)
    C = 5
    mp = data.ld_tiles.shape[0] * data.ld_tiles.shape[2]
    r = data.xy[None].repeat(C, 1) + torch.from_numpy(rng.normal(0, 50, (C, mp)))
    P = torch.cat([TB.pack_rows(
        spec, {"varg": torch.full((C,), 1e-4, dtype=torch.float64),
               "s2varg_df": torch.full((C,), 1e-4, dtype=torch.float64),
               "logpi": torch.log(torch.tensor([[0.95, 0.05]] * C, dtype=torch.float64))},
        data.xpx, data.vx, torch.full((C, mp), 1.0, dtype=torch.float64),
        torch.zeros((C, mp), dtype=torch.float64),
        torch.from_numpy(rng.normal(size=(C, mp))), torch.from_numpy(rng.random((C, mp))),
        None, None, torch.float64),
        TB.pack_retry_rows(spec, {"varg": torch.full((C,), 1e-4, dtype=torch.float64)},
                           data.xpx, data.vx, torch.full((C, mp), 1.0, dtype=torch.float64),
                           torch.from_numpy(rng.normal(size=(C, TB.N_RETRY, mp))),
                           torch.float64)], dim=1)
    lay = (data.ld_tiles, data.ld_cols, data.ld_valid)
    one_tally = torch.zeros((C, 2), dtype=torch.int64)
    one = TB.sweep_s_tiled(spec, *lay, r, P, spec.n, tally=one_tally)
    grp_tally = torch.zeros((C, 2), dtype=torch.int64)
    groups = TB._chain_groups(C, 2)
    assert [(g.start, g.stop) for g in groups] == [(0, 2), (2, 4), (4, 5)]
    parts = [TB.sweep_s_tiled(spec, *lay, r[g], P[g], spec.n, tally=grp_tally[g])
             for g in groups]
    grp = [torch.cat(t, dim=0) for t in zip(*parts)]
    assert int(one_tally[:, 0].sum()) > 0
    for a, b in zip(one, grp):
        assert torch.equal(a, b)
    assert torch.equal(one_tally, grp_tally)


@pytest.mark.parametrize("C,G,sizes", [(1, 4, [1]), (7, 3, [3, 2, 2]), (160, 131, [80, 80]),
                                       (10, 4, [4, 3, 3]), (5, 5, [5]), (3, 0, [1, 1, 1]),
                                       (161, 80, [54, 54, 53])])
def test_chain_groups_are_the_fewest_and_even(C, G, sizes):
    """The groups a batch too large for one launch runs in: every chain
    once, in order, in the fewest groups of at most G, their sizes at most
    one apart."""
    groups = TB._chain_groups(C, G)
    assert [g.stop - g.start for g in groups] == sizes
    assert groups[0].start == 0 and groups[-1].stop == C
    assert all(a.stop == b.start for a, b in zip(groups, groups[1:]))
