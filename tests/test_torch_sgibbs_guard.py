"""The SBayesS rejection guard on every layout the port's summary sweeps
take (hibayes_tpu_torch/engine/sgibbs.py, ops/blockgibbs.py): SparseLD and
BlockDiagLD through the guarded segment sweep, TiledSparseLD at tile 64
through the tiled sweep, against the JAX package's XLA scans with
``_reject_redraw`` (hibayes_tpu/engine/gibbs.py:311-331).

The port's guard takes 8 pre-drawn candidates (stream 15), the JAX scan
redraws up to 100 times from fold_in(fold_in(key, 99), gidx): fed JAX's own
first 8 redraw normals as its candidates, the port draws what JAX draws
wherever JAX accepts within 8 tries, which the tests assert (no draw
exhausts its candidates).  Sizes: m=200 (blocks of 64: segments padded, 4
tile rows), f64 on the CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hibayes_tpu as hj
import hibayes_tpu_torch as ht
from hibayes_tpu.engine import sgibbs as SG
from hibayes_tpu_torch.engine import sgibbs as TSG
from hibayes_tpu_torch.engine.convert import s_chain_state_from_numpy, sgibbs_data_from_numpy
from hibayes_tpu_torch.engine.rng import STREAM_SNP_ZR
from hibayes_tpu_torch.ops import blockgibbs as TB

from .torch_parity import MODELS, JaxNoise, port_spec, s_setup

torch.set_num_threads(2)

LAYOUTS = ["sparse", "blockdiag", "tiled64"]
M = 200


class JaxRedrawNoise(JaxNoise):
    """JaxNoise whose guard candidates (stream 15) are the JAX scan's own
    redraws: z[t, gidx] is the t-th normal of the key chain
    k = fold_in(fold_in(key, 99), gidx); k, sub = split(k); normal(sub)."""

    def normal(self, stream, shape=()):
        if stream != STREAM_SNP_ZR:
            return super().normal(stream, shape)
        nr, mp = shape
        rk = jax.random.fold_in(self.key, 99)

        def one(gidx):
            k = jax.random.fold_in(rk, gidx)
            zs = []
            for _ in range(nr):
                k, sub = jax.random.split(k)
                zs.append(jax.random.normal(sub, dtype=self.jdt))
            return jnp.stack(zs)

        return self._out(jax.vmap(one)(jnp.arange(mp)).T)


@functools.cache
def _setup(model, layout):
    return s_setup(model, layout, m=M, dtype=jnp.float64)


def _with_vary(s, vary):
    spec = s["spec"].__class__(**{**s["spec"].__dict__, "vary": vary})
    return {**s, "spec": spec}


def _iterate(s, noise_cls, key=5):
    """JAX's iteration 2 from its own iteration 1, and the port's from the
    same state with JAX's numbers; returns (ref, out, the port's tally)."""
    spec, data = s["spec"], s["data"]
    key = jax.random.PRNGKey(key)
    step = jax.jit(lambda st: SG.one_s_iteration(spec, data, key, st))
    state = step(SG.init_s_state(spec, data, s["pr"], s["pi"]))
    ref = step(state)
    tally = torch.zeros(2, dtype=torch.int64)
    out = TSG.one_s_iteration(port_spec(spec), sgibbs_data_from_numpy(data), 0,
                              s_chain_state_from_numpy(state),
                              noise=noise_cls(key, int(state.it)), tally=tally)
    assert out.it == int(ref.it) == 2 and int(state.it) >= spec.nburn
    return ref, out, tally


def _assert_state(ref, out):
    for name in TSG.SChainState._fields[1:]:
        a, b = np.asarray(getattr(ref, name)), getattr(out, name).numpy()
        if name == "track":
            np.testing.assert_array_equal(b, a)
        else:
            np.testing.assert_allclose(
                b, a, rtol=1e-9, atol=1e-9 * (np.abs(a).max() if a.size else 0),
                err_msg=name)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("model", MODELS)
def test_one_s_iteration_guard_silent_matches_jax(model, layout):
    """One iteration after burn-in with the guard on (BayesC/Cpi, BayesR)
    but not firing at the chain's own vary: every SChainState field equals
    JAX's ``one_s_iteration`` (its XLA scans) to rtol 1e-9, for all six
    models, on the segment sweep (pruned and per-chromosome LD) and the
    tiled sweep at tile 64."""
    s = _setup(model, layout)
    ref, out, tally = _iterate(s, JaxNoise)
    assert tally.tolist() == [0, 0]
    _assert_state(ref, out)


# a vary at which the guard rejects a first draw that a later candidate
# passes: on these data (m=200, N=100,000) lower bounds reject only the few
# large effects, whose posteriors lie wholly past the bound, so every
# candidate fails (counted, not compared); asserted below
LOW_VARY = 4.5e-3


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("model", ["BayesCpi", "BayesR"])
def test_one_s_iteration_guard_fires_matches_jax(model, layout):
    """The guard firing: with a lowered vary and JAX's own first 8 redraw
    normals as the candidates, the port's iteration equals JAX's to rtol
    1e-9.  That the two rules agree here needs JAX to have accepted within
    8 tries: no draw of the port exhausted its candidates."""
    s = _with_vary(_setup(model, layout), LOW_VARY)
    ref, out, tally = _iterate(s, JaxRedrawNoise)
    rejected, exhausted = tally.tolist()
    assert rejected > 0, "the guard should fire at the lowered vary"
    assert exhausted == 0, "JAX would have redrawn past the 8th candidate"
    _assert_state(ref, out)


@pytest.mark.parametrize("layout", ["sparse", "blockdiag"])
def test_guarded_chains_do_not_depend_on_the_batch(layout):
    """Chain k of a K=2 batch equals chain k of a K=3 batch bit for bit (f64,
    the guard firing): the guarded segment sweep draws each chain alone."""
    s = _with_vary(_setup("BayesCpi", layout), 2e-4)
    spec = port_spec(s["spec"])
    data = sgibbs_data_from_numpy(s["data"])
    runs = {}
    for K in (2, 3):
        states = TSG.stack_state(TSG.init_s_state(spec, data, s["pr"], s["pi"]), K)
        tally = torch.zeros((K, 2), dtype=torch.int64)
        for _ in range(3):
            states = TSG.one_s_iteration_batch(spec, data, 7, states, tally=tally)
        runs[K] = (states, tally)
    assert int(runs[3][1][:, 0].sum()) > 0
    for name in TSG.SChainState._fields[1:]:
        a, b = getattr(runs[2][0], name), getattr(runs[3][0], name)[:2]
        assert torch.equal(a, b), name
    assert torch.equal(runs[2][1], runs[3][1][:2])


def test_segment_sweep_guard_counts_match_the_tiled_sweep():
    """The same pruned LD as one dense segment and as 64-tiles, the same
    packed rows and a lowered vary: both plain sweeps take the same draws,
    count the same rejections, and agree in f64 to 1e-12."""
    s = _with_vary(_setup("BayesR", "sparse"), 2e-4)
    spec = port_spec(s["spec"])
    data = sgibbs_data_from_numpy(s["data"])
    state = TSG.init_s_state(spec, data, s["pr"], s["pi"])
    rng = np.random.default_rng(3)
    g = torch.from_numpy(np.where(rng.random(spec.m_pad) < 0.2,
                                  rng.normal(0, 0.02, spec.m_pad), 0.0))
    state = state._replace(g=g * data.real)
    pre = TSG._s_pre_sweep(spec, data, JaxRedrawNoise(jax.random.PRNGKey(2), 3), state)
    tal_s, tal_t = torch.zeros(2, dtype=torch.int64), torch.zeros(2, dtype=torch.int64)
    dg_s, tr_s, r_s = TB.sweep_s_segment(spec, data.ld_segs[0], state.r_hat, pre["P"],
                                         spec.n, tally=tal_s)
    tl = ht.TiledSparseLD.from_dense(data.ld_segs[0].numpy(), tile=64)
    tspec = spec.__class__(**{**spec.__dict__, "block": 64})
    dg_t, tr_t, r_t, rej = TB.sweep_s_tiled(
        tspec, torch.from_numpy(tl.tiles), torch.from_numpy(tl.col_idx),
        torch.from_numpy(tl.valid), state.r_hat, pre["P"], spec.n, tally=tal_t)
    assert tal_s[0] > 0 and torch.equal(tal_s, tal_t) and int(rej) == int(tal_t[0])
    assert torch.equal(tr_s, tr_t)
    np.testing.assert_allclose(dg_t.numpy(), dg_s.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(r_t.numpy(), r_s.numpy(), rtol=1e-12, atol=1e-9)
