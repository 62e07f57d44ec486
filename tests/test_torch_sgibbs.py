"""The port's summary-level engine (hibayes_tpu_torch/engine/sgibbs.py) and
its two sweeps (ops/blockgibbs.py) against the JAX reference: data
preparation and initial state, the guard rows, the segment and tiled kernel
contracts (Pallas in interpret mode against the plain versions, f32), and
one full iteration in f64 for all six models on dense and tiled LD, driven
by JAX's own random numbers.

Sizes: dense LD m=200 (one segment padded to 256, B=64); tiled LD m=500
(4 tile rows of 128, masked slots in the band).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hibayes_tpu.engine import sgibbs as SG
from hibayes_tpu.ops import blockgibbs as JB
from hibayes_tpu_torch.engine import sgibbs as TSG
from hibayes_tpu_torch.engine.convert import (s_chain_state_from_numpy,
                                              sgibbs_data_from_numpy)
from hibayes_tpu_torch.ops import blockgibbs as TB

from .torch_parity import (MODELS, JaxNoise, assert_kernel_bar, port_spec,
                           s_setup, tt)

torch.set_num_threads(2)

M_OF = {"dense": 200, "tiled": 500}


@functools.cache
def _setup(model, layout, dtype=jnp.float32):
    return s_setup(model, layout, m=M_OF[layout], dtype=dtype)


def _port_data(s, dtype):
    return TSG.prepare_sgibbs_data(
        s["ss"], s["ld_t"], fold=s["fold"], windindx=s["windindx"], nw=s["nw"],
        block=s["block"], dtype=dtype, device="cpu")


@pytest.mark.parametrize("layout", ["dense", "tiled"])
def test_prepare_sgibbs_data_matches_jax(layout):
    """Every field and the returned sizes bit for bit: both packages compute
    the statistics in float64 numpy and cast once."""
    s = _setup("BayesCpi", layout)
    ref = SG.prepare_sgibbs_data(s["ss"], s["ld_j"], fold=s["fold"],
                                 windindx=s["windindx"], nw=s["nw"],
                                 block=s["block"], dtype=jnp.float32)
    out = _port_data(s, torch.float32)
    assert out[1:] == ref[1:]
    if layout == "tiled":
        assert not np.asarray(ref[0].ld_valid).all(), "the band should mask slots"
    for name in TSG.SGibbsData._fields:
        r, o = getattr(ref[0], name), getattr(out[0], name)
        if r is None or isinstance(r, tuple):
            assert (o is None) if r is None else len(o) == len(r), name
            pairs = () if r is None else zip(r, o)
        else:
            pairs = [(r, o)]
        for a, b in pairs:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)


def test_init_s_state_matches_jax():
    s = _setup("BayesL", "tiled", jnp.float64)
    ref = SG.init_s_state(s["spec"], s["data"], s["pr"], s["pi"])
    out = TSG.init_s_state(port_spec(s["spec"]), _port_data(s, torch.float64)[0],
                           s["pr"], s["pi"])
    assert out.it == int(ref.it)
    for name in TSG.SChainState._fields[1:]:
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)


def _sweep_inputs(s, seed=3):
    """A mid-run state and one iteration's numbers, made with numpy: sparse
    effects g with r_hat = xy - n LD g, the sweep's normals and uniforms,
    the packed rows from JAX's ``_pack_rows`` (f32) and the guard rows when
    the spec has the guard.  Returns the JAX consts, the packed rows P
    (R, m_pad) and r_hat, all numpy or JAX arrays."""
    spec, data, pr = s["spec"], s["data"], s["pr"]
    rng = np.random.default_rng(seed)
    m_pad, mi = spec.m_pad, spec.model_index
    real = np.asarray(data.real)
    g = np.where(real & (rng.random(m_pad) < 0.2), rng.normal(0, 0.05, m_pad), 0.0)
    if data.ld_tiles is None:
        LDg = np.asarray(data.ld_segs[0], np.float64) @ g
    else:
        LDg = s["ld_t"].to_dense() @ g[:spec.m]
        LDg = np.pad(LDg, (0, m_pad - spec.m))
    r_hat = np.asarray(data.xy, np.float64) - spec.n * LDg
    z = rng.normal(size=m_pad)
    u = rng.random((m_pad, spec.n_fold) if mi == 6 else m_pad)
    chi = rng.chisquare(spec.dfvara + 1.0, m_pad)
    f32 = lambda x: jnp.asarray(x, jnp.float32)
    with np.errstate(divide="ignore"):   # log(0) = -inf for pi = (0, 1), as in JAX
        logpi = np.log(np.asarray(s["pi"], np.float64))
    consts = {
        "varg": f32(pr.varg), "s2varg_df": f32(spec.s2varg * spec.dfvara),
        "logpi": f32(logpi), "lambda2": f32(pr.lambda2),
        "vara_fold": f32(pr.varg * np.asarray(data.fold)), "fold": f32(data.fold),
    }
    vei = np.asarray(data.varediff) * pr.vara + pr.vare
    c = dict(consts, vargL_vec=f32(np.full(m_pad, pr.varg)))
    P = JB._pack_rows(spec, c, data.xpx, data.vx, f32(vei), f32(g), f32(z), f32(u),
                      f32(chi))
    if TB.guard_on(spec):
        z_retry = f32(rng.normal(size=(JB.N_RETRY, m_pad)))
        P = jnp.concatenate([P, JB._pack_retry_rows(spec, consts, data.xpx, data.vx,
                                                    f32(vei), z_retry)])
    return consts, np.asarray(P), f32(r_hat), g


@pytest.mark.parametrize("model", ["BayesCpi", "BayesR"])
def test_pack_retry_rows_matches_jax(model):
    """The guard rows of one iteration, f32, to a few f32 ulps (the square
    root and the divisions round in another order)."""
    s = _setup(model, "tiled")
    spec, data, pr = s["spec"], s["data"], s["pr"]
    rng = np.random.default_rng(8)
    z = rng.normal(size=(JB.N_RETRY, spec.m_pad)).astype(np.float32)
    vei = (np.asarray(data.varediff) * pr.vara + pr.vare).astype(np.float32)
    consts = {"varg": jnp.float32(pr.varg),
              "vara_fold": jnp.asarray(pr.varg * np.asarray(data.fold), jnp.float32)}
    ref = np.asarray(JB._pack_retry_rows(spec, consts, data.xpx, data.vx,
                                         jnp.asarray(vei), jnp.asarray(z)))
    consts_b = {k: tt(v)[None] for k, v in consts.items()}
    out = TB.pack_retry_rows(port_spec(spec), consts_b, tt(data.xpx), tt(data.vx),
                             tt(vei)[None], tt(z)[None], torch.float32)[0].numpy()
    assert out.shape == ref.shape == (TB.n_guard_rows(spec), spec.m_pad)
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-30)


@pytest.mark.parametrize("model", MODELS)
def test_sweep_s_segment_plain_matches_pallas(model):
    """sweep_s_segment_plain vs JAX sweep_s_segment (interpret mode), f32,
    on the same packed rows: the kernel bar on (g, track, r_hat)."""
    s = _setup(model, "dense")
    spec, data = s["spec"], s["data"]
    consts, P, r, g = _sweep_inputs(s)
    R, mc, B = P.shape[0], spec.m_pad, spec.block
    P_blocks = jnp.asarray(P.reshape(R, mc // B, B).transpose(1, 0, 2))
    dg_j, tr_j, r_j = JB.sweep_s_segment(spec, consts, data.ld_segs[0], r, P_blocks,
                                         spec.n, interpret=True)
    dg_t, tr_t, r_t = TB.sweep_s_segment(port_spec(spec), tt(data.ld_segs[0]),
                                         tt(r), tt(P), spec.n)
    assert dg_t.dtype == torch.float32 and tr_t.dtype == torch.int32
    assert_kernel_bar((g - np.asarray(dg_j), tr_j, r_j),
                      (g - dg_t.numpy(), tr_t, r_t), names=["g", "track", "yadj"])


@pytest.mark.parametrize("model,guard", [("BayesCpi", False), ("BayesR", False),
                                         ("BayesRR", False), ("BayesCpi", True)])
def test_sweep_s_tiled_plain_matches_pallas(model, guard):
    """sweep_s_tiled_plain vs JAX sweep_s_tiled (interpret mode), f32, on the
    same packed rows and guard rows, with masked slots in the band.  With
    ``guard`` the bound vary is lowered so that the guard rejects draws;
    the port reports how many first candidates it rejected."""
    s = _setup(model, "tiled")
    spec, data = s["spec"], s["data"]
    if guard:
        spec = spec.__class__(**{**spec.__dict__, "vary": 2e-4})
    consts, P, r, g = _sweep_inputs({**s, "spec": spec})
    R, nbr, B = P.shape[0], spec.m_pad // spec.block, spec.block
    P_blocks = jnp.asarray(P.reshape(R, nbr, B).transpose(1, 0, 2))
    dg_j, tr_j, r_j = JB.sweep_s_tiled(spec, consts, data.ld_tiles, data.ld_cols,
                                       data.ld_valid, r, P_blocks, spec.n,
                                       interpret=True)
    dg_t, tr_t, r_t, rej = TB.sweep_s_tiled(
        port_spec(spec), tt(data.ld_tiles), tt(data.ld_cols), tt(data.ld_valid),
        tt(r), tt(P), spec.n)
    assert (int(rej) > 0) == guard, int(rej)
    assert_kernel_bar((g - np.asarray(dg_j), tr_j, r_j),
                      (g - dg_t.numpy(), tr_t, r_t), names=["g", "track", "yadj"])


def _record_rejections(monkeypatch):
    """Count the guard's rejections of every tiled sweep the engine runs."""
    seen = []
    sweep = TB.sweep_s_tiled

    def spy(*a, **k):
        out = sweep(*a, **k)
        seen.append(int(out[3]))
        return out

    monkeypatch.setattr(TB, "sweep_s_tiled", spy)
    return seen


@pytest.mark.parametrize("layout", ["dense", "tiled"])
@pytest.mark.parametrize("model", MODELS)
def test_one_s_iteration_f64_matches_jax(model, layout, monkeypatch):
    """One full summary iteration after burn-in (sweep, global updates, the
    Vg/Ve draws, PIP and window counters) from the same state with JAX's
    random numbers: every SChainState field of the port matches JAX's
    ``one_s_iteration`` (XLA scan) to rtol 1e-9.  On tiled LD the guard is
    on but must not fire: the scan's guard (up to 100 redraws) and the
    kernel's (8 pre-drawn candidates) agree only when it does not."""
    s = _setup(model, layout, jnp.float64)
    spec, data = s["spec"], s["data"]
    key = jax.random.PRNGKey(5)
    step = jax.jit(lambda st: SG.one_s_iteration(spec, data, key, st))
    state = step(SG.init_s_state(spec, data, s["pr"], s["pi"]))
    ref = step(state)
    seen = _record_rejections(monkeypatch)
    out = TSG.one_s_iteration(port_spec(spec), sgibbs_data_from_numpy(data), 0,
                              s_chain_state_from_numpy(state),
                              noise=JaxNoise(key, int(state.it)))
    assert seen == ([0] if layout == "tiled" else [])
    assert out.it == int(ref.it) == 2 and int(state.it) >= spec.nburn
    for name in TSG.SChainState._fields[1:]:
        a, b = np.asarray(getattr(ref, name)), getattr(out, name).numpy()
        if name == "track":
            np.testing.assert_array_equal(b, a)
        else:
            np.testing.assert_allclose(
                b, a, rtol=1e-9, atol=1e-9 * (np.abs(a).max() if a.size else 0),
                err_msg=name)


def test_one_s_iteration_f32_guard_fires_matches_pallas():
    """Tiled LD in f32 with a low vary, so that the guard rejects draws: the
    port's iteration against JAX's kernel route (use_pallas, interpret
    mode), which runs the same 8-candidate guard, at the kernel bar."""
    s = _setup("BayesCpi", "tiled")
    spec = s["spec"].__class__(**{**s["spec"].__dict__, "vary": 2e-4,
                                  "use_pallas": True})
    data = s["data"]
    key = jax.random.PRNGKey(7)
    state = SG.init_s_state(spec, data, s["pr"], s["pi"])
    consts, P, r, g = _sweep_inputs({**s, "spec": spec})
    state = state._replace(g=jnp.asarray(g, jnp.float32), r_hat=r, it=jnp.int32(3))
    ref = SG.one_s_iteration(spec, data, key, state)
    noise = JaxNoise(key, 3, dtype=jnp.float32)
    out = TSG.one_s_iteration(port_spec(spec), sgibbs_data_from_numpy(data), 0,
                              s_chain_state_from_numpy(state), noise=noise)
    pre = TSG._s_pre_sweep(port_spec(spec), sgibbs_data_from_numpy(data),
                           JaxNoise(key, 3, dtype=jnp.float32),
                           s_chain_state_from_numpy(state))
    rej = TB.sweep_s_tiled_plain(port_spec(spec), tt(data.ld_tiles), tt(data.ld_cols),
                                 tt(data.ld_valid), tt(r), pre["P"], spec.n)[3]
    assert int(rej) > 0
    assert_kernel_bar((ref.g, ref.track, ref.r_hat), (out.g, out.track, out.r_hat),
                      names=["g", "track", "yadj"])
    np.testing.assert_allclose(float(out.vara), float(ref.vara), rtol=1e-4)
    np.testing.assert_allclose(float(out.vare), float(ref.vare), rtol=1e-4)
