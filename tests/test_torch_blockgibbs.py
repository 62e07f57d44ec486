"""The port's sweep module (hibayes_tpu_torch/ops/blockgibbs.py) against the
JAX reference: packed rows, the draw-only kernel contract, the fused sweep
contract, f64 exactness against the XLA scan, offset group sweeps, and the
ind-sharded sweep's block loop.

Pallas kernels run in interpret mode at B=16, n=128 (a few seconds each);
the port runs its plain versions, which is what a wrapper does on the CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hibayes_tpu.engine import gibbs as G
from hibayes_tpu.ops import blockgibbs as JB
from hibayes_tpu_torch.engine import gibbs as TG
from hibayes_tpu_torch.ops import blockgibbs as TB

from .torch_parity import (MODELS, SWEEP_NAMES, assert_kernel_bar,
                           model_setup, port_spec, sweep_inputs, tt,
                           with_sparse_effects)

torch.set_num_threads(2)


@functools.cache
def _setup(model):
    return with_sparse_effects(model_setup(model, n=128, m=64, B=16, warm=0))


@pytest.mark.parametrize("model", MODELS)
def test_pack_rows_matches_jax(model):
    """Phase A rows, f32: every row within 1e-6 of its largest finite entry;
    the +-1e30 sentinels of inactive SNPs sit at the same places."""
    s = _setup(model)
    jargs, targs = sweep_inputs(s, K=1)
    consts_j, _, _, xpx, vx, vei, g, z, u, chi, z2, vargL, _, _ = jargs
    c1 = {k: v[0] for k, v in consts_j.items()}
    c1["vargL_vec"] = vargL[0]
    ref = np.asarray(JB._pack_rows(s["spec"], c1, xpx, vx, vei[0], g[0], z[0],
                                   u[0], chi[0]))
    consts_t, _, _, xpx_t, vx_t, vei_t, g_t, z_t, u_t, chi_t, _, vargL_t, _, _ = targs
    out = TB.pack_rows(port_spec(s["spec"]), consts_t, xpx_t, vx_t, vei_t, g_t,
                       z_t, u_t, chi_t, vargL_t, torch.float32)[0].numpy()
    assert out.shape == ref.shape == (TB.n_rows(s["spec"]), s["spec"].m_pad)
    for r in range(ref.shape[0]):
        big = np.abs(ref[r]) >= 1e29
        np.testing.assert_array_equal(out[r][big], ref[r][big])
        fin = ref[r][~big]
        atol = 1e-6 * (np.abs(fin).max() if fin.size else 1.0)
        np.testing.assert_allclose(out[r][~big], fin, rtol=0, atol=atol,
                                   err_msg=f"row {r}")


@pytest.mark.parametrize("model,K", [("BayesCpi", 1), ("BayesCpi", 3),
                                     ("BayesR", 1), ("BayesR", 3)])
def test_block_draws_plain_matches_pallas(model, K):
    """block_draws_plain vs _s_block_draws (interpret mode) on one block with
    r0 = X_b' yadj from the same state."""
    s = _setup(model)
    spec = s["spec"]
    jargs, targs = sweep_inputs(s, K=K)
    consts_j, Xj, Wj, xpx, vx, vei, g, z, u, chi, z2, vargL, yadj, _ = jargs
    b, B = 1, spec.block

    def pack(k):
        c = {key: v[k] for key, v in consts_j.items()}
        c["vargL_vec"] = vargL[k]
        return JB._pack_rows(spec, c, xpx, vx, vei[k], g[k], z[k], u[k], chi[k])

    P = jnp.stack([pack(k) for k in range(K)])
    P_b = JB.to_block_layout(P, spec.nblocks, B)[b]               # (B, R, K)
    r0 = (Xj[b].astype(jnp.float32).T @ yadj.T).astype(jnp.float32)  # (B, K)
    logpi = consts_j["logpi"][:, :1].T.astype(jnp.float32)
    dg_j, tr_j = JB._s_block_draws(spec, logpi, P_b, Wj[b], r0, interpret=True)
    dg_t, tr_t = TB.block_draws(port_spec(spec), tt(logpi), tt(P_b), tt(Wj[b]), tt(r0))
    g_old = np.asarray(P_b[:, 1, :])
    assert_kernel_bar((g_old - np.asarray(dg_j), np.asarray(tr_j)),
                      (g_old - dg_t.numpy(), tr_t.numpy()), names=["g", "track"])


@pytest.mark.parametrize("kernel,K", [("sweep_mc_t", 1), ("sweep_mc_ti", 2)])
@pytest.mark.parametrize("model", ["BayesCpi", "BayesR"])
def test_sweep_plain_matches_pallas(model, kernel, K):
    """sweep_mc_plain vs the transposed TPU sweeps (interpret mode), int8 X."""
    s = _setup(model)
    jargs, targs = sweep_inputs(s, K=K)
    ref = getattr(JB, kernel)(s["spec"], *jargs, interpret=True)
    out = TB.sweep_mc_plain(port_spec(s["spec"]), *targs)
    assert_kernel_bar(ref, out)


@pytest.mark.parametrize("model", MODELS)
def test_sweep_plain_f64_exact(model):
    """All six models in f64: the plain sweep reproduces the XLA scan with the
    same random numbers, no mixture draw flips, everything to rtol 1e-9."""
    s = model_setup(model, n=96, m=40, B=16, dtype=jnp.float64, warm=0)
    spec = s["spec"]
    pre = G._pre_sweep(spec, s["data"], jax.random.PRNGKey(3), s["state"])
    ref = G._sweep_xla(spec, s["data"], pre["consts"], pre["rnd"], pre["vei"],
                       s["state"].g, pre["vargL_in"], pre["yadj"], pre["u"])
    consts_t = {k: tt(pre["consts"][k])[None] for k in
                ("varg", "s2varg_df", "logpi", "lambda2", "vara_fold", "fold")}
    d = s["data"]
    out = TB.sweep_mc_plain(
        port_spec(spec), consts_t, tt(d.X_blocks), tt(d.W_blocks), tt(d.xpx),
        tt(d.vx), tt(pre["vei"])[None], tt(s["state"].g)[None],
        *(tt(r)[None] for r in pre["rnd"]), tt(pre["vargL_in"])[None],
        tt(pre["yadj"])[None], tt(pre["u"])[None])
    for name, r, o in zip(SWEEP_NAMES, ref, out):
        r, o = np.asarray(r), o[0].numpy()
        if name == "track":
            np.testing.assert_array_equal(o, r)
        else:
            np.testing.assert_allclose(o, r, rtol=1e-9,
                                       atol=1e-9 * (np.abs(r).max() + 1e-300),
                                       err_msg=name)


@pytest.mark.parametrize("model", ["BayesRR", "BayesR"])
def test_offset_sweep_indexes_global_blocks(model):
    """block_range=(off, nbg) sweeps blocks off.. of the full X and W (the
    Gram block indexed globally) and equals a sweep of the sliced arrays;
    the local Gram blocks (sweep_mc_tc's indexing) give another chain."""
    s = _setup(model)
    _, targs = sweep_inputs(s, K=2)
    consts, X, W, xpx, vx, *per = targs
    B, off, nbg = s["spec"].block, 1, 2
    cols = slice(off * B, (off + nbg) * B)
    loc = [a[:, cols] for a in per[:6]] + [per[6][:, cols]]
    spec = port_spec(s["spec"])
    full = TB.sweep_mc_plain(spec, consts, X, W, xpx[cols], vx[cols], *loc,
                             per[7], per[8], block_range=(off, nbg))
    sliced = TB.sweep_mc_plain(spec, consts, X[off:off + nbg], W[off:off + nbg],
                               xpx[cols], vx[cols], *loc, per[7], per[8])
    for name, a, b in zip(SWEEP_NAMES, full, sliced):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    wrong_w = TB.sweep_mc_plain(spec, consts, X[off:off + nbg], W[:nbg],
                                xpx[cols], vx[cols], *loc, per[7], per[8])
    assert not torch.equal(wrong_w[0], full[0])


def test_cpu_tensors_take_the_plain_version():
    s = _setup("BayesCpi")
    _, targs = sweep_inputs(s, K=1)
    before = (TB.sweep_mc_plain.calls, TB.sweep_mc.launches)
    TB.sweep_mc(port_spec(s["spec"]), *targs)
    assert (TB.sweep_mc_plain.calls, TB.sweep_mc.launches) == (before[0] + 1, before[1])


@pytest.mark.parametrize("K", [1, 2])
def test_ind_hybrid_on_one_rank_is_the_plain_sweep(K):
    """The ind-sharded sweep runs the plain sweep's block loop
    (``sweep_blocks``) and draws through ``block_draws``, on CPU tensors its
    plain version, one call a block: on a one-rank axis its mixture draws,
    residuals and variances are the plain sweep's bit for bit, and its
    effects, g - dg where the plain draws give g, within float32 rounding."""
    s = _setup("BayesR")
    _, targs = sweep_inputs(s, K=K)
    spec = port_spec(s["spec"])
    calls = TB.block_draws_plain.calls
    hyb = TG._sweep_ind_hybrid_mc(spec, *targs, mesh=None)
    assert TB.block_draws_plain.calls - calls == spec.nblocks
    plain = TB.sweep_mc_plain(spec, *targs)
    for name, a, b in zip(SWEEP_NAMES, plain, hyb):
        if name == "g":
            torch.testing.assert_close(b, a, rtol=0, atol=1e-6 * float(a.abs().max()))
        elif name in ("track", "yadj", "u"):
            assert torch.equal(a, b), name
        else:
            torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-30, msg=name)
