"""The host side of the redesigned one-chain sweep and draw chain, on the CPU.

* The draw chain's layout helpers (ops/blockgibbs.py: padded_stride,
  snp_owner; csrc/draws.cuh): every model's staged row stride is padded to
  a multiple of 4 floats, and lane l of the warp owns SNPs 4l .. 4l + 3.
* The persistent one-chain sweep's launch plan (sweep1_plan, sweep1_tiles,
  sweep1_smem; csrc/blockgibbs.cu sweep1_kernel): the parent's row tiles,
  each owned by one CTA, a grid that fits the card, the shared memory each
  CTA takes.
* A float64 emulation of the kernel's event order: the drawer's steps and
  the row tiles' steps in any order the flags allow, partials summed in
  the kernel's (and its predecessor's) order.  With an integer-valued
  stand-in for the draws every sum is exact, so the emulation must give
  sweep_mc_plain's outputs bit for bit at every order, and a wrong order
  (a tile that does not wait for the block's dg) must not; with the real
  draws it agrees with sweep_mc_plain to float64 rounding and with TPU
  kernel 1 (``sweep``, interpret mode) at the kernel bar.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hibayes_tpu.ops import blockgibbs as JB
from hibayes_tpu_torch.ops import blockgibbs as TB

from .torch_parity import (assert_kernel_bar, model_setup, port_spec, sweep_inputs,
                           with_sparse_effects)

torch.set_num_threads(2)


def test_padded_stride_of_every_model():
    """The staged rows of every model, with and without the guard, start
    16-byte aligned and waste fewer than 4 floats a SNP."""
    for mi, nf in [(1, 2), (2, 2), (3, 2), (4, 2), (5, 2)] + [(6, f) for f in range(2, 9)]:
        R = 5 if mi in (3, 4) else (3 + 4 * (nf - 1) if mi == 6 else 4)
        guard = 1 + TB.N_RETRY * (1 if mi == 4 else nf - 1) if mi in (4, 6) else 0
        for r in {R, R + guard}:
            rp = TB.padded_stride(r)
            assert rp % 4 == 0 and r <= rp < r + 4
            # a draw reads its packed rows and the guard's vx in whole float4s
            assert -(-(R + (1 if guard else 0)) // 4) * 4 <= TB.padded_stride(R + guard)


def test_each_lane_owns_four_consecutive_snps():
    """SNP j's slot is (j // 4, j % 4): 32 lanes x 4 slots cover a block of
    128 once, and a lane's SNPs are one 16-byte slice of a Gram row."""
    owners = [TB.snp_owner(j) for j in range(TB.MAX_BLOCK)]
    assert sorted(owners) == [(lane, s) for lane in range(32) for s in range(4)]
    for lane in range(32):
        js = [j for j, (l, _) in enumerate(owners) if l == lane]
        assert js == list(range(4 * lane, 4 * lane + 4))


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("n", [300, 4096, 9001, 10_000, 50_176, 131_072])
def test_sweep1_plan_covers_each_tile_once(n, sms):
    """The plan keeps the parent's row tiles (rows_per_tile at K = 1), gives
    each tile to exactly one CTA, fits the grid on the card at one CTA an
    SM, and each CTA's shared memory under the card's limit, for int8 and
    float32 X and blocks of 64 and 128."""
    for B, xbytes, R in ((128, 1, 15), (128, 4, 5), (64, 4, 5), (64, 1, 15)):
        plan = TB.sweep1_plan(n, B, R, xbytes, sms)
        assert plan["rpt"] == TB.rows_per_tile(n, sms, 1)
        assert plan["ntiles"] == -(-n // plan["rpt"])
        G = plan["grid"]
        assert 2 <= G <= sms
        owned = [t for c in range(G) for t in TB.sweep1_tiles(c, G, plan["ntiles"])]
        assert sorted(owned) == list(range(plan["ntiles"]))
        assert plan["smem"] <= TB.SMEM_OPTIN
        for c, nb in ((0, plan["nb0"]), (1, plan["nbr"])):
            T = len(TB.sweep1_tiles(c, G, plan["ntiles"]))
            assert TB.sweep1_smem(B, R, plan["rpt"], xbytes, T, nb, c == 0,
                                  plan["wb"]) <= plan["smem"]
        # one buffer of W only where it lets the drawer's tile hold more X
        if plan["wb"] == 1:
            T0 = len(TB.sweep1_tiles(0, G, plan["ntiles"]))
            assert TB.sweep1_smem(B, R, plan["rpt"], xbytes, T0, plan["nb0"], True,
                                  2) > TB.SMEM_OPTIN


def test_sweep1_plan_at_the_main_paths():
    """The flagship (n=50,176, int8, BayesR, B=128) keeps both X tiles of
    every CTA in shared memory, the drawer (which owns the 132nd tile) with
    one buffer of W; at n=131,072 one tile a CTA fits (the partials read
    X_{b+1} from L2), and none beside the drawer's buffers; at n=4,096 the
    drawer owns no tile and keeps two; ssbrm's f32 B=64 tiles fit twice."""
    flag = TB.sweep1_plan(50_176, 128, 15, 1, 132)
    assert (flag["rpt"], flag["ntiles"], flag["grid"], flag["nb0"], flag["nbr"],
            flag["wb"]) == (381, 132, 132, 2, 2, 1)
    big = TB.sweep1_plan(131_072, 128, 15, 1, 132)
    assert (big["ntiles"], big["nb0"], big["nbr"], big["wb"]) == (132, 0, 1, 2)
    small = TB.sweep1_plan(4096, 128, 15, 1, 132)
    assert (small["grid"], small["nbr"], small["wb"]) == (33, 2, 2)
    ss = TB.sweep1_plan(10_000, 64, 5, 4, 132)
    assert (ss["grid"], ss["nbr"], ss["wb"]) == (80, 2, 2)


# ---------------------------------------------------------------------------
# the event order, emulated in float64
# ---------------------------------------------------------------------------


def _int_draws(spec, P_b, W_b, r0, vary=None):
    """An integer-valued stand-in for _draws_plain with its contract: each
    draw's dg is a small integer function of its rhs, corrected through the
    (integer) Gram block as the draws are, so every sum stays exact."""
    r = r0.clone()
    dgs = []
    for j in range(r0.shape[0]):
        d = torch.remainder(torch.floor(r[j]), 7.0) - 3.0
        r += W_b[j][:, None] * d
        dgs.append(d)
    dg = torch.stack(dgs)
    return P_b[:, 1] - dg, dg, torch.zeros_like(r0)


def _emulate_sweep1(spec, args, plan, rng, block_range=None, wait_dg=True):
    """sweep_mc at K = 1 as sweep1_kernel orders it, serialised: at each
    step one of the events the flags allow runs, chosen at random.  Events:
    the drawer's step s (block s's partials of every tile published: sum
    them, warp w the tiles w, w + 8, ... in order and the eight sums in
    order; draw; publish dg_s) and each CTA's step s over its tiles in
    order (dg_{s-1} published: yadj += X_{s-1} dg, u -= X_{s-1} dg on the
    tile's rows; then the tile's partial, its 32 row classes summed in
    class order; publish).  ``wait_dg=False`` lets a CTA's step run before
    dg_{s-1} is published, reading the dg buffer as it stands."""
    consts, X_blocks, W_blocks, xpx, vx, vei, g, z, u_b, chi, z2, vargL, yadj_b, u_vec = args
    nb_tot, n, B = X_blocks.shape
    off, nbg = block_range if block_range is not None else (0, nb_tot)
    dt = yadj_b.dtype
    P = TB.pack_rows(spec, consts, xpx, vx, vei, g, z, u_b, chi, vargL, dt)
    P_blocks = TB.to_block_layout(P, nbg, B)
    yadj, u = yadj_b[0].clone(), u_vec[0].to(dt).clone()
    rpt, ntiles, G = plan["rpt"], plan["ntiles"], plan["grid"]
    partial = torch.zeros((ntiles, B), dtype=dt)
    dg_buf = torch.zeros((nbg * B,), dtype=dt)
    g_new = torch.empty((nbg * B,), dtype=dt)
    track = torch.empty((nbg * B,), dtype=dt)
    tile_flag = np.zeros(ntiles, int)   # steps whose partial is published, per tile
    dg_flag = 0                        # blocks whose dg is published
    cta_step = {c: 0 for c in range(G) if len(TB.sweep1_tiles(c, G, ntiles))}
    drawer_step = 0

    def rows_step(c, s):
        for t in TB.sweep1_tiles(c, G, ntiles):
            rows = slice(t * rpt, min(n, (t + 1) * rpt))
            if s > 0:
                Xp = X_blocks[off + s - 1][rows].to(dt)
                delta = Xp @ dg_buf[(s - 1) * B:s * B]
                yadj[rows] += delta
                u[rows] -= delta
            if s < nbg:
                Xc = X_blocks[off + s][rows].to(dt)
                y = yadj[rows]
                cls = [(Xc[k::32] * y[k::32, None]).sum(0) for k in range(32)]
                acc = torch.zeros(B, dtype=dt)
                for v in cls:
                    acc = acc + v
                partial[t] = acc
                tile_flag[t] = s + 1

    while drawer_step < nbg or any(s <= nbg for s in cta_step.values()):
        ready = []
        if drawer_step < nbg and (tile_flag >= drawer_step + 1).all():
            ready.append(("draw", None))
        for c, s in cta_step.items():
            if s <= nbg and (s == 0 or dg_flag >= s or not wait_dg):
                ready.append(("rows", c))
        assert ready, "the flags deadlock"
        kind, c = ready[rng.integers(len(ready))]
        if kind == "rows":
            rows_step(c, cta_step[c])
            cta_step[c] += 1
            continue
        s = drawer_step
        sums = [sum((partial[t] for t in range(w, ntiles, 8)), torch.zeros(B, dtype=dt))
                for w in range(8)]
        r0 = torch.zeros(B, dtype=dt)
        for v in sums:
            r0 = r0 + v
        gi, dg, tr = TB._draws_plain(spec, P_blocks[s], W_blocks[off + s].to(dt), r0[:, None])
        sl = slice(s * B, (s + 1) * B)
        g_new[sl], dg_buf[sl], track[sl] = gi[:, 0], dg[:, 0], tr[:, 0]
        dg_flag = s + 1
        drawer_step += 1
    return TB.phase_c_mc(spec, consts, vx, vei, g_new[None], track[None].to(torch.int32),
                         u_b, z2, vargL, yadj[None], u[None])


@functools.cache
def _setup(model, n):
    return with_sparse_effects(model_setup(model, n=n, m=96, B=16, warm=0,
                                           dtype=jnp.float64))


def _integer_inputs(model, n, block_range=None):
    """The port's K = 1 sweep inputs in float64 with yadj and u rounded to
    integers (X and its Gram are integers), sliced to ``block_range``."""
    s = _setup(model, n)
    _, targs = sweep_inputs(s, K=1)
    consts, X, W, xpx, vx, *per = targs
    per[7], per[8] = torch.round(8 * per[7]), torch.round(8 * per[8])
    if block_range is not None:
        off, nbg = block_range
        B = X.shape[2]
        cols = slice(off * B, (off + nbg) * B)
        xpx, vx = xpx[cols], vx[cols]
        per = [a[:, cols] for a in per[:7]] + per[7:]
    return port_spec(s["spec"]), (consts, X, W, xpx, vx, *per)


# (n, sms, grid): the plan's grid on sms SMs, or a smaller one (each CTA
# then owns several tiles, as the kernel allows); ragged last tiles
TILINGS = [(700, 6, None), (700, 16, None), (1000, 3, None), (1500, 4, None), (700, 6, 3)]


@pytest.mark.parametrize("block_range", [None, (1, 3)], ids=["all", "offset"])
@pytest.mark.parametrize("n,sms,grid", TILINGS)
def test_emulated_order_equals_plain_sweep(n, sms, grid, block_range, monkeypatch):
    """With integer-valued draws every event order the flags allow gives
    sweep_mc_plain's outputs bit for bit (three random orders each), on
    tilings where the drawer owns a tile or not, CTAs own one or several
    tiles, the last tile is ragged, and over an offset block range."""
    monkeypatch.setattr(TB, "_draws_plain", _int_draws)
    spec, args = _integer_inputs("BayesR", n, block_range)
    plan = TB.sweep1_plan(args[1].shape[1], spec.block, TB.n_rows(spec), 1, sms)
    if grid is not None:
        plan = {**plan, "grid": grid}
    ref = TB.sweep_mc_plain(spec, *args, block_range=block_range)
    for seed in range(3):
        out = _emulate_sweep1(spec, args, plan, np.random.default_rng(seed), block_range)
        for a, b in zip(ref, out):
            assert torch.equal(a, b)


def test_emulation_catches_a_tile_that_does_not_wait_for_dg(monkeypatch):
    """A row step that may run before its block's dg is published (reading
    the dg buffer as it stands) gives other outputs: the emulation can
    tell."""
    monkeypatch.setattr(TB, "_draws_plain", _int_draws)
    spec, args = _integer_inputs("BayesR", 700)
    plan = TB.sweep1_plan(args[1].shape[1], spec.block, TB.n_rows(spec), 1, 6)
    ref = TB.sweep_mc_plain(spec, *args)
    with pytest.raises(AssertionError):
        out = _emulate_sweep1(spec, args, plan, np.random.default_rng(0), wait_dg=False)
        for a, b in zip(ref, out):
            assert torch.equal(a, b)


@pytest.mark.parametrize("model", ["BayesCpi", "BayesR"])
def test_emulated_order_with_real_draws(model):
    """With the real draws the emulated order agrees with sweep_mc_plain to
    float64 rounding (its sums run in another order) and with TPU kernel 1
    (``sweep``, interpret mode, float64) at the kernel bar."""
    s = _setup(model, 700)
    jargs, targs = sweep_inputs(s, K=1)
    spec = port_spec(s["spec"])
    plan = TB.sweep1_plan(targs[1].shape[1], spec.block, TB.n_rows(spec), 1, 6)
    out = _emulate_sweep1(spec, targs, plan, np.random.default_rng(1))
    ref = TB.sweep_mc_plain(spec, *targs)
    assert torch.equal(out[1], ref[1])
    for i in (0, 3, 4):
        np.testing.assert_allclose(out[i].numpy(), ref[i].numpy(), rtol=1e-10, atol=1e-12)
    consts, X, W, xpx, vx, *per = jargs
    one = ({k: v[0] for k, v in consts.items()}, X, W, xpx, vx, *(a[0] for a in per))
    jax_ref = JB.sweep(s["spec"], *one, interpret=True)
    assert_kernel_bar(jax_ref, [o[0] for o in out])
