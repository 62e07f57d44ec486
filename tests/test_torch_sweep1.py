"""The host side of the redesigned one-chain sweep and draw chain, on the CPU.

* The draw chain's layout helpers (ops/blockgibbs.py: padded_stride,
  snp_owner; csrc/draws.cuh): every model's staged row stride is padded to
  a multiple of 4 floats, and lane l of the warp owns SNPs 4l .. 4l + 3.
* The persistent one-chain sweep's launch plan (sweep1_plan, sweep1_tiles,
  sweep1_smem; csrc/blockgibbs.cu sweep1_kernel): row tiles about one per
  SM but the drawer's, each owned by one CTA, a grid that fits the card,
  the shared memory each CTA takes.
* The cross-Grams C_k = X_k' X_{k-1} of consecutive kernel blocks that the
  one-chain sweep's lookahead reads (GibbsData.C_blocks, cross_grams):
  exact, for int8 and float32 genotypes, sub-blocks, padded rows and across
  the Gram's cast batches.
* A float64 emulation of the kernel's event order, the right-hand side one
  block ahead: the drawer's steps and the row tiles' steps in any order the
  flags allow, a tile's partials of block b+1 formed once dg_{b-1} is out
  and corrected by C_{b+1} dg_b, summed in the kernel's order.  With an
  integer-valued stand-in for the draws every sum is exact, so the
  emulation must give sweep_mc_plain's outputs bit for bit at every order,
  and a wrong one (a tile that does not wait for dg, rows that take dg a
  block early, the correction left out) must not; with the real draws it
  agrees with sweep_mc_plain to float64 rounding and with TPU kernel 1
  (``sweep``, interpret mode) at the kernel bar.
* The benchmark's reader of the lookahead's counters (sweep1_lookahead_pct).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hibayes_tpu.ops import blockgibbs as JB
from hibayes_tpu_torch.engine import gibbs as TG
from hibayes_tpu_torch.ops import blockgibbs as TB
from hibayes_tpu_torch.utils import profiling

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
    """The plan takes rows_per_tile's tiles at K = 1 (about one per SM but
    the drawer's, so the drawer owns none), gives each tile to exactly one
    CTA, fits the grid on the card at one CTA an SM, and each CTA's shared
    memory under the card's limit, for int8 and float32 X and blocks of 64
    and 128."""
    for B, xbytes, R in ((128, 1, 15), (128, 4, 5), (64, 4, 5), (64, 1, 15)):
        plan = TB.sweep1_plan(n, B, R, xbytes, sms)
        assert plan["rpt"] == TB.rows_per_tile(n, sms, 1)
        assert plan["ntiles"] == -(-n // plan["rpt"])
        G = plan["grid"]
        assert 2 <= G <= sms
        owned = [t for c in range(G) for t in TB.sweep1_tiles(c, G, plan["ntiles"])]
        assert sorted(owned) == list(range(plan["ntiles"]))
        assert not TB.sweep1_tiles(0, G, plan["ntiles"])
        assert plan["smem"] <= TB.SMEM_OPTIN
        assert plan["nbr"] in (0, 1, 3) and (plan["wb"], plan["cb"]) == (2, 1)
        for c, nb in ((0, plan["nb0"]), (1, plan["nbr"])):
            T = len(TB.sweep1_tiles(c, G, plan["ntiles"]))
            assert TB.sweep1_smem(B, R, plan["rpt"], xbytes, T, nb, c == 0,
                                  plan["wb"], cb=plan["cb"]) <= plan["smem"]


def test_sweep1_plan_at_the_main_paths():
    """The flagship (n=50,176, int8, BayesR, B=128): 131 tiles of 384 rows,
    the drawer owns none and keeps two buffers of W and one of C, every
    other CTA three X tiles (X_{b-1}, X_b, X_{b+1}); at n=131,072 and at a
    200,192-row shard one tile a CTA fits (the partials read X_{b+1} from
    L2); at n=4,096 three; ssbrm's f32 B=64 tiles fit three times; and
    where the drawer owns tiles (a grid of one) it keeps them before C."""
    flag = TB.sweep1_plan(50_176, 128, 15, 1, 132)
    assert (flag["rpt"], flag["ntiles"], flag["grid"], flag["nb0"], flag["nbr"],
            flag["wb"], flag["cb"]) == (384, 131, 132, 0, 3, 2, 1)
    big = TB.sweep1_plan(131_072, 128, 15, 1, 132)
    assert (big["ntiles"], big["nb0"], big["nbr"], big["wb"], big["cb"]) == (131, 0, 1, 2, 1)
    shard = TB.sweep1_plan(200_192, 128, 15, 1, 132)
    assert (shard["rpt"], shard["nbr"], shard["wb"], shard["cb"]) == (1529, 1, 2, 1)
    small = TB.sweep1_plan(4096, 128, 15, 1, 132)
    assert (small["grid"], small["nbr"], small["wb"]) == (33, 3, 2)
    ss = TB.sweep1_plan(10_000, 64, 5, 4, 132)
    assert (ss["grid"], ss["nbr"], ss["wb"]) == (80, 3, 2)
    one = TB.sweep1_plan(300, 128, 15, 1, 1)
    assert (one["grid"], one["ntiles"], one["nb0"], one["wb"], one["cb"]) == (1, 1, 3, 1, 0)


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


def _emulate_sweep1(spec, args, plan, rng, block_range=None, wait_dg=True, dg_lag=0,
                    correct=True):
    """sweep_mc at K = 1 as sweep1_kernel orders it, the right-hand side one
    block ahead, serialised: at each step one of the events the flags allow
    runs, chosen at random.  Events: each CTA's step s over its tiles in
    order (s > 0: once dg_{s-1} is published, yadj += X_{s-1} dg_{s-1},
    u -= X_{s-1} dg_{s-1} on the tile's rows; then the tile's partial of
    block s + 1, or of blocks 0 and 1 at s = 0, its 32 row classes summed
    in class order, into the half of the partials the block's parity
    names; publish) and the drawer's step s (block s's partials of every
    tile published: sum them, warp w = 1 .. 7 the tiles w - 1, w + 6, ...
    in order and the seven sums in order; add C_s dg_{s-1} for s > 0; draw;
    publish dg_s).  ``wait_dg=False`` lets a CTA's step run before dg_{s-1}
    is published, reading the dg buffer as it stands; ``dg_lag=1`` lets it
    run once dg_{s-2} is, a block early; ``correct=False`` leaves out the
    cross-Gram correction."""
    consts, X_blocks, W_blocks, xpx, vx, vei, g, z, u_b, chi, z2, vargL, yadj_b, u_vec = args
    nb_tot, n, B = X_blocks.shape
    off, nbg = block_range if block_range is not None else (0, nb_tot)
    dt = yadj_b.dtype
    C_blocks = TB.cross_grams(X_blocks, dt)
    P = TB.pack_rows(spec, consts, xpx, vx, vei, g, z, u_b, chi, vargL, dt)
    P_blocks = TB.to_block_layout(P, nbg, B)
    yadj, u = yadj_b[0].clone(), u_vec[0].to(dt).clone()
    rpt, ntiles, G = plan["rpt"], plan["ntiles"], plan["grid"]
    partial = torch.zeros((2, ntiles, B), dtype=dt)
    dg_buf = torch.zeros((nbg * B,), dtype=dt)
    g_new = torch.empty((nbg * B,), dtype=dt)
    track = torch.empty((nbg * B,), dtype=dt)
    tile_flag = np.zeros(ntiles, int)   # blocks whose partial is published, per tile
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
            for blk in ((0, 1) if s == 0 else (s + 1,)):
                if blk >= nbg:
                    continue
                Xc = X_blocks[off + blk][rows].to(dt)
                y = yadj[rows]
                cls = [(Xc[k::32] * y[k::32, None]).sum(0) for k in range(32)]
                acc = torch.zeros(B, dtype=dt)
                for v in cls:
                    acc = acc + v
                partial[blk % 2, t] = acc
                tile_flag[t] = blk + 1

    while drawer_step < nbg or any(s <= nbg for s in cta_step.values()):
        ready = []
        if drawer_step < nbg and (tile_flag >= drawer_step + 1).all():
            ready.append(("draw", None))
        for c, s in cta_step.items():
            if s <= nbg and (s == 0 or dg_flag >= s - dg_lag or not wait_dg):
                ready.append(("rows", c))
        assert ready, "the flags deadlock"
        kind, c = ready[rng.integers(len(ready))]
        if kind == "rows":
            rows_step(c, cta_step[c])
            cta_step[c] += 1
            continue
        s = drawer_step
        sums = [sum((partial[s % 2, t] for t in range(w, ntiles, 7)), torch.zeros(B, dtype=dt))
                for w in range(7)]
        r0 = torch.zeros(B, dtype=dt)
        for v in sums:
            r0 = r0 + v
        if s > 0 and correct:
            r0 = r0 + C_blocks[off + s].to(dt) @ dg_buf[(s - 1) * B:s * B]
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
    _assert_emulation_differs(monkeypatch, wait_dg=False)


def test_emulation_catches_rows_that_read_dg_a_block_early(monkeypatch):
    """Row steps that wait for dg one block too few (step s once dg_{s-2} is
    out, reading dg_{s-1} as it stands) give other outputs."""
    _assert_emulation_differs(monkeypatch, dg_lag=1)


def test_emulation_catches_a_missing_cross_gram_correction(monkeypatch):
    """The lookahead's right-hand side without C_{b+1} dg_b (the partials
    formed before dg_b alone) gives other outputs."""
    _assert_emulation_differs(monkeypatch, correct=False)


def _assert_emulation_differs(monkeypatch, **fault):
    monkeypatch.setattr(TB, "_draws_plain", _int_draws)
    spec, args = _integer_inputs("BayesR", 700)
    plan = TB.sweep1_plan(args[1].shape[1], spec.block, TB.n_rows(spec), 1, 6)
    ref = TB.sweep_mc_plain(spec, *args)
    out = _emulate_sweep1(spec, args, plan, np.random.default_rng(0), **fault)
    assert not all(torch.equal(a, b) for a, b in zip(ref, out))


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


# ---------------------------------------------------------------------------
# the cross-Grams of consecutive blocks
# ---------------------------------------------------------------------------


def _cross_reference(X_blocks):
    """X_k' X_{k-1} in float64 over consecutive kernel blocks, entry 0 zero."""
    Xd = X_blocks.to(torch.float64)
    ref = torch.zeros((Xd.shape[0], Xd.shape[2], Xd.shape[2]), dtype=torch.float64)
    for k in range(1, Xd.shape[0]):
        ref[k] = Xd[k].T @ Xd[k - 1]
    return ref


@pytest.mark.parametrize("batch_blocks", [None, 1, 2], ids=["one_batch", "batch1", "batch2"])
@pytest.mark.parametrize("B,n", [(64, 300), (256, 300), (64, 4100)],
                         ids=["B64", "sub_blocks", "padded_rows"])
@pytest.mark.parametrize("int8", [True, False], ids=["int8", "f32"])
def test_prepare_gibbs_data_cross_grams(int8, B, n, batch_blocks, monkeypatch):
    """GibbsData.C_blocks is X_k' X_{k-1} of consecutive kernel blocks, exact
    (the float64 product), entry 0 zero, in the Gram blocks' dtype: for an
    int8 and a float32 genotype, blocks of 64 and of 256 (two sub-blocks of
    128: a block's second sub-block against its first, and the first
    against the block before), padded rows (n=4,100 to 4,608), and with the
    Gram's cast batches made small, so that pairs straddle batches of one
    and two blocks; cross_grams gives the same."""
    rng = np.random.default_rng(11)
    m = 700
    M = rng.binomial(2, 0.3, (n, m)).astype(np.int8)
    y = rng.normal(size=n)
    if batch_blocks is not None:
        W = min(B, TB.MAX_BLOCK)
        rows = 512 * -(-n // 512) if n > 4096 else n
        monkeypatch.setattr(TG, "GRAM_BATCH_BYTES", (batch_blocks + 1) * rows * W * 4)
    data = TG.prepare_gibbs_data(y, M if int8 else M.astype(np.float32), block=B,
                                 geno_dtype="int8" if int8 else None, device="cpu")
    assert data.C_blocks.dtype == data.W_blocks.dtype == torch.float32
    assert data.C_blocks.shape == data.W_blocks.shape
    ref = _cross_reference(data.X_blocks)
    assert torch.equal(data.C_blocks.to(torch.float64), ref)
    assert torch.equal(TB.cross_grams(data.X_blocks), data.C_blocks)
    assert torch.equal(TB.cross_grams(data.X_blocks, batch_bytes=1), data.C_blocks)


def test_cross_grams_are_made_once_per_genotype():
    """A one-chain sweep called without C_blocks reads cross_grams, made once
    per genotype tensor (and anew for another)."""
    X = torch.from_numpy(np.random.default_rng(2).integers(0, 3, (5, 40, 8)).astype(np.int8))
    a, b = TB.cross_grams(X), TB.cross_grams(X)
    assert a is b and torch.equal(a.double(), _cross_reference(X))
    assert TB.cross_grams(X.clone()) is not a


# ---------------------------------------------------------------------------
# the benchmark's reader of the lookahead's counters
# ---------------------------------------------------------------------------


def _stretch(counts, monkeypatch):
    """A benchmark context whose program store holds one engine.iteration
    span a dict of ``counts`` (each with an ops.sweep_mc span under it that
    holds them), on a trace clock equal to the perf counter."""
    recs = []
    for i, c in enumerate(counts):
        it = profiling.Span("engine.iteration", 1000 * (2 * i + 1), len(recs), None, i)
        it.t1 = 1000 * (2 * i + 2)
        recs.append(it)
        sw = profiling.Span("ops.sweep_mc", it.t0 + 10, len(recs), it.index, i)
        sw.t1, sw.counts = it.t1 - 10, dict(c) or None
        recs.append(sw)
    monkeypatch.setattr(profiling, "spans", lambda: list(recs))
    monkeypatch.setattr(profiling, "clock_ns", lambda: 0)
    return {"timeline": {"host": [(profiling.MARKER, 0.0, 0.0)], "window": (0.0, 1.0)}}


def test_sweep1_lookahead_pct_reads_the_counters(monkeypatch):
    """sweep1_lookahead_pct is 100 x the blocks whose right-hand side the
    lookahead formed over the blocks launched, summed over the stretch's
    iterations (k1: 511 of 512 a launch; the 4-chip cell: 4 launches of
    1,172 an iteration); None where the program counts no such block (a
    program without the lookahead) or keeps no spans."""
    from port_bench.metrics import sweep1_lookahead_pct as reader

    k1 = {"ops.sweep1.blocks": 512, "ops.sweep1.lookahead": 511}
    assert reader.read(_stretch([k1] * 3, monkeypatch)) == pytest.approx(100 * 511 / 512)
    pipe = {"ops.sweep1.blocks": 4 * 1172, "ops.sweep1.lookahead": 4 * 1171}
    assert reader.read(_stretch([pipe, pipe], monkeypatch)) == pytest.approx(
        100 * 1171 / 1172)
    assert reader.read(_stretch([{"rng.generators": 9}] * 2, monkeypatch)) is None
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert reader.read({"timeline": {"host": [], "window": (0.0, 1.0)}}) is None

