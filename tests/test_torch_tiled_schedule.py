"""The host side of the port's redesigned sweep kernels, on the CPU.

* The schedule of the one-launch tiled summary sweep
  (ops/blockgibbs.py:tiled_schedule, TPU kernel 9): on a band, a band with
  gaps, invalid slots and columns that are not a band, against counts made
  by brute force; and a plain emulation of the kernel's concurrency (the
  drawer's draws and every contribution run in any order the schedule's
  counters allow, in float64), equal bit for bit to sweep_s_tiled_plain.
* The K-chain rows kernel's tiling and register-tile shape (rows_per_tile,
  rows_mc_shape, TPU kernel 2): the tiling is the same for every K >= 2,
  and every shape has each output summed by exactly one thread of at most
  8 warps, over the columns or the tile's rows in order.
"""

import dataclasses

import numpy as np
import pytest
import torch

from hibayes_tpu_torch.data.sparse_ld import TiledSparseLD, _tiled_matvec
from hibayes_tpu_torch.engine import gibbs as TG
from hibayes_tpu_torch.engine import sgibbs as TSG
from hibayes_tpu_torch.engine.rng import IterNoise
from hibayes_tpu_torch.ops import blockgibbs as TB


def _layout(kind, nbr=24, K=9, seed=0):
    """(cols, valid) of nbr tile rows with K slots: a band (|i - j| <= K // 2,
    diagonal first, masked at the ends), a band with gaps, or columns that
    are not a band.  Invalid slots point at the row's own block."""
    rng = np.random.default_rng(seed)
    half = K // 2
    i = np.arange(nbr)[:, None]
    offs = np.array([0] + [s * o for o in range(1, half + 1) for s in (-1, 1)])
    cols = i + offs[None, :]
    valid = (cols >= 0) & (cols < nbr)
    if kind == "gaps":
        valid[:, 1:] &= rng.random((nbr, K - 1)) < 0.6
    elif kind == "nonband":
        for r in range(nbr):
            cols[r, 1:] = rng.permutation(np.delete(np.arange(nbr), r))[:K - 1]
        valid = np.ones((nbr, K), bool)
        valid[:, 1:] = rng.random((nbr, K - 1)) < 0.7
    return np.where(valid, cols, i), valid


def _brute(cols, valid):
    """need, total, the sequence number of every valid slot and the drawer's
    slot of each row, by direct counting."""
    nbr, K = cols.shape
    need, total, nxt = np.zeros(nbr, int), np.zeros(nbr, int), np.full(nbr, -1)
    seq = {}
    for r in range(nbr):
        for k in range(K):
            if not valid[r, k]:
                continue
            t = cols[r, k]
            seq[(r, k)] = total[t]
            total[t] += 1
            need[t] += r < t
            if t == r + 1:
                nxt[r] = k
    return need, total, seq, nxt


@pytest.mark.parametrize("kind,seed", [("band", 0), ("gaps", 1), ("gaps", 2), ("nonband", 3),
                                       ("nonband", 4)])
def test_tiled_schedule_counts(kind, seed):
    """need, total, nxt and every item's (row, slot, block, sequence number)
    equal a direct count; the items are the valid slots other than the
    drawer's, in row-major order."""
    cols, valid = _layout(kind, seed=seed)
    s = TB.tiled_schedule(torch.as_tensor(cols, dtype=torch.int32), torch.as_tensor(valid))
    need, total, seq, nxt = _brute(cols, valid)
    np.testing.assert_array_equal(s.need, need)
    np.testing.assert_array_equal(s.total, total)
    np.testing.assert_array_equal(s.nxt, nxt)
    want = [(r, k, cols[r, k], seq[(r, k)]) for r in range(cols.shape[0])
            for k in range(cols.shape[1]) if valid[r, k] and k != nxt[r]]
    assert [tuple(x) for x in s.items] == want
    assert s.items.shape[0] + (nxt >= 0).sum() == valid.sum()


def test_tiled_schedule_band_without_next_block():
    """Rows whose block i + 1 is not a valid slot have no drawer
    contribution, and block i + 1 then waits only for the others."""
    cols, valid = _layout("band", nbr=10, K=5)
    valid[3, cols[3] == 4] = False
    cols = np.where(valid, cols, np.arange(10)[:, None])
    s = TB.tiled_schedule(cols, valid)
    assert s.nxt[3] == -1 and (s.nxt[np.arange(10) != 3][:-1] >= 0).all()
    assert s.need[4] == 1   # only row 2's slot pointing at block 4


def test_tiled_schedule_invalid_slots_carry_nothing():
    """Invalid slots, which point at their own row's block, are neither
    items nor counted: a layout whose off-diagonal slots are all invalid
    has one contribution per block, its own."""
    nbr, K = 6, 3
    cols = np.repeat(np.arange(nbr)[:, None], K, 1)
    valid = np.zeros((nbr, K), bool)
    valid[:, 0] = True
    s = TB.tiled_schedule(cols, valid)
    np.testing.assert_array_equal(s.total, np.ones(nbr))
    np.testing.assert_array_equal(s.need, np.zeros(nbr))
    assert (s.nxt == -1).all() and s.items.tolist() == [[r, 0, r, 0] for r in range(nbr)]


def test_tiled_schedule_refuses_bad_layouts():
    cols, valid = _layout("band", nbr=8, K=3)
    bad = cols.copy()
    bad[2, 1] = bad[2, 0]   # two valid slots of row 2 on one block
    with pytest.raises(ValueError, match="distinct|one block"):
        TB.tiled_schedule(bad, valid | (np.arange(3) < 2))
    bad = cols.copy()
    bad[5, 2] = 8
    with pytest.raises(ValueError, match="outside"):
        TB.tiled_schedule(bad, np.ones_like(valid))
    with pytest.raises(ValueError, match="shape"):
        TB.tiled_schedule(cols, valid[:, :2])


def _problem(kind, guard, m=1200, T=128, model="BayesCpi"):
    """A float64 tiled summary problem on the CPU with the layout ``kind``
    (the band's tiles of 0.8^|i-j|; other layouts keep the tiles and change
    cols/valid), a mid-run state and one iteration's packed rows."""
    idx = np.arange(m)
    R = 0.8 ** np.abs(idx[:, None] - idx[None, :])
    R[np.abs(idx[:, None] // T - idx[None, :] // T) > 1] = 0.0
    ld = TiledSparseLD.from_dense(R, tile=T, dtype=np.float64)
    rng = np.random.default_rng(4)
    b = np.where(rng.random(m) < 0.05, rng.normal(0, 0.1, m), 0.0)
    ss = np.column_stack([np.full(m, 0.3), R @ b, np.full(m, 0.01), np.full(m, 1e4)])
    pi = np.array([0.95, 0.05]) if model == "BayesCpi" else np.array([0.95, 0.02, 0.02, 0.01])
    fold = None if model == "BayesCpi" else np.array([0.0, 1e-4, 1e-3, 1e-2])
    data, n, vary, nvar0, seg_sizes, seg_real = TSG.prepare_sgibbs_data(
        ss, ld, fold=fold, block=T, dtype=torch.float64, device="cpu")
    pr = TG.resolve_priors(None, float(ld.diag.sum()), pi[0], nr=0, vary=vary)
    spec = TG.GibbsSpec(
        model=model, n=n, m=m, m_pad=int(sum(seg_sizes)), block=T, nc=0, nlevels=(),
        n_fold=len(pi), niter=10, nburn=5, thin=5, nvar0=nvar0, dfvara=pr.dfvara,
        s2vara=pr.s2vara, dfvare=pr.dfvare, s2vare=pr.s2vare, s2varg=pr.s2varg,
        lambda_rate0=pr.lambda_rate0, vargl_strict_pos=True, real_excl_nvar0=True,
        reject_guard=True, vary=vary, seg_sizes=seg_sizes, seg_real=seg_real)
    gen = torch.Generator().manual_seed(2)
    g = torch.where((torch.rand(spec.m_pad, generator=gen, dtype=torch.float64) < 0.2)
                    & data.real, 0.05 * torch.randn(spec.m_pad, generator=gen,
                                                    dtype=torch.float64), 0.0)
    st = TSG.init_s_state(spec, data, pr, pi)._replace(g=g, it=2)
    P = TSG._s_pre_sweep(spec, data, IterNoise(3, 2, "cpu"), st)["P"]
    nbr, K = data.ld_cols.shape
    cols, valid = data.ld_cols.numpy(), data.ld_valid.numpy()
    if kind != "band":
        cols, valid = _layout(kind, nbr=nbr, K=K, seed=7)
    if not guard:
        spec = dataclasses.replace(spec, reject_guard=False)
        P = P[:TB.n_rows(spec)]
    r = data.xy - n * _tiled_matvec(data.ld_tiles, data.ld_cols, data.ld_valid, g)
    return (spec, data.ld_tiles, torch.as_tensor(cols, dtype=torch.int32),
            torch.as_tensor(valid), r, P, n)


def _emulate(spec, tiles, cols, valid, r_hat, P, n, sched, rng):
    """The kernel's concurrency, serialised: at each step one of the events
    the schedule's counters allow runs, chosen at random (a pending draw
    first, to read r_hat as early as the counters let it).  A draw of row i
    waits for need[i] contributions on block i; a contribution waits for its
    row's dg and for its sequence number on its block."""
    nbr, K, B, _ = tiles.shape
    dt = r_hat.dtype
    vary = torch.tensor(spec.vary, dtype=dt) if TB.guard_on(spec) else None
    P_blocks = TB._summary_blocks(P, nbr, B, dt)
    r = r_hat.clone()
    rb = r.view(nbr, B)
    dg = torch.empty((nbr * B,), dtype=dt)
    track = torch.empty((nbr * B,), dtype=dt)
    guard = torch.zeros((1, 2), dtype=torch.int64)
    items = [tuple(x) for x in sched.items.tolist()]
    items += [(i, int(k), i + 1, int(sched.need[i + 1]) - 1)
              for i, k in enumerate(sched.nxt) if k >= 0]
    cnt = np.zeros(nbr, int)
    dgs = {}
    next_row = 0
    while next_row < nbr or items:
        if next_row < nbr and cnt[next_row] == sched.need[next_row]:
            i = next_row
            T = tiles[i].to(dt)
            _, d, t = TB._draws_plain(spec, P_blocks[i], n * T[0], rb[i, :, None], vary, guard)
            dgs[i] = d[:, 0]
            dg[i * B:(i + 1) * B], track[i * B:(i + 1) * B] = d[:, 0], t[:, 0]
            next_row += 1
            continue
        ready = [x for x in items if x[0] in dgs and cnt[x[2]] == x[3]]
        assert ready, "the schedule deadlocks"
        row, k, tgt, _ = ready[rng.integers(len(ready))]
        items.remove((row, k, tgt, _))
        rb[tgt] += n * (dgs[row] @ tiles[row, k].to(dt))
        cnt[tgt] += 1
    np.testing.assert_array_equal(cnt, sched.total)
    return dg, track.to(torch.int32), r, guard[0, 0]


@pytest.mark.parametrize("guard", [True, False], ids=["guard", "noguard"])
@pytest.mark.parametrize("kind", ["band", "gaps", "nonband"])
def test_emulated_schedule_equals_plain_sweep(kind, guard):
    """In float64, every order of the kernel's events that the schedule's
    counters allow gives sweep_s_tiled_plain's dg, track, r_hat and
    rejection count bit for bit (three random orders each)."""
    spec, tiles, cols, valid, r, P, n = _problem(kind, guard)
    sched = TB.tiled_schedule(cols, valid)
    ref = TB.sweep_s_tiled_plain(spec, tiles, cols, valid, r, P, n)
    for seed in range(3):
        out = _emulate(spec, tiles, cols, valid, r, P, n, sched, np.random.default_rng(seed))
        for a, b in zip(ref, out):
            assert torch.equal(a, b)


def test_emulation_catches_a_wrong_schedule():
    """A schedule that lets block i + 1's draws start one contribution early
    gives another r_hat: the emulation above can tell."""
    spec, tiles, cols, valid, r, P, n = _problem("band", True)
    sched = TB.tiled_schedule(cols, valid)
    bad = dataclasses.replace(sched, need=sched.need - (sched.need > 0))
    ref = TB.sweep_s_tiled_plain(spec, tiles, cols, valid, r, P, n)
    with pytest.raises(AssertionError):
        out = _emulate(spec, tiles, cols, valid, r, P, n, bad, np.random.default_rng(0))
        for a, b in zip(ref, out):
            assert torch.equal(a, b)


@pytest.mark.parametrize("n", [4096, 9001, 50_176, 131_072])
def test_k_chain_tiling_does_not_depend_on_k(n):
    """The K-chain rows kernel's row tiles (the only thing besides n and B
    that orders a chain's partial sums) are the same for every K >= 2, on
    132 SMs and on another count."""
    for sms in (132, 114):
        tiles = {TB.rows_per_tile(n, sms, K) for K in (2, 3, 4, 5, 8, 17, 64, 100)}
        assert len(tiles) == 1
        tile = tiles.pop()
        assert tile % TB.MC_CHUNK_ROWS == 0 and -(-n // tile) <= sms


@pytest.mark.parametrize("tile", [32, 96, 384])
def test_k_chain_register_shapes_cover_each_output_once(tile):
    """For every batch size K in 2..70 the register-tile shape maps each
    residual output (chain, chunk row) and each partial output (chain,
    column) of a CTA to exactly one (warp, lane, register) of 8 warps, the
    kernel's formulas (csrc/blockgibbs.cu rows_mc_kernel); so a chain's
    sums are formed by one thread each in the kernel's fixed order whatever
    the shape, and the shape may change with K."""
    B = 128
    for K in range(2, 71):
        tk, tr, rb, tc = TB.rows_mc_shape(K, tile)
        kc = min(K, TB.MC_CHAINS)
        cr = 32 * tr * rb
        assert cr in (32, 64) and (tile > 32 or cr == 32)
        res, part = {}, {}
        ncb = 128 // (32 * tc)
        for warp in range(8):
            for lane in range(32):
                kb1, rb1 = (warp // rb) * tk, (warp % rb) * 32 * tr + lane
                for j in range(tk):
                    for t in range(tr):
                        if kb1 + j < kc:
                            res.setdefault((kb1 + j, rb1 + 32 * t), []).append(warp)
                kb2, c2 = (warp // ncb) * tk, (warp % ncb) * 32 * tc + tc * lane
                for j in range(tk):
                    for q in range(tc):
                        if kb2 + j < kc and c2 + q < B:
                            part.setdefault((kb2 + j, c2 + q), []).append(warp)
        assert sorted(res) == [(k, r) for k in range(kc) for r in range(cr)]
        assert all(len(v) == 1 for v in res.values())
        assert sorted(part) == [(k, c) for k in range(kc) for c in range(B)]
        assert all(len(v) == 1 for v in part.values())


def test_layout_schedule_is_built_once_per_layout():
    """The tiled sweep's layout on the card (``tiled_plan``: the store
    re-tiled and its schedule) is made once per ``plans`` for the rows at
    one row_base, kept there, and made afresh for another ``plans``, for
    other rows and without ``plans``."""
    spec, tiles, cols, valid, r, P, n = _problem("gaps", True, T=30)
    sb = TB.tiled_sub_blocks(spec, 30)
    assert not sb.same
    plans = {}
    first = TB.tiled_plan(spec, tiles, cols, valid, plans=plans)
    again = TB.tiled_plan(spec, tiles, cols, valid, plans=plans)
    assert again[1] is first[1] and again[2] is first[2] and again[3] == first[3]
    assert len(plans) == 2
    for other in (TB.tiled_plan(spec, tiles, cols, valid, plans={}),
                  TB.tiled_plan(spec, tiles, cols, valid)):
        assert other[1] is not first[1] and other[2] is not first[2]
        assert torch.equal(other[1], first[1])
        np.testing.assert_array_equal(other[2].items, first[2].items)
    half = tiles.shape[0] // 2
    shard = TB.tiled_plan(spec, tiles[half:], cols[half:], valid[half:], half,
                          tiles.shape[0], plans)
    assert shard[2] is not first[2] and shard[2].row_base == half * sb.S
    assert len(plans) == 4
