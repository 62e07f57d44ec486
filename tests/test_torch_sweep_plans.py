"""The host side of the redesigned epsilon sweep (TPU kernel 10) and dense
segment sweep (TPU kernel 6), on the CPU.

* The epsilon sweep's plan (ops/blockgibbs.py: mme_plan_host, mme_tile,
  mme_site_owner; csrc/mme.cu): each block's forward rows split by target
  block (the next block's rows for the drawer, rows two blocks on and
  further for the scatter), against a split made row by row, on layouts
  with targets 1, 2 and many blocks ahead, blocks without triplets, and
  T in {20, 64, 128}.
* A float64 emulation of the epsilon kernel's event order (the drawer's
  chain with its shuffles three draws ahead and the two draws before it
  subtracted by every lane, the next block's terms in the drawer, the
  terms two blocks on in shared memory, the rest in global memory, one
  phase a block) equals mme_sweep_plain bit for bit, and a wrong order
  does not.
* The segment sweep's plan (segment_plan, segment_rows, segment_smem;
  csrc/sgibbs.cu seg_sweep_kernel): every row owned once, a grid that fits
  the card, each CTA's shared memory under its limit.
* A float64 emulation of the segment kernel's event order (drawer and
  row-owner steps in any order their flags allow; the drawer's own
  contribution to the next block), with an integer-valued stand-in for the
  draws so that every sum is exact, equals sweep_s_segment_plain bit for
  bit at every order; a drawer that does not wait for the rows' owners
  does not.  The per-row sum's butterfly gives every lane the shuffle
  tree's value bit for bit (float32).
"""

import types

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from hibayes_tpu_torch.engine import gibbs as TG
from hibayes_tpu_torch.ops import blockgibbs as TB

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# the epsilon sweep's plan
# ---------------------------------------------------------------------------


def _coupled(q, T, dists, seed, empty=()):
    """A symmetric sparse A of q sites: a diagonal, within-block pairs, and
    for each distance d in ``dists`` pairs between block i and block i + d;
    blocks in ``empty`` couple to no later block."""
    rng = np.random.default_rng(seed)
    nbr = -(-q // T)
    rows, cols = list(range(q)), list(range(q))
    vals = list(2.0 + rng.random(q))
    for i in range(nbr):
        lo, hi = i * T, min(q, (i + 1) * T)
        for _ in range(3):
            a, b = rng.integers(lo, hi, 2)
            if a != b:
                rows += [a, b]; cols += [b, a]; vals += [-0.3, -0.3]
        if i in empty:
            continue
        for d in dists:
            if i + d >= nbr:
                continue
            tlo, thi = (i + d) * T, min(q, (i + d + 1) * T)
            for _ in range(rng.integers(1, 4)):
                a, b = rng.integers(lo, hi), rng.integers(tlo, thi)
                rows += [a, b]; cols += [b, a]; vals += [-0.25, -0.25]
    A = sps.csr_matrix((vals, (rows, cols)), shape=(q, q))
    A.sum_duplicates()
    return A


def _layout(A, T, dtype=torch.float64):
    return TG._build_epsl_sparse(A, T, dtype, "cpu")[0]


def _brute_plan(sp, nbr, T):
    """The split of each block's forward rows, row by row."""
    bp, urow, row_ptr = (t.tolist() for t in (sp.blk_ptr, sp.urow, sp.row_ptr))
    near, far = {}, []
    fr = [0]
    masks = np.zeros((nbr, 4), dtype=np.uint32)
    for i in range(nbr):
        for u in range(bp[i], bp[i + 1]):
            tb = urow[u] // T
            if tb == i + 1 and tb < nbr:
                near.setdefault(i, []).append((urow[u] - tb * T, row_ptr[u], row_ptr[u + 1]))
                continue
            two = tb == i + 2 and tb < nbr
            far.append((urow[u], row_ptr[u], row_ptr[u + 1], tb if two else -1))
            if two:
                k = urow[u] - tb * T
                masks[i, k // 32] |= np.uint32(1) << np.uint32(k % 32)
        fr.append(len(far))
    return near, far, fr, masks


@pytest.mark.parametrize("T", [20, 64, 128])
@pytest.mark.parametrize("dists", [(1,), (2,), (1, 2, 7), (3, 5)], ids=str)
def test_mme_plan_matches_a_row_by_row_split(T, dists):
    """The host plan of a layout against a split made row by row: the
    scatter's rows and their ranges, the mask of rows two blocks on, and
    each near row's entries (column, value bits) in stored order at its
    target site, for every block, with blocks that couple to nothing."""
    q = 9 * T - 5
    A = _coupled(q, T, dists, seed=T + len(dists), empty=(2, 5))
    sp = _layout(A, T, torch.float32)
    nbr = sp.diag_blocks.shape[0]
    h = TB.mme_plan_host(sp.blk_ptr, sp.urow, sp.row_ptr, sp.ent_col, sp.ent_val, nbr, T)
    near, far, fr, masks = _brute_plan(sp, nbr, T)
    TM = h["TM"]
    assert TM == TB.mme_tile(T) and h["RI"] % 4 == 0
    np.testing.assert_array_equal(h["far_rows"][:len(far)], np.array(far).reshape(-1, 4))
    np.testing.assert_array_equal(h["rec"][:, 0], fr[:-1])
    np.testing.assert_array_equal(h["rec"][:, 1], fr[1:])
    np.testing.assert_array_equal(h["rec"][:, 4:8].view(np.uint32), masks)
    ent0 = TB.MME_RECORD_HEAD + -(-(TM + 1) // 4) * 4
    col, val = sp.ent_col.numpy(), sp.ent_val.numpy().view(np.int32)
    for i in range(nbr):
        nptr = h["rec"][i, TB.MME_RECORD_HEAD:TB.MME_RECORD_HEAD + TM + 1]
        got = {k: h["rec"][i, ent0 + 2 * nptr[k]:ent0 + 2 * nptr[k + 1]].reshape(-1, 2)
               for k in range(TM) if nptr[k + 1] > nptr[k]}
        want = {k: np.stack([col[e0:e1], val[e0:e1]], 1) for k, e0, e1 in near.get(i, [])}
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    if 1 in dists:
        assert h["near_rows"] > 0
    if 2 in dists:
        assert h["two_rows"] > 0
    assert h["dist"].sum() == len(sp.urow)


def test_mme_plan_of_a_cut_layout_sends_rows_past_it_to_the_scatter():
    """Over the first k blocks alone, a row in block k (the next block, but
    not swept) or k + 1 goes to the scatter (global memory), not to the
    drawer or the rows two blocks on."""
    T = 20
    sp = _layout(_coupled(8 * T, T, (1, 2), seed=3), T, torch.float32)
    h = TB.mme_plan_host(sp.blk_ptr, sp.urow, sp.row_ptr, sp.ent_col, sp.ent_val, 3, T)
    last = h["rec"][2]
    assert (last[TB.MME_RECORD_HEAD:TB.MME_RECORD_HEAD + 33] == 0).all()
    assert (h["rec"][1:, 4:8] == 0).all()
    assert (h["far_rows"][:, 3][h["far_rows"][:, 0] >= 3 * T] == -1).all()


def test_each_lane_owns_consecutive_sites():
    """Site k's (lane, slot) in the epsilon chain: lane l owns sites
    S l .. S l + S - 1, so a block row's slice is one S-float load a lane."""
    for T, S in ((20, 1), (32, 1), (64, 2), (100, 4), (128, 4)):
        TM = TB.mme_tile(T)
        assert TM == 32 * S
        owners = [TB.mme_site_owner(k, TM) for k in range(TM)]
        assert sorted(owners) == [(lane, s) for lane in range(32) for s in range(S)]
    with pytest.raises(ValueError):
        TB.mme_tile(129)


# ---------------------------------------------------------------------------
# the epsilon kernel's event order, emulated in float64
# ---------------------------------------------------------------------------


def _chain(Wt, cs, r, swap_fixes=False):
    """mme_chain: draw j starts from site j's residual as it stood after
    draw j - 3's fold, and subtracts the folds of draws j - 2 and j - 1."""
    TM = r.shape[0]
    r = r.copy()
    v = [r[0], r[1], r[2]]
    dm1 = dm2 = 0.0
    dx = np.zeros(TM)
    for j in range(TM):
        invd, noise, w1, w2 = cs[j]
        if swap_fixes:
            rhs = (v[j % 3] - w1 * dm1) - w2 * dm2
        else:
            rhs = (v[j % 3] - w2 * dm2) - w1 * dm1
        d = rhs * invd + noise
        r = r - Wt[j] * d
        if j + 3 < TM:
            v[j % 3] = r[j + 3]
        dx[j] = d
        dm2, dm1 = dm1, d
    return dx


def _emulate_mme(sp, counts, scale, ve, z, x, res, swap_fixes=False, near_first=False):
    """mme_sweep as mme_sweep_kernel orders it, phase by phase, in float64.
    ``near_first`` subtracts the drawer's terms before the terms two blocks
    on (a wrong order for a row that takes both)."""
    D = sp.diag_blocks.numpy()
    nbr, T = D.shape[:2]
    h = TB.mme_plan_host(sp.blk_ptr, sp.urow, sp.row_ptr, sp.ent_col, sp.ent_val, nbr, T)
    TM, rec, far = h["TM"], h["rec"], h["far_rows"]
    near = _brute_plan(sp, nbr, T)[0]
    col, val = sp.ent_col.numpy(), sp.ent_val.numpy()
    counts, z, x = counts.numpy(), z.numpy(), x.numpy()
    res, x_new = res.numpy().copy(), x.copy()
    pad = lambda a: np.concatenate([a, np.zeros(TM - a.shape[0])])

    def prepare(i):
        # invd and noise as the plain version forms them (torch's float64
        # square root on the CPU is not correctly rounded everywhere; the
        # card's __fsqrt_rn is): the order of events is what is emulated
        sl = slice(i * T, (i + 1) * T)
        _, invd, noise = TB._block_constants(sp.diag_blocks[i].clone(), torch.as_tensor(counts[sl]),
                                             torch.tensor(scale, dtype=torch.float64),
                                             torch.tensor(ve, dtype=torch.float64),
                                             torch.as_tensor(z[sl]))
        Wt = np.zeros((TM, TM))
        Wt[:T, :T] = D[i].T
        cs = np.zeros((TM, 4))
        cs[:T, 0], cs[:T, 1] = invd.numpy(), noise.numpy()
        for j in range(1, T):
            cs[j, 2] = scale * Wt[j - 1, j]
            cs[j, 3] = scale * Wt[j - 2, j] if j >= 2 else 0.0
        return scale * Wt, cs

    rnext = {0: pad(res[:T])}
    acc, d2 = {}, {}
    dxs = {}
    for t in range(nbr + 1):
        if t < nbr:   # the drawer
            r = rnext[t]
            if near_first and t in d2:
                for k, a in acc.items():
                    r[k] = r[k] - scale * a
                for k, a in d2.pop(t).items():
                    r[k] = r[k] - scale * a
            else:
                if t in d2:
                    for k, a in d2.pop(t).items():
                        r[k] = r[k] - scale * a
                for k, a in acc.items():
                    r[k] = r[k] - scale * a
            res[t * T:(t + 1) * T] = r[:T]
            dx = _chain(*prepare(t), r, swap_fixes)
            dxs[t] = dx
            acc = {}
            for k, e0, e1 in near.get(t, []):   # the record's rows (their values in float64)
                a = 0.0
                for e in range(e0, e1):
                    a = a + float(val[e]) * dx[col[e]]
                acc[k] = a
        if t + 1 < nbr:   # warp 3: the next block's residual
            rnext[t + 1] = pad(res[(t + 1) * T:(t + 2) * T])
        if t >= 1:        # block t - 1's x and its scatter
            b = t - 1
            x_new[b * T:(b + 1) * T] = x[b * T:(b + 1) * T] + dxs[b][:T]
            for row, e0, e1, tb in far[rec[b, 0]:rec[b, 1]]:
                a = 0.0
                for e in range(e0, e1):
                    a = a + float(val[e]) * dxs[b][col[e]]
                if tb >= 0:
                    if near_first:
                        d2.setdefault(tb, {})[row - tb * T] = a
                    else:
                        k = row - tb * T
                        rnext[tb][k] = rnext[tb][k] - scale * a
                else:
                    res[row] = res[row] - scale * a
    return torch.as_tensor(x_new), torch.as_tensor(res)


def _mme_inputs(sp, seed=0):
    nbr, T = sp.diag_blocks.shape[:2]
    q = nbr * T
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(a, dtype=torch.float64)
    counts = f(rng.integers(0, 3, q).astype(float))
    z, x, b = f(rng.normal(size=q)), f(0.3 * rng.normal(size=q)), f(rng.normal(size=q))
    scale, ve = 0.7, 1.3
    res = b - scale * TG._epsl_matvec(sp, x) - counts * x
    return counts, scale, ve, z, x, res


def _pedigree_layout(T, q=710, seed=3):
    """The RCM-ordered A-inverse(nn) of a pedigree (q non-genotyped sites),
    as tests/test_torch_cuda.py's epsilon problem builds it, in float64."""
    from hibayes_tpu_torch.data.pedigree import make_ainv, make_ped, rcm_permutation

    rng = np.random.default_rng(seed)
    nfound, nkid = 100, q + 150
    ids = np.array([f"p{k}" for k in range(nfound + nkid)])
    sires = np.array(["0"] * nfound + [ids[rng.integers(0, nfound + k)] for k in range(nkid)])
    dams = np.array(["0"] * nfound + [ids[rng.integers(0, nfound + k)] for k in range(nkid)])
    _, s_idx, d_idx = make_ped(ids, sires, dams)
    Ai = make_ainv(s_idx, d_idx).tocsr()
    ng = np.sort(rng.choice(Ai.shape[0], q, replace=False))
    nn = Ai[ng].tocsc()[:, ng]
    perm = rcm_permutation(nn)
    return _layout(nn[perm][:, perm], T)


LAYOUTS = [("pedigree", 20), ("pedigree", 64), ("pedigree", 128), ("coupled", 20),
           ("coupled", 64)]


@pytest.mark.parametrize("kind,T", LAYOUTS)
def test_emulated_mme_order_equals_plain_sweep(kind, T):
    """The kernel's event order gives mme_sweep_plain's x_new and res bit
    for bit in float64 (every product and sum rounded on its own), over the
    whole layout and over its first 3 blocks alone."""
    sp = (_pedigree_layout(T) if kind == "pedigree"
          else _layout(_coupled(7 * T - 3, T, (1, 2, 4), seed=T), T))
    args = _mme_inputs(sp)
    for cut in (None, 3):
        lay, a = sp, args
        if cut is not None:
            lay = sp._replace(diag_blocks=sp.diag_blocks[:cut], blk_ptr=sp.blk_ptr[:cut + 1])
            a = (args[0][:cut * T], args[1], args[2], args[3][:cut * T], args[4][:cut * T],
                 args[5])
        ref = TB.mme_sweep_plain(lay, *a)
        out = _emulate_mme(lay, *a)
        assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])


def test_emulated_mme_wrong_orders_differ():
    """Subtracting a draw's two recent folds in the other order, or a row's
    terms from the block before before those from two blocks before, gives
    other bits: the emulation can tell."""
    T, q = 20, 7 * 20 - 3
    band = sps.diags([np.full(q - 1, -0.1), np.full(q - 2, -0.05)], [1, 2])
    sp = _layout(_coupled(q, T, (1, 2), seed=11) + band + band.T, T)
    args = _mme_inputs(sp, seed=1)
    ref = TB.mme_sweep_plain(sp, *args)
    out = _emulate_mme(sp, *args, swap_fixes=True)
    assert not torch.equal(out[0], ref[0])
    # rows that take terms from both of the two blocks before theirs
    h = TB.mme_plan_host(sp.blk_ptr, sp.urow, sp.row_ptr, sp.ent_col, sp.ent_val,
                         sp.diag_blocks.shape[0], T)
    assert h["near_rows"] and h["two_rows"]
    out = _emulate_mme(sp, *args, near_first=True)
    assert not (torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1]))


# ---------------------------------------------------------------------------
# the segment sweep's plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sms", [132, 114, 20])
@pytest.mark.parametrize("mc,B", [(1000 // 4 * 4, 4), (1024, 64), (32_768, 64),
                                  (32_768, 128), (4992, 128)])
def test_segment_plan_owns_each_row_once(mc, B, sms):
    """Every row of the segment has one row-owner warp, every warp's rows
    are a multiple of 4 and contiguous, the grid fits one CTA an SM, each
    CTA's shared memory is under the card's limit, and the drawers cover
    the chains, for K in {1, 4, 9, 64} and BayesCpi / BayesR rows."""
    for K in (1, 4, 9, 64):
        for R in (5, 15):
            cpc = next(c for c in (8, 4, 2, 1)
                       if TB.segment_smem(B, TB.padded_stride(R), c, 4, 1, B)[0] <= TB.SMEM_OPTIN)
            if -(-K // cpc) >= sms:
                with pytest.raises(ValueError, match="drawer CTAs"):
                    TB.segment_plan(mc, B, K, R, sms)
                continue
            plan = TB.segment_plan(mc, B, K, R, sms)
            assert plan["cpc"] == cpc
            assert plan["ndraw"] * plan["cpc"] >= K > (plan["ndraw"] - 1) * plan["cpc"]
            assert plan["ndraw"] + plan["nown"] <= sms
            assert plan["rw"] % 4 == 0 and 1 <= plan["kch"] <= K
            assert plan["trows"] == (32 if B <= 64 else 16) and plan["lds"] in (B, B + 4)
            owned = [r for o in range(plan["nown"]) for w in range(TB.SEG_WARPS)
                     for r in TB.segment_rows(o, w, plan["rw"], mc)]
            assert owned == list(range(mc))
            # the last CTA owns a row: no CTA idles
            assert len(TB.segment_rows(plan["nown"] - 1, 0, plan["rw"], mc)) > 0
            draw, own = TB.segment_smem(B, TB.padded_stride(R), plan["cpc"], plan["rw"],
                                        plan["kch"], plan["lds"])
            assert max(draw, own) == plan["smem"] <= TB.SMEM_OPTIN


def test_segment_plan_at_the_main_paths():
    """Phase 6 (m=32,768, B=64, BayesCpi) and 6b (4 chains): one drawer
    CTA, 128 row-owner CTAs of 8 warps x 32 rows, every chain in one pass;
    B=128 with BayesR rows takes one chain a drawer CTA; 64 chains at
    B=128 pass over a block in several."""
    assert TB.segment_plan(32_768, 64, 1, 5, 132) == {
        "cpc": 8, "ndraw": 1, "rw": 32, "nown": 128, "kch": 1, "trows": 32, "lds": 68,
        "smem": 210_176}
    k4 = TB.segment_plan(32_768, 64, 4, 5, 132)
    assert (k4["ndraw"], k4["nown"], k4["kch"]) == (1, 128, 4)
    assert TB.segment_plan(32_768, 128, 4, 15, 132)["cpc"] == 1
    big = TB.segment_plan(32_768, 128, 64, 5, 132)
    assert 1 < -(-64 // big["kch"]) < 64


def test_segment_plan_refuses_what_cannot_fit():
    with pytest.raises(ValueError, match="drawer CTAs"):
        TB.segment_plan(4096, 64, 64, 5, 8)


# ---------------------------------------------------------------------------
# the segment kernel's event order, emulated in float64
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


def _emulate_segment(LD, r0, P, n, B, plan, rng, wait=True):
    """sweep_s_segment as seg_sweep_kernel orders it, serialised: at each
    step one of the events the flags allow runs, chosen at random.  Drawer
    c's step b: r of block b (as the sweep began for blocks 0 and 1, else
    its owners' snapshot after block b - 2), plus its own n LD[b, b - 1]
    dg_{b-1}; its chains' draws; dg_b published.  Row-owner CTA o's step b
    (dg_b of every drawer published): its rows += n LD[rows, b] dg_b; the
    rows of block b + 2 into the snapshot; block b done.  ``wait=False``
    lets a drawer read the snapshot before its owners are through."""
    K, mc = r0.shape
    nb = mc // B
    cpc, ndraw, rw, nown = plan["cpc"], plan["ndraw"], plan["rw"], plan["nown"]
    r = r0.clone()
    dg = torch.zeros_like(r0)
    snap = torch.zeros((2, K, B), dtype=r0.dtype)
    drawn = [0] * ndraw                  # blocks each drawer has published
    done = [0] * nown                    # blocks each owner CTA has applied
    spec = types.SimpleNamespace(block=B, reject_guard=False, model_index=4, n_fold=2)
    Pb = TB.to_block_layout(P, nb, B)     # (nb, B, R, K)
    rows_cta = TB.SEG_WARPS * rw

    def owners(b):
        lo, hi = b * B, (b + 1) * B - 1
        return range(lo // rows_cta, hi // rows_cta + 1)

    while min(drawn) < nb or min(done) < nb:
        ready = []
        for c in range(ndraw):
            b = drawn[c]
            if b < nb and (b < 2 or not wait or all(done[o] >= b - 1 for o in owners(b))):
                ready.append(("draw", c))
        for o in range(nown):
            b = done[o]
            if b < nb and all(d > b for d in drawn):
                ready.append(("own", o))
        assert ready, "the flags deadlock"
        kind, i = ready[rng.integers(len(ready))]
        if kind == "own":
            b = done[i]
            cols = slice(b * B, (b + 1) * B)
            for w in range(TB.SEG_WARPS):
                rows = TB.segment_rows(i, w, rw, mc)
                if len(rows):
                    sl = slice(rows.start, rows.stop)
                    r[:, sl] += n * (LD[sl, cols][None] * dg[:, None, cols]).sum(2)
            two = slice((b + 2) * B, (b + 3) * B)
            if b + 2 < nb:
                mine = [x for w in range(TB.SEG_WARPS) for x in TB.segment_rows(i, w, rw, mc)
                        if two.start <= x < two.stop]
                for x in mine:
                    snap[(b + 2) % 2, :, x - two.start] = r[:, x]
            done[i] += 1
            continue
        b = drawn[i]
        ks = slice(i * cpc, min(K, (i + 1) * cpc))
        sl = slice(b * B, (b + 1) * B)
        if b == 0:
            rb = r0[ks, sl]
        else:
            base = r0[ks, sl] if b == 1 else snap[b % 2, ks]
            prev = slice((b - 1) * B, b * B)
            rb = base + n * (LD[sl, prev][None] * dg[ks, None, prev]).sum(2)
        _, d, _ = _int_draws(spec, Pb[b][..., ks], n * LD[sl, sl], rb.T)
        dg[ks, sl] = d.T
        drawn[i] += 1
    return dg, r


def _segment_inputs(K, mc, B, seed=0):
    rng = np.random.default_rng(seed)
    LD = torch.as_tensor(rng.integers(-2, 3, (mc, mc)).astype(float))
    LD = LD + LD.T
    r0 = torch.as_tensor(rng.integers(-20, 20, (K, mc)).astype(float))
    P = torch.as_tensor(rng.integers(-3, 4, (K, 5, mc)).astype(float))
    return LD, r0, P, 2.0


SEG_CASES = [(1, 96, 8, 6), (4, 96, 8, 6), (9, 96, 8, 3), (3, 128, 16, 4), (2, 64, 4, 40)]


@pytest.mark.parametrize("K,mc,B,sms", SEG_CASES)
def test_emulated_segment_order_equals_plain_sweep(K, mc, B, sms, monkeypatch):
    """With integer-valued draws every event order the flags allow gives
    sweep_s_segment_plain's dg and r bit for bit (three random orders each),
    for one and several drawer CTAs and row owners of one or many blocks."""
    monkeypatch.setattr(TB, "_draws_plain", _int_draws)
    LD, r0, P, n = _segment_inputs(K, mc, B)
    spec = types.SimpleNamespace(block=B, reject_guard=False, model_index=4, n_fold=2)
    ref = TB.sweep_s_segment_plain(spec, LD, r0, P, n)
    plan = TB.segment_plan(mc, B, K, 5, sms)
    plan = {**plan, "cpc": min(plan["cpc"], 4)}
    plan["ndraw"] = -(-K // plan["cpc"])
    for seed in range(3):
        dg, r = _emulate_segment(LD, r0, P, n, B, plan, np.random.default_rng(seed))
        assert torch.equal(dg, ref[0]) and torch.equal(r, ref[2])


def test_emulation_catches_a_drawer_that_does_not_wait(monkeypatch):
    """A drawer that reads its rows' snapshot before their owners are
    through gives other outputs in some order: the emulation can tell."""
    monkeypatch.setattr(TB, "_draws_plain", _int_draws)
    LD, r0, P, n = _segment_inputs(2, 96, 8)
    ref = TB.sweep_s_segment_plain(types.SimpleNamespace(block=8, reject_guard=False,
                                                         model_index=4, n_fold=2),
                                   LD, r0, P, n)
    plan = TB.segment_plan(96, 8, 2, 5, 6)
    differ = 0
    for seed in range(5):
        dg, r = _emulate_segment(LD, r0, P, n, 8, plan, np.random.default_rng(seed), wait=False)
        differ += not (torch.equal(dg, ref[0]) and torch.equal(r, ref[2]))
    assert differ > 0


def test_row_sum_butterfly_is_the_shuffle_tree():
    """The per-row sum over 32 lanes: a butterfly (xor) leaves in every lane
    the value the shuffle-down tree leaves in lane 0, bit for bit in
    float32 (each level adds the same two partial sums)."""
    rng = np.random.default_rng(0)
    for _ in range(200):
        p = (rng.normal(size=32) * 10.0 ** rng.integers(-6, 6, 32)).astype(np.float32)
        down, xor = p.copy(), p.copy()
        for o in (16, 8, 4, 2, 1):
            src = np.arange(32) + o
            down = down + np.where(src < 32, down[np.minimum(src, 31)], down)
            xor = xor + xor[np.arange(32) ^ o]
        assert down.dtype == np.float32 and (xor == down[0]).all()
