"""Blocked-Gibbs SNP sweep: host phases, CUDA kernels and their plain versions.

Counterpart of hibayes_tpu/ops/blockgibbs.py.  Every quantity of a draw that
does not depend on the sequential residual is computed before the sweep:

  phase A (``pack_rows``, torch ops over all SNPs): per-SNP packed rows
     [rg, g_old, inv_v, sz, (thresh | per-fold A/B/inv_v/sz ..., A0)],
     with the exp-free spike/slab threshold and BayesR's Gumbel noise
     folded into the A rows;
  phase B (the kernels): per block, r0 = X_b' yadj, B sequential draws
     corrected through the Gram block W_b, then yadj += X_b dg, u -= X_b dg;
  phase C (``phase_c_mc``, torch ops): the order-independent rest
     (BayesL local variances, variance accumulators).

Two kernels carry phase B of the individual-level sweep (csrc/blockgibbs.cu):

* ``block_draws``: the B draws of one block for K chains, given r0
  (replaces ``_s_block_draws``/``_kernel_s_block_t``);
* ``sweep_mc``: the fused K-chain sweep over a range of blocks, with X int8
  or f32 (replaces ``sweep_mc_t``, ``sweep_mc_ti`` and ``sweep_mc_tc``).

Two carry the single-chain summary-level (sbrm) sweep (csrc/sgibbs.cu),
whose state is r_hat instead of a residual:

* ``sweep_s_segment``: one dense LD segment (replaces ``sweep_s_segment`` /
  ``_kernel_s``);
* ``sweep_s_tiled``: every tile row of a tiled sparse LD, with the SBayesS
  rejection guard (replaces ``sweep_s_tiled`` / ``_kernel_s_tiled``).

Each has a plain PyTorch version with the same contract (``*_plain``):
loops over blocks and SNPs in Python with tensor ops (across the K chains
for the individual-level ones), in any float dtype.  A wrapper takes its
plain version only for tensors on the CPU; for CUDA tensors it launches the
kernel or raises.  Each wrapper counts its own launches in a plain integer
attribute (``.launches``), and each plain version its calls (``.calls``).
The libraries count every launch of each CUDA kernel where it is made
(:func:`kernel_launches`): a sweep over nbg blocks launches ``rows_kernel``
nbg + 1 times and ``draws_kernel`` nbg times; a segment sweep over nb blocks
``segment_draws`` and ``segment_update`` nb times each; a tiled sweep over
nbr tile rows ``tiled_draws`` and ``tiled_scatter`` nbr times each.
"""

from __future__ import annotations

import ctypes

import torch

from ..math.distributions import inv_gaussian_from
from . import build

F32 = torch.float32
NEG_BIG = -1e30
POS_BIG = 1e30
MAX_BLOCK = 128   # kernel limit: SNPs per block (csrc/draws.cuh kMaxBlock)
MAX_FOLD = 8      # kernel limit: BayesR folds
MIN_TILE_ROWS = 128  # rows one pass of a rows_kernel CTA covers (32 warps x 4)
N_RETRY = 8       # pre-drawn candidates of the rejection guard (csrc/draws.cuh kRetry)


def n_rows(spec) -> int:
    """Packed rows per SNP for the spec's model."""
    mi = spec.model_index
    if mi in (3, 4):
        return 5
    if mi == 6:
        return 3 + 4 * (spec.n_fold - 1)
    return 4


def pack_rows(spec, consts_b, xpx, vx, vei_b, g_b, z_b, u_b, chi_b, vargL_b,
              dtype):
    """Phase A for K chains: (K, R, m) packed rows in ``dtype``.

    Port of ``_pack_rows`` (hibayes_tpu/ops/blockgibbs.py:61-135) with the
    chain axis written out.  ``consts_b`` holds (K,) scalars and (K, n_fold)
    vectors; BayesR's ``u_b`` is (K, m, n_fold), one uniform per fold."""
    mi = spec.model_index
    dt = dtype
    x = xpx.to(dt)[None, :]
    ve = vei_b.to(dt)
    act = (vx > 0)[None, :]
    g = g_b.to(dt)
    z = z_b.to(dt)
    rg = x * g
    zero = torch.zeros((), dtype=dt, device=g.device)
    s2varg_df = consts_b["s2varg_df"].to(dt)[:, None]

    def cond_coeffs(varg):
        v = x + ve / varg
        inv_v = torch.where(act, 1.0 / v, zero)
        sz = torch.where(act, torch.sqrt(ve / v) * z, zero)
        return v, inv_v, sz

    if mi == 1:
        _, inv_v, sz = cond_coeffs(consts_b["varg"].to(dt)[:, None])
        rows = [rg, g, inv_v, sz]
    elif mi == 2:
        _, inv_v, sz = cond_coeffs((g * g + s2varg_df) / chi_b.to(dt))
        rows = [rg, g, inv_v, sz]
    elif mi in (3, 4):
        vargj = ((g * g + s2varg_df) / chi_b.to(dt) if mi == 3
                 else consts_b["varg"].to(dt)[:, None])
        v, inv_v, sz = cond_coeffs(vargj)
        logdetV = torch.log(vargj * x / ve + 1.0)
        uu = u_b.to(dt)
        Lu = torch.log((1.0 - uu) / torch.clamp_min(uu, 1e-37))
        logpi = consts_b["logpi"].to(dt)
        dlogpi = (logpi[:, 1] - logpi[:, 0])[:, None]
        thresh = 2.0 * v * ve * (Lu + 0.5 * logdetV - dlogpi)
        thresh = torch.where(act, thresh, torch.full((), POS_BIG, dtype=dt,
                                                     device=g.device))
        rows = [rg, g, inv_v, sz, thresh]
    elif mi == 5:
        v = x + 1.0 / vargL_b.to(dt)
        inv_v = torch.where(act, 1.0 / v, zero)
        sz = torch.where(act, torch.sqrt(ve / v) * z, zero)
        rows = [rg, g, inv_v, sz]
    else:  # BayesR: Gumbel-max fold draw, the Gumbels folded into A_f
        ut = torch.clamp_min(u_b.to(dt).transpose(1, 2), 1e-12)  # (K, nf, m)
        gum = -torch.log(-torch.log(ut))
        logpi = consts_b["logpi"].to(dt)
        vara_fold = consts_b["vara_fold"].to(dt)
        neg_big = torch.full((), NEG_BIG, dtype=dt, device=g.device)
        rows = [rg, g]
        for f in range(1, spec.n_fold):
            vara_f = torch.clamp_min(vara_fold[:, f], 1e-30)[:, None]
            vf = x + ve / vara_f
            A_f = -0.5 * torch.log(vara_f * x / ve + 1.0) + logpi[:, f, None]
            A_f = torch.where(act, A_f + gum[:, f], neg_big)
            B_f = 0.5 / (vf * ve)
            ivf = torch.where(act, 1.0 / vf, zero)
            szf = torch.where(act, torch.sqrt(ve / vf) * z, zero)
            rows += [A_f, B_f, ivf, szf]
        rows.append(logpi[:, 0, None] + gum[:, 0])  # fold-0 Gumbel logit
    return torch.stack(rows, dim=1)


def to_block_layout(P, nblocks: int, B: int):
    """(K, R, m) -> (nblocks, B, R, K): SNP j of block b is one (R, K) tile.
    Port of ``to_block_layout`` (hibayes_tpu/ops/blockgibbs.py:526-534)."""
    K, R = P.shape[0], P.shape[1]
    return P.reshape(K, R, nblocks, B).permute(2, 3, 1, 0).contiguous()


def phase_c_mc(spec, consts_b, vx, vei_b, g_new, track, u_b, z2_b, vargL_b,
               yadj_o, u_o):
    """Order-independent post-sweep state for the K-chain sweeps
    (``_phase_c_mc``, hibayes_tpu/ops/blockgibbs.py:1098-1133)."""
    mi = spec.model_index
    K = g_new.shape[0]
    dt = g_new.dtype
    zero = torch.zeros((), dtype=dt, device=g_new.device)
    act = (vx > 0)[None, :]
    if mi == 4:
        vargi_acc = torch.where(track == 1, g_new * g_new, zero).sum(dim=1)
    else:
        vargi_acc = torch.zeros((K,), dtype=dt, device=g_new.device)
    if mi == 6:
        ffold = torch.gather(consts_b["fold"].to(dt), 1, track.long())
        vargR_acc = torch.where(
            track > 0, g_new * g_new / torch.clamp_min(ffold, 1e-30), zero
        ).sum(dim=1)
    else:
        vargR_acc = torch.zeros((K,), dtype=dt, device=g_new.device)
    if mi == 5:
        lam2 = consts_b["lambda2"].to(dt).reshape(K, 1)
        lam = torch.sqrt(lam2)
        mu_ig = (torch.sqrt(vei_b.to(dt)) * lam
                 / torch.clamp_min(torch.abs(g_new), 1e-30))
        ig = inv_gaussian_from(z2_b.to(dt), u_b.to(dt), mu_ig, lam2)
        vargi = 1.0 / ig
        ok = (vargi > 0) if spec.vargl_strict_pos else (vargi >= 0)
        vargL_new = torch.where(act & ok, vargi, vargL_b.to(dt))
    else:
        vargL_new = vargL_b.to(dt)
    return (g_new, track, vargL_new, yadj_o, u_o, vargi_acc, vargR_acc)


# ---------------------------------------------------------------------------
# the draws of one block: shared arithmetic of both plain versions
# ---------------------------------------------------------------------------


def draw_from_vals(mi: int, nf: int, p, rhs, consts):
    """One draw for K chains: ``p`` the R packed rows of the SNP, each (K,);
    ``rhs`` (K,).  Returns (gi, track), track None for the models without a
    mixture.  Same arithmetic and tie rules as ``_draw_from_vals``
    (hibayes_tpu/ops/blockgibbs.py:537-579) and the kernel's ``draw_one``
    (csrc/draws.cuh).  ``consts`` holds 0-d tensors: zero, floor (1e-6) and
    the fold indices."""
    zero = consts["zero"]
    if mi in (1, 2):
        return torch.addcmul(p[3], rhs, p[2]), None
    if mi in (3, 4):
        ind = rhs * rhs >= p[4]
        return torch.where(ind, torch.addcmul(p[3], rhs, p[2]), zero), ind
    if mi == 5:
        gi = torch.addcmul(p[3], rhs, p[2])
        gi = torch.where(torch.abs(gi) < 1e-6, consts["floor"], gi)
        return torch.where(p[2] > 0, gi, zero), None
    # BayesR: a later fold wins only on a strict '>', which keeps the lowest
    # index among equal maxima exactly like the TPU's balanced tournament
    q = rhs * rhs
    best = p[2 + 4 * (nf - 1)] + 0.0 * rhs
    gi = torch.zeros_like(rhs)
    ind = torch.zeros_like(rhs)
    for f in range(1, nf):
        base = 2 + 4 * (f - 1)
        sf = torch.addcmul(p[base], p[base + 1], q)
        sel = sf > best
        best = torch.where(sel, sf, best)
        gi = torch.where(sel, torch.addcmul(p[base + 3], rhs, p[base + 2]), gi)
        ind = torch.where(sel, consts["folds"][f], ind)
    return gi, ind


def guard_draw(mi: int, nf: int, base: int, p, rhs, gi, track, vary):
    """The SBayesS rejection guard on one draw, K chains (the kernel's
    ``guard_draw``, csrc/draws.cuh; ``_kernel_s_tiled``,
    hibayes_tpu/ops/blockgibbs.py:1672-1686): while gi^2 vx > vary with a
    nonzero component, take the next pre-drawn candidate (BayesC:
    rhs inv_v + sd z_t; BayesR: the drawn fold's), N_RETRY at most, else 0.
    ``p`` holds the packed rows, then from index ``base`` the guard rows
    (:func:`pack_retry_rows`).  Returns (gi, the (K,) mask of first draws
    rejected)."""
    vxj = p[base]
    on = track > 0
    rej = (gi * gi * vxj > vary) & on
    first = rej
    if not bool(rej.any()):   # the retries would leave every gi as it is
        return gi, first
    for t in range(N_RETRY):
        if mi == 4:
            cand = torch.addcmul(p[base + 1 + t], rhs, p[2])
        else:
            cand = torch.zeros_like(gi)
            for f in range(1, nf):
                cf = torch.addcmul(p[base + 1 + t * (nf - 1) + (f - 1)], rhs,
                                   p[4 + 4 * (f - 1)])
                cand = torch.where(track == f, cf, cand)
        gi = torch.where(rej, cand, gi)
        rej = (gi * gi * vxj > vary) & on
    return torch.where(rej, torch.zeros_like(gi), gi), first


def _draws_plain(spec, P_b, W_b, r0, vary=None):
    """B sequential draws: P_b (B, R, K), W_b (B, B), r0 (B, K).  With
    ``vary`` (a 0-d tensor), the rejection guard follows each draw and P_b
    carries the guard rows.  Returns (gi, dg, track, rejected), the first
    three (B, K), ``rejected`` the number of draws whose first candidate the
    guard rejected.

    The rows are unbound into per-SNP views once per block, and r holds
    rhs_j = X_j' yadj + rg_j, so each draw is a handful of (K,) ops."""
    mi, nf = spec.model_index, spec.n_fold
    dt, dev = r0.dtype, r0.device
    consts = {
        "zero": torch.zeros((), dtype=dt, device=dev),
        "floor": torch.full((), 1e-6, dtype=dt, device=dev),
        "folds": torch.arange(nf, dtype=dt, device=dev).unbind(0),
    }
    rows = [row.unbind(0) for row in P_b.unbind(1)]   # rows[r][j]: (K,)
    base = guard_base(spec)
    r = r0 + P_b[:, 0]
    rv = r.unbind(0)                                  # views, see the updates
    wcols = W_b.unsqueeze(2).unbind(0)                # (B, 1): W_b[j, :]
    gis, dgs, trs = [], [], []
    rejected = 0
    for j in range(r0.shape[0]):
        p_j = [row[j] for row in rows]
        g_j, t_j = draw_from_vals(mi, nf, p_j, rv[j], consts)
        if vary is not None:
            g_j, first = guard_draw(mi, nf, base, p_j, rv[j], g_j, t_j, vary)
            rejected += int(first.sum())
        d_j = rows[1][j] - g_j
        r.addcmul_(wcols[j], d_j)
        gis.append(g_j)
        dgs.append(d_j)
        trs.append(t_j)
    track = (torch.zeros_like(r0) if trs[0] is None
             else torch.stack(trs).to(dt))
    return torch.stack(gis), torch.stack(dgs), track, rejected


# ---------------------------------------------------------------------------
# block_draws: the draw-only kernel
# ---------------------------------------------------------------------------


def _check_kernel_shapes(spec, B: int, K: int):
    if not (0 < B <= MAX_BLOCK and B % 4 == 0):
        raise ValueError(f"the CUDA sweep needs a block of at most {MAX_BLOCK} "
                         f"SNPs and a multiple of 4, got {B}")
    if spec.n_fold > MAX_FOLD:
        raise ValueError(f"the CUDA sweep takes at most {MAX_FOLD} folds, "
                         f"got {spec.n_fold}")
    if K < 1:
        raise ValueError("no chains")


def rows_per_tile(n: int, device) -> int:
    """Rows of n per CTA of the sweep's rows_kernel: about one tile per SM.
    Each warp makes only a few round trips to memory, so the kernel is bound
    by their latency and every SM must take part (NVIDIA H100 80GB HBM3,
    132 SMs, 700 W, n=50,176: 512-row tiles took 19.5 us per block and
    384-row tiles 10.6 us; PERF.md)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(MIN_TILE_ROWS, -(-n // sms))


def kernel_launches() -> dict:
    """Launches of each CUDA kernel since :func:`reset_kernel_launches`,
    counted in the libraries where each kernel is launched."""
    rows, draws = ctypes.c_longlong(), ctypes.c_longlong()
    build.library().hb_launch_counts(ctypes.byref(rows), ctypes.byref(draws))
    s = (ctypes.c_longlong * 4)()
    build.library("sgibbs.cu").hb_s_launch_counts(s)
    return {"rows_kernel": rows.value, "draws_kernel": draws.value,
            "segment_draws": s[0], "segment_update": s[1],
            "tiled_draws": s[2], "tiled_scatter": s[3]}


def reset_kernel_launches() -> None:
    build.library().hb_reset_launch_counts()
    build.library("sgibbs.cu").hb_s_reset_launch_counts()


def _require_cuda(*tensors):
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"expected a CUDA tensor, got one on {t.device}")
        if t.device != tensors[0].device:
            raise ValueError("tensors on different devices")


def block_draws_plain(spec, logpi_row, P_b, W_b, r0):
    """Plain version of :func:`block_draws`, in the dtype of ``r0``."""
    block_draws_plain.calls += 1
    _, dg, track, _ = _draws_plain(spec, P_b.to(r0.dtype), W_b.to(r0.dtype), r0)
    return dg, track


block_draws_plain.calls = 0


def block_draws(spec, logpi_row, P_b, W_b, r0):
    """(dg, track) of one block of B sequential draws for K chains:
    r0 (B, K) = X_b' yadj, W_b (B, B), P_b (B, R, K) from :func:`pack_rows`.
    ``logpi_row`` (1, K) completes the contract of ``_s_block_draws``; the
    draws read the fold-0 logit from the packed rows, as there."""
    if r0.device.type == "cpu":
        return block_draws_plain(spec, logpi_row, P_b, W_b, r0)
    _require_cuda(r0, W_b, P_b)
    B, K = r0.shape
    R = P_b.shape[1]
    _check_kernel_shapes(spec, B, K)
    if (tuple(W_b.shape) != (B, B) or tuple(P_b.shape) != (B, R, K)
            or tuple(logpi_row.shape) != (1, K) or R != n_rows(spec)):
        raise ValueError("block_draws: inconsistent shapes")
    if r0.dtype != F32 or W_b.dtype != F32 or P_b.dtype != F32:
        raise TypeError("block_draws: the kernel takes float32")
    lib = build.library()
    r0t = r0.t().contiguous()
    W = W_b.contiguous()
    P = P_b.contiguous()
    dg = torch.empty((B, K), dtype=F32, device=r0.device)
    track = torch.empty((B, K), dtype=F32, device=r0.device)
    code = lib.hb_block_draws(
        r0t.data_ptr(), W.data_ptr(), P.data_ptr(), B, R, K,
        spec.model_index, spec.n_fold, dg.data_ptr(), track.data_ptr(),
        torch.cuda.current_stream(r0.device).cuda_stream)
    build.check(lib, code, "block_draws")
    block_draws.launches += 1
    return dg, track


block_draws.launches = 0


# ---------------------------------------------------------------------------
# sweep_mc: the fused K-chain sweep
# ---------------------------------------------------------------------------


def sweep_mc_plain(spec, consts_b, X_blocks, W_blocks, xpx, vx, vei_b, g_b,
                   z_b, u_b, chi_b, z2_b, vargL_b, yadj_b, u_vec_b,
                   block_range=None):
    """Plain version of :func:`sweep_mc`, in the dtype of ``yadj_b``.  On the
    CPU it takes the role of the JAX engine's ``_sweep_xla``."""
    sweep_mc_plain.calls += 1
    nb_tot, n, B = X_blocks.shape
    off, nbg = block_range if block_range is not None else (0, nb_tot)
    dt = yadj_b.dtype
    K = yadj_b.shape[0]
    P = pack_rows(spec, consts_b, xpx, vx, vei_b, g_b, z_b, u_b, chi_b,
                  vargL_b, dt)
    P_blocks = to_block_layout(P, nbg, B)
    yadj = yadj_b.clone()
    u = u_vec_b.to(dt).clone()
    g_new = torch.empty((K, nbg * B), dtype=dt, device=yadj.device)
    track = torch.empty((K, nbg * B), dtype=torch.int32, device=yadj.device)
    for b in range(nbg):
        Xb = X_blocks[off + b].to(dt)
        gi, dg, tr, _ = _draws_plain(spec, P_blocks[b], W_blocks[off + b].to(dt),
                                     (yadj @ Xb).T)
        delta = (Xb @ dg).T
        yadj += delta
        u -= delta
        g_new[:, b * B:(b + 1) * B] = gi.T
        track[:, b * B:(b + 1) * B] = tr.T.to(torch.int32)
    return phase_c_mc(spec, consts_b, vx, vei_b, g_new, track, u_b, z2_b,
                      vargL_b, yadj, u)


sweep_mc_plain.calls = 0


def sweep_mc(spec, consts_b, X_blocks, W_blocks, xpx, vx, vei_b, g_b, z_b,
             u_b, chi_b, z2_b, vargL_b, yadj_b, u_vec_b, block_range=None):
    """Fused K-chain sweep; the contract of ``sweep_mc_t``
    (hibayes_tpu/ops/blockgibbs.py:695-764).

    X_blocks (nb_tot, n, B) int8 or f32, W_blocks (nb_tot, B, B); per-SNP
    inputs are (m,) shared or (K, m) per chain, m = nbg * B; yadj_b, u_vec_b
    (K, n).  ``block_range=(off, nbg)`` sweeps blocks [off, off + nbg) of X
    and W (indexed globally) while the per-SNP inputs are the local slice.
    Returns (g_new, track, vargL_new, yadj, u, vargi_acc, vargR_acc)."""
    if X_blocks.device.type == "cpu":
        return sweep_mc_plain(spec, consts_b, X_blocks, W_blocks, xpx, vx,
                              vei_b, g_b, z_b, u_b, chi_b, z2_b, vargL_b,
                              yadj_b, u_vec_b, block_range=block_range)
    _require_cuda(X_blocks, W_blocks, yadj_b, u_vec_b, g_b)
    nb_tot, n, B = X_blocks.shape
    off, nbg = block_range if block_range is not None else (0, nb_tot)
    K = yadj_b.shape[0]
    _check_kernel_shapes(spec, B, K)
    if not (0 <= off and off + nbg <= nb_tot):
        raise ValueError(f"block_range {block_range} outside {nb_tot} blocks")
    if X_blocks.dtype not in (torch.int8, F32):
        raise TypeError(f"sweep_mc: X must be int8 or float32, got {X_blocks.dtype}")
    if W_blocks.dtype != F32 or yadj_b.dtype != F32:
        raise TypeError("sweep_mc: the kernel takes float32 W and residuals")
    if not X_blocks.is_contiguous() or X_blocks.data_ptr() % 16:
        raise ValueError("sweep_mc: X_blocks must be contiguous and 16-byte aligned")
    if (tuple(W_blocks.shape) != (nb_tot, B, B) or tuple(yadj_b.shape) != (K, n)
            or tuple(u_vec_b.shape) != (K, n)):
        raise ValueError("sweep_mc: W, yadj or u do not match X and the chains")
    lib = build.library()
    m_loc = nbg * B
    P = pack_rows(spec, consts_b, xpx, vx, vei_b, g_b, z_b, u_b, chi_b,
                  vargL_b, F32)
    if tuple(P.shape) != (K, n_rows(spec), m_loc):
        raise ValueError(f"sweep_mc: packed rows {tuple(P.shape)}, expected "
                         f"{(K, n_rows(spec), m_loc)} for block_range {block_range}")
    P_blocks = to_block_layout(P, nbg, B)
    W = W_blocks.contiguous()
    yadj = yadj_b.contiguous().clone()
    u = u_vec_b.to(F32).contiguous().clone()
    dev = yadj.device
    g_new = torch.empty((K, m_loc), dtype=F32, device=dev)
    dg = torch.empty((K, m_loc), dtype=F32, device=dev)
    track_f = torch.empty((K, m_loc), dtype=F32, device=dev)
    tile = rows_per_tile(n, dev)
    partial = torch.empty((-(-n // tile), K, B), dtype=F32, device=dev)
    code = lib.hb_sweep_mc(
        X_blocks.data_ptr(), int(X_blocks.dtype == torch.int8), W.data_ptr(),
        P_blocks.data_ptr(), off, nbg, n, tile, B, P.shape[1], K, spec.model_index,
        spec.n_fold, yadj.data_ptr(), u.data_ptr(), g_new.data_ptr(),
        dg.data_ptr(), track_f.data_ptr(), partial.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, code, "sweep_mc")
    sweep_mc.launches += 1
    return phase_c_mc(spec, consts_b, vx, vei_b, g_new,
                      track_f.to(torch.int32), u_b, z2_b, vargL_b, yadj, u)


sweep_mc.launches = 0


# ---------------------------------------------------------------------------
# summary-level (sbrm) sweeps: one chain, r_hat as the state
# ---------------------------------------------------------------------------


def guard_on(spec) -> bool:
    """Whether the tiled sweep applies the rejection guard: SBayesS
    semantics (``reject_guard``) for BayesC/Cpi and BayesR only."""
    return bool(spec.reject_guard) and spec.model_index in (4, 6)


def guard_base(spec) -> int:
    """Index of the first guard row (vx), after the packed rows
    (``_guard_base``, hibayes_tpu/ops/blockgibbs.py:1600-1607)."""
    return n_rows(spec)


def n_guard_rows(spec) -> int:
    """Guard rows per SNP: vx, then N_RETRY (BayesC) or N_RETRY x (nf - 1)
    (BayesR) candidate offsets."""
    return 1 + N_RETRY * (1 if spec.model_index == 4 else spec.n_fold - 1)


def pack_retry_rows(spec, consts_b, xpx, vx, vei_b, z_retry_b, dtype):
    """Guard rows for K chains, (K, 1 + ..., m): [vx, sd z_1 .. sd z_NR]
    (BayesC) or [vx, (sd_f z_1)_f .. (sd_f z_NR)_f] (BayesR, folds 1..nf-1).
    Port of ``_pack_retry_rows`` (hibayes_tpu/ops/blockgibbs.py:1610-1632)
    with the chain axis written out; ``z_retry_b`` is (K, N_RETRY, m)."""
    mi = spec.model_index
    x = xpx.to(dtype)[None, :]
    ve = vei_b.to(dtype)
    act = (vx > 0)[None, :]
    zero = torch.zeros((), dtype=dtype, device=ve.device)
    z = z_retry_b.to(dtype)
    rows = [vx.to(dtype)[None, :].expand(ve.shape[0], -1)]
    if mi == 4:
        v = x + ve / consts_b["varg"].to(dtype)[:, None]
        sd = torch.where(act, torch.sqrt(ve / v), zero)
        rows += [sd * z[:, t] for t in range(N_RETRY)]
    elif mi == 6:
        sds = []
        for f in range(1, spec.n_fold):
            vara_f = torch.clamp_min(consts_b["vara_fold"][:, f].to(dtype), 1e-30)[:, None]
            sds.append(torch.where(act, torch.sqrt(ve / (x + ve / vara_f)), zero))
        rows += [sd * z[:, t] for t in range(N_RETRY) for sd in sds]
    else:
        raise ValueError("the rejection guard exists for BayesC/Cpi and BayesR only")
    return torch.stack(rows, dim=1)


def _summary_blocks(P, nb: int, B: int, dt):
    """Packed rows (R, nb * B) -> (nb, B, R, 1): one chain's (B, R, K) tiles."""
    return P.to(dt).reshape(P.shape[0], nb, B).permute(1, 2, 0).unsqueeze(-1)


def sweep_s_segment_plain(spec, LD_seg, r_seg, P, n):
    """Plain version of :func:`sweep_s_segment`, in the dtype of ``r_seg``."""
    sweep_s_segment_plain.calls += 1
    mc, B = LD_seg.shape[0], spec.block
    dt = r_seg.dtype
    LD = LD_seg.to(dt)
    P_blocks = _summary_blocks(P, mc // B, B, dt)
    r = r_seg.clone()
    dg = torch.empty((mc,), dtype=dt, device=r.device)
    track = torch.empty((mc,), dtype=dt, device=r.device)
    for b in range(mc // B):
        sl = slice(b * B, (b + 1) * B)
        _, d, t, _ = _draws_plain(spec, P_blocks[b], n * LD[sl, sl], r[sl, None])
        r += n * (LD[:, sl] @ d[:, 0])
        dg[sl], track[sl] = d[:, 0], t[:, 0]
    return dg, track.to(torch.int32), r


sweep_s_segment_plain.calls = 0


def sweep_s_segment(spec, LD_seg, r_seg, P, n):
    """Single-chain summary sweep over one padded dense LD segment; the
    contract of ``sweep_s_segment`` (hibayes_tpu/ops/blockgibbs.py:1207-1254).

    LD_seg (mc, mc), mc a multiple of B; r_seg (mc,) the segment's r_hat;
    P (R, mc) the segment's packed rows (:func:`pack_rows` of one chain).
    Per block: B draws against n LD[block, block], then
    r_seg += n LD[:, block] dg.  The JAX wrapper's ``consts`` carry only the
    fold-0 logit, which the packed rows hold, so the port takes none.
    Returns (dg (mc,), track (mc,) int32, r_seg_new (mc,))."""
    if r_seg.device.type == "cpu":
        return sweep_s_segment_plain(spec, LD_seg, r_seg, P, n)
    _require_cuda(r_seg, LD_seg, P)
    mc, B, R = LD_seg.shape[0], spec.block, n_rows(spec)
    _check_kernel_shapes(spec, B, 1)
    if LD_seg.dtype != F32 or r_seg.dtype != F32 or P.dtype != F32:
        raise TypeError("sweep_s_segment: the kernel takes float32 (other "
                        "float types run on the CPU)")
    if (tuple(LD_seg.shape) != (mc, mc) or mc % B or tuple(r_seg.shape) != (mc,)
            or tuple(P.shape) != (R, mc)):
        raise ValueError(f"sweep_s_segment: LD {tuple(LD_seg.shape)}, r "
                         f"{tuple(r_seg.shape)} and packed rows {tuple(P.shape)} "
                         f"do not fit a segment of blocks of {B} with {R} rows")
    if not LD_seg.is_contiguous() or LD_seg.data_ptr() % 16:
        raise ValueError("sweep_s_segment: LD must be contiguous and 16-byte aligned")
    lib = build.library("sgibbs.cu")
    dev = r_seg.device
    Pc = P.contiguous()
    r = r_seg.clone(memory_format=torch.contiguous_format)
    dg = torch.empty((mc,), dtype=F32, device=dev)
    track = torch.empty((mc,), dtype=F32, device=dev)
    code = lib.hb_sweep_s_segment(
        LD_seg.data_ptr(), Pc.data_ptr(), mc, B, R, spec.model_index,
        spec.n_fold, float(n), r.data_ptr(), dg.data_ptr(), track.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, code, "sweep_s_segment")
    sweep_s_segment.launches += 1
    return dg, track.to(torch.int32), r


sweep_s_segment.launches = 0


def sweep_s_tiled_plain(spec, tiles, cols, valid, r_hat, P, n):
    """Plain version of :func:`sweep_s_tiled`, in the dtype of ``r_hat``."""
    sweep_s_tiled_plain.calls += 1
    nbr, K, B, _ = tiles.shape
    dt, dev = r_hat.dtype, r_hat.device
    vary = torch.tensor(spec.vary, dtype=dt, device=dev) if guard_on(spec) else None
    P_blocks = _summary_blocks(P, nbr, B, dt)
    r = r_hat.clone()
    rb = r.view(nbr, B)
    cols_l, valid_l = cols.tolist(), valid.tolist()
    dg = torch.empty((nbr * B,), dtype=dt, device=dev)
    track = torch.empty((nbr * B,), dtype=dt, device=dev)
    rejected = 0
    for i in range(nbr):
        T = tiles[i].to(dt)
        _, d, t, rej = _draws_plain(spec, P_blocks[i], n * T[0], rb[i, :, None], vary)
        d = d[:, 0]
        for k in range(K):
            if valid_l[i][k]:   # invalid slots point at the own row: skipped
                rb[cols_l[i][k]] += n * (d @ T[k])
        dg[i * B:(i + 1) * B], track[i * B:(i + 1) * B] = d, t[:, 0]
        rejected += rej
    return dg, track.to(torch.int32), r, torch.tensor(rejected, device=dev)


sweep_s_tiled_plain.calls = 0


def sweep_s_tiled(spec, tiles, cols, valid, r_hat, P, n):
    """Single-chain summary sweep over every tile row of a tiled sparse LD;
    the contract of ``sweep_s_tiled`` (hibayes_tpu/ops/blockgibbs.py:1730-1792)
    at row_base 0.

    tiles (nbr, K, B, B) with the diagonal tile in slot 0; cols, valid
    (nbr, K); r_hat (nbr * B,); P (R, nbr * B) the packed rows, followed by
    the guard rows (:func:`pack_retry_rows`) when :func:`guard_on`.  Per tile
    row i: B draws against n tiles[i, 0] (guarded), then for each valid slot
    r_hat[block cols[i, k]] += n tiles[i, k]^T dg.  Returns (dg, track int32,
    r_hat_new, rejected): ``rejected`` (a 0-d tensor) counts the draws whose
    first candidate the guard rejected."""
    if r_hat.device.type == "cpu":
        return sweep_s_tiled_plain(spec, tiles, cols, valid, r_hat, P, n)
    _require_cuda(r_hat, tiles, cols, valid, P)
    nbr, K, B, _ = tiles.shape
    _check_kernel_shapes(spec, B, 1)
    guard = guard_on(spec)
    R = n_rows(spec) + (n_guard_rows(spec) if guard else 0)
    if tiles.dtype != F32 or r_hat.dtype != F32 or P.dtype != F32:
        raise TypeError("sweep_s_tiled: the kernel takes float32 (other float "
                        "types run on the CPU)")
    if (tuple(tiles.shape) != (nbr, K, B, B) or tuple(cols.shape) != (nbr, K)
            or tuple(valid.shape) != (nbr, K) or tuple(r_hat.shape) != (nbr * B,)
            or tuple(P.shape) != (R, nbr * B)):
        raise ValueError(f"sweep_s_tiled: tiles {tuple(tiles.shape)}, cols/valid "
                         f"{tuple(cols.shape)}/{tuple(valid.shape)}, r_hat "
                         f"{tuple(r_hat.shape)} and packed rows {tuple(P.shape)} "
                         f"do not fit (R = {R})")
    if not tiles.is_contiguous() or tiles.data_ptr() % 16:
        raise ValueError("sweep_s_tiled: tiles must be contiguous and 16-byte aligned")
    lib = build.library("sgibbs.cu")
    dev = r_hat.device
    cols_i = cols.to(torch.int32).contiguous()
    valid_i = valid.to(torch.int32).contiguous()
    Pc = P.contiguous()
    r = r_hat.clone(memory_format=torch.contiguous_format)
    dg = torch.empty((nbr * B,), dtype=F32, device=dev)
    track = torch.empty((nbr * B,), dtype=F32, device=dev)
    nrej = torch.empty((nbr,), dtype=torch.int32, device=dev)
    code = lib.hb_sweep_s_tiled(
        tiles.data_ptr(), cols_i.data_ptr(), valid_i.data_ptr(), nbr, K, B, R,
        spec.model_index, spec.n_fold, int(guard), float(n), float(spec.vary),
        Pc.data_ptr(), r.data_ptr(), dg.data_ptr(), track.data_ptr(),
        nrej.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, code, "sweep_s_tiled")
    sweep_s_tiled.launches += 1
    return dg, track.to(torch.int32), r, nrej.sum()


sweep_s_tiled.launches = 0
