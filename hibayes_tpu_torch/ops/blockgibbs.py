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

Two kernels carry phase B (csrc/blockgibbs.cu):

* ``block_draws``: the B draws of one block for K chains, given r0
  (replaces ``_s_block_draws``/``_kernel_s_block_t``);
* ``sweep_mc``: the fused K-chain sweep over a range of blocks, with X int8
  or f32 (replaces ``sweep_mc_t``, ``sweep_mc_ti`` and ``sweep_mc_tc``).

Each has a plain PyTorch version with the same contract
(``block_draws_plain``, ``sweep_mc_plain``): loops over blocks and SNPs in
Python with tensor ops across the K chains, in any float dtype.  A wrapper
takes its plain version only for tensors on the CPU; for CUDA tensors it
launches the kernel or raises.  Each wrapper counts its own launches in a
plain integer attribute (``sweep_mc.launches``, ``block_draws.launches``),
and each plain version its calls (``.calls``).  The library counts every
launch of each CUDA kernel where it is made (:func:`kernel_launches`): a
sweep over nbg blocks launches ``rows_kernel`` nbg + 1 times and
``draws_kernel`` nbg times.
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


def _draws_plain(spec, P_b, W_b, r0):
    """B sequential draws: P_b (B, R, K), W_b (B, B), r0 (B, K).
    Returns (gi, dg, track), each (B, K).

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
    r = r0 + P_b[:, 0]
    rv = r.unbind(0)                                  # views, see the updates
    wcols = W_b.unsqueeze(2).unbind(0)                # (B, 1): W_b[j, :]
    gis, dgs, trs = [], [], []
    for j in range(r0.shape[0]):
        g_j, t_j = draw_from_vals(mi, nf, [row[j] for row in rows], rv[j], consts)
        d_j = rows[1][j] - g_j
        r.addcmul_(wcols[j], d_j)
        gis.append(g_j)
        dgs.append(d_j)
        trs.append(t_j)
    track = (torch.zeros_like(r0) if trs[0] is None
             else torch.stack(trs).to(dt))
    return torch.stack(gis), torch.stack(dgs), track


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
    counted in the library where each kernel is launched."""
    rows, draws = ctypes.c_longlong(), ctypes.c_longlong()
    build.library().hb_launch_counts(ctypes.byref(rows), ctypes.byref(draws))
    return {"rows_kernel": rows.value, "draws_kernel": draws.value}


def reset_kernel_launches() -> None:
    build.library().hb_reset_launch_counts()


def _require_cuda(*tensors):
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"expected a CUDA tensor, got one on {t.device}")
        if t.device != tensors[0].device:
            raise ValueError("tensors on different devices")


def block_draws_plain(spec, logpi_row, P_b, W_b, r0):
    """Plain version of :func:`block_draws`, in the dtype of ``r0``."""
    block_draws_plain.calls += 1
    _, dg, track = _draws_plain(spec, P_b.to(r0.dtype), W_b.to(r0.dtype), r0)
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
        gi, dg, tr = _draws_plain(spec, P_blocks[b], W_blocks[off + b].to(dt),
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
