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
  or f32 (replaces ``sweep_mc_t``, ``sweep_mc_ti`` and ``sweep_mc_tc``, and
  ``sweep_mc`` / ``_kernel_mc``: at K >= 2 its rows kernel reads each tile
  of X once for all chains).

The JAX engine also has two single-chain sweeps for when no transposed
kernel fits the TPU's VMEM: ``sweep`` / ``_kernel`` (the X block resident)
and ``sweep_chunked`` / ``_kernel_chunked`` (X streamed in chunks of 2,048
rows).  Their layouts are VMEM choices; here ``sweep_mc`` streams X in row
tiles for any n, so their counterpart is ``sweep_mc`` at K = 1: the port's
``one_iteration`` always sweeps through it (``_run_sweep_k1``) and has no
fallback branch.  tests/test_torch_k5.py holds both TPU kernels to it.

Two carry the summary-level (sbrm) sweep (csrc/sgibbs.cu), whose state is
r_hat instead of a residual:

* ``sweep_s_segment``: one dense LD segment for one or K chains (replaces
  ``sweep_s_segment`` / ``_kernel_s``, and ``sweep_s_segment_t`` with its
  draws ``_kernel_s_block_t`` for K chains);
* ``sweep_s_tiled``: every tile row of a tiled sparse LD, with the SBayesS
  rejection guard, for one or K chains (replaces ``sweep_s_tiled`` /
  ``_kernel_s_tiled``, and the vmapped scan of the JAX package's tiled
  batches).

One carries the single-step (ssbrm) epsilon sweep (csrc/mme.cu):

* ``mme_sweep``: the T sequential site draws of every diagonal block of
  scale A + diag(counts) and each block's forward scatter, in one launch
  for one or K chains (replaces ``mme_block_draws`` / ``_kernel_mme_block``
  with the scan around it); ``mme_block_draws_plain`` keeps the TPU
  kernel's one-block contract.

Each has a plain PyTorch version with the same contract (``*_plain``):
loops over blocks and SNPs in Python with tensor ops (across the K chains
for the individual-level ones), in any float dtype.  A wrapper takes its
plain version only for tensors on the CPU; for CUDA tensors it launches the
kernel or raises.  Each wrapper counts its own launches in a plain integer
attribute (``.launches``), and each plain version its calls (``.calls``);
each call of a wrapper, card route or plain version, is a span
``ops.<wrapper>`` (utils/profiling.py) while a profiler records.
The libraries count every launch of each CUDA kernel where it is made
(:func:`kernel_launches`): a one-chain sweep over nbg blocks is one
persistent ``sweep1`` launch (:func:`sweep1_plan`); a K-chain sweep (K >= 2)
launches ``rows_mc_kernel`` nbg + 1 times and ``draws_kernel`` nbg times;
``block_draws`` launches ``draws_kernel`` once; a segment sweep, one or K
chains, ``segment_sweep`` once (one persistent launch, :func:`segment_plan`);
a tiled sweep, one or K chains, ``tiled_sweep`` once (one persistent
launch for every tile row, in the order of :func:`tiled_schedule`); an
epsilon sweep, one or K chains, ``mme_sweep_kernel`` once (ordered by
:func:`mme_plan`).
"""

from __future__ import annotations

import ctypes
import weakref
from dataclasses import dataclass, field

import numpy as np
import torch

from ..math.distributions import inv_gaussian_from
from ..utils.profiling import count, spanned
from . import build

F32 = torch.float32
NEG_BIG = -1e30
POS_BIG = 1e30
MAX_BLOCK = 128   # SNPs of a kernel's block (csrc/draws.cuh kMaxBlock): wider blocks run as sub-blocks
H100_SMS = 132    # SMs of the card whose limits choose the kernels' width, on every device
MIN_TILE_ROWS = 128  # least rows of a one-chain row tile (32 row classes x 4)
MC_CHUNK_ROWS = 32   # rows_mc_kernel tiles are a multiple of this (chunks of 32 or 64 rows)
MC_CHAINS = 64       # chains a rows_mc_kernel CTA serves (csrc/blockgibbs.cu kMcChains)
N_RETRY = 8       # pre-drawn candidates of the rejection guard (csrc/draws.cuh kRetry)
S1_THREADS = 256     # threads of a sweep1_kernel CTA (csrc/blockgibbs.cu kS1Threads)
S1_CLASSES = 32      # row classes of a one-chain row tile (kS1Classes)
SMEM_OPTIN = 232_448  # shared memory a CTA may take on an H100 (227 KB)


def padded_stride(r: int) -> int:
    """Floats per SNP where the kernels stage ``r`` packed (and guard) rows
    in shared memory: ``r`` rounded up to 4, so a draw reads its rows as
    float4 (csrc/draws.cuh padded_stride)."""
    return -(-r // 4) * 4


def snp_major_rows(rows):
    """The SNP-major copy (K, m, padded_stride(R)) of packed rows given as
    a (K, m, R) view: what the draw chains read in place where one SNP's
    rows do not fit shared memory (``SubBlocks.rows_global``)."""
    K, m, R = rows.shape
    Pg = torch.zeros((K, m, padded_stride(R)), dtype=F32, device=rows.device)
    Pg[..., :R] = rows
    return Pg


def snp_owner(j: int) -> tuple:
    """(lane, slot) of the warp that holds SNP ``j``'s r_local, Gram-row
    slice and outputs in the draw chain (csrc/draws.cuh warp_block_draws):
    lane l owns SNPs 4l .. 4l + 3, so a Gram row is one 16-byte load a
    lane."""
    return j // 4, j % 4


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
    s2varg_df = consts_b["s2varg_df"].to(dt)[:, None]

    def cond_coeffs(varg):
        v = x + ve / varg
        inv_v = torch.where(act, 1.0 / v, 0.0)
        sz = torch.where(act, torch.sqrt(ve / v) * z, 0.0)
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
        thresh = torch.where(act, thresh, POS_BIG)
        rows = [rg, g, inv_v, sz, thresh]
    elif mi == 5:
        v = x + 1.0 / vargL_b.to(dt)
        inv_v = torch.where(act, 1.0 / v, 0.0)
        sz = torch.where(act, torch.sqrt(ve / v) * z, 0.0)
        rows = [rg, g, inv_v, sz]
    else:  # BayesR: Gumbel-max fold draw, the Gumbels folded into A_f
        ut = torch.clamp_min(u_b.to(dt).transpose(1, 2), 1e-12)  # (K, nf, m)
        gum = -torch.log(-torch.log(ut))
        logpi = consts_b["logpi"].to(dt)
        vara_fold = consts_b["vara_fold"].to(dt)
        rows = [rg, g]
        for f in range(1, spec.n_fold):
            vara_f = torch.clamp_min(vara_fold[:, f], 1e-30)[:, None]
            vf = x + ve / vara_f
            A_f = -0.5 * torch.log(vara_f * x / ve + 1.0) + logpi[:, f, None]
            A_f = torch.where(act, A_f + gum[:, f], NEG_BIG)
            B_f = 0.5 / (vf * ve)
            ivf = torch.where(act, 1.0 / vf, 0.0)
            szf = torch.where(act, torch.sqrt(ve / vf) * z, 0.0)
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
    act = (vx > 0)[None, :]
    if mi == 4:
        vargi_acc = torch.where(track == 1, g_new * g_new, 0.0).sum(dim=1)
    else:
        vargi_acc = torch.zeros((K,), dtype=dt, device=g_new.device)
    if mi == 6:
        ffold = torch.gather(consts_b["fold"].to(dt), 1, track.long())
        vargR_acc = torch.where(
            track > 0, g_new * g_new / torch.clamp_min(ffold, 1e-30), 0.0
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
    rejected, the (K,) mask of draws whose every candidate failed)."""
    vxj = p[base]
    on = track > 0
    rej = (gi * gi * vxj > vary) & on
    first = rej
    if not bool(rej.any()):   # the retries would leave every gi as it is
        return gi, first, rej
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
    return torch.where(rej, torch.zeros_like(gi), gi), first, rej


def _draws_plain(spec, P_b, W_b, r0, vary=None, counts=None):
    """B sequential draws: P_b (B, R, K), W_b (B, B), r0 (B, K).  With
    ``vary`` (a 0-d tensor), the rejection guard follows each draw and P_b
    carries the guard rows.  Returns (gi, dg, track), each (B, K);
    ``counts`` (optional, (K, 2) int64) gets per chain the draws whose first
    candidate the guard rejected and the ones whose every candidate failed
    added.

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
    for j in range(r0.shape[0]):
        p_j = [row[j] for row in rows]
        g_j, t_j = draw_from_vals(mi, nf, p_j, rv[j], consts)
        if vary is not None:
            g_j, first, exhausted = guard_draw(mi, nf, base, p_j, rv[j], g_j, t_j, vary)
            if counts is not None and bool(first.any()):
                counts += torch.stack([first, exhausted], dim=1)
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


# ---------------------------------------------------------------------------
# sub-blocks: the width the kernels see, for any block, fold count and tile
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SubBlocks:
    """How the sweeps run a block of B SNPs (a tile of B, for tiled LD): as
    S consecutive sub-blocks of W SNPs, W <= MAX_BLOCK a multiple of 4 and
    S W >= B, the S W - B slots after the block's last SNP inert (zero
    genotype, Gram or LD; packed rows that draw 0, :func:`inert_rows`).

    The blocked update is exact for any blocking
    (hibayes_tpu/engine/gibbs.py:10-21): sub-block s starts from the
    residual (or r_hat) after sub-block s - 1, so every SNP draws from the
    same numbers in the same order as in the block of B; only the rounding
    of the corrections differs.  The spec's block keeps setting m_pad, the
    block count, the packing and every output's shape: only the width the
    kernels see changes.  The choice depends on B and the rows a SNP alone
    (:func:`kernel_width`), so the plain versions on the CPU run the route
    the card runs.  S = 1 and W = B where the kernels take B as it is.
    ``rows_global``: the kernel's draws read the packed rows from global
    memory (one SNP's rows overflow shared memory even at 4 SNPs)."""

    B: int
    S: int
    W: int
    rows_global: bool = False

    @classmethod
    def of(cls, B: int, W: int) -> "SubBlocks":
        """The sub-blocks of width W of a block of B (the fewest that hold
        it: :func:`kernel_width` never picks more)."""
        return cls(B, -(-B // W), W)

    @property
    def same(self) -> bool:
        return self.S == 1 and self.W == self.B

    @property
    def span(self) -> int:
        return self.S * self.W

    def spread(self, t, fill=0.0):
        """Per-SNP values (..., nb B) in the kernels' layout (..., nb S W),
        the pad slots set to ``fill`` (a number, or a tensor that broadcasts
        over (..., nb, S W - B), e.g. (R, 1, 1) a packed row)."""
        if self.span == self.B:
            return t
        lead, nb = tuple(t.shape[:-1]), t.shape[-1] // self.B
        out = torch.empty(lead + (nb, self.span), dtype=t.dtype, device=t.device)
        out[..., self.B:] = fill
        out[..., :self.B] = t.reshape(lead + (nb, self.B))
        return out.reshape(lead + (nb * self.span,))

    def gather(self, t):
        """The inverse of :meth:`spread`: the real slots of (..., nb S W)."""
        if self.span == self.B:
            return t
        lead, nb = tuple(t.shape[:-1]), t.shape[-1] // self.span
        return t.reshape(lead + (nb, self.span))[..., :self.B].reshape(lead + (nb * self.B,))


def kernel_width(B: int, fits, what: str, fits_global=None) -> SubBlocks:
    """The sub-blocks of a block of B: the fewest sub-blocks S (from
    ceil(B / MAX_BLOCK) up) of W = ceil(B / S) rounded up to 4 for which
    ``fits(W)`` (the kernel's shared memory at W, from the H100's limits).
    A block of at most MAX_BLOCK that is a multiple of 4 and fits stays as
    it is.  Where not even 4 SNPs a sub-block fit (BayesR with hundreds of
    folds), the kernel's draws read the packed rows from global memory
    (through L2): the fewest sub-blocks for which ``fits_global(W)``, the
    kernel's shared memory without the rows, with ``rows_global`` set.
    Raises only for a kernel without that mode (``fits_global`` None)."""
    S0 = max(1, -(-B // MAX_BLOCK))
    for test, flag in ((fits, False), (fits_global, True)):
        if test is None:
            continue
        S = S0
        while True:
            W = -(-B // S)
            W += -W % 4
            if test(W):
                return SubBlocks(B, S, W, flag)
            if W <= 4:
                break
            S += 1
    raise ValueError(f"{what}: the packed rows of one SNP do not fit the kernel's "
                     "shared memory even at sub-blocks of 4 SNPs")


def inert_rows(spec, rows: int, dtype, device) -> torch.Tensor:
    """Packed-row values (rows,) of a pad slot: g 0 whatever its residual
    (RR/A/L: inv_v = sd = 0; B/C: the threshold POS_BIG; R: every fold's
    logit NEG_BIG under the fold-0 logit 0), and guard rows of zeros (vx =
    0: never rejected)."""
    v = torch.zeros((rows,), dtype=dtype, device=device)
    mi = spec.model_index
    if mi in (3, 4):
        v[4] = POS_BIG
    elif mi == 6:
        v[2:2 + 4 * (spec.n_fold - 1):4] = NEG_BIG
    return v


def _spread_rows(spec, sb, P):
    """Packed rows (..., R, nb B) in the kernels' layout, pads inert."""
    if sb.span == sb.B:
        return P
    fill = inert_rows(spec, P.shape[-2], P.dtype, P.device)
    return sb.spread(P, fill[:, None, None])


def draws_smem(B: int, R: int) -> int:
    """Shared memory bytes of a draws_kernel CTA (csrc/blockgibbs.cu
    draws_smem): the Gram block, the packed rows at padded_stride (R 0:
    read from global memory) and eight warps' sums."""
    return 4 * (B * B + B * padded_stride(R) + 8 * B)


def tiled_smem(B: int, R: int, stage_next: bool = False, rows_smem: bool = True) -> int:
    """Shared memory bytes of a tiled-sweep CTA (csrc/sgibbs.cu tiled_smem):
    without the packed rows where the draws read them from global memory."""
    return 4 * (8 + 11 * MAX_BLOCK + B * B * (3 if stage_next else 2)
                + (2 * B * padded_stride(R) if rows_smem else 0))


def mc_fits(R: int, n: int, W: int, xbytes: int, rows_smem: bool = True) -> bool:
    """Whether the individual-level sweeps take sub-blocks of W SNPs of R
    packed rows over n rows of X of ``xbytes`` bytes: W <= MAX_BLOCK a
    multiple of 4, and the one-chain sweep's plan (:func:`sweep1_plan`)
    and the K-chain draws both fit at W, the rows in shared memory or
    (``rows_smem`` False) read from global memory."""
    if W > MAX_BLOCK or W % 4:
        return False
    try:
        sweep1_plan(n, W, R, xbytes, H100_SMS, rows_smem=rows_smem)
    except ValueError:
        return False
    return draws_smem(W, R if rows_smem else 0) <= SMEM_OPTIN


def mc_sub_blocks(R: int, n: int, B: int, xbytes: int) -> SubBlocks:
    """The sub-blocks in which ``prepare_gibbs_data`` lays out a genotype in
    blocks of B (:func:`mc_fits` at R rows a SNP, or the rows read from
    global memory where a SNP's rows overflow shared memory at 4 SNPs)."""
    return kernel_width(B, lambda W: mc_fits(R, n, W, xbytes), "sweep_mc",
                        lambda W: mc_fits(R, n, W, xbytes, rows_smem=False))


def genotype_rows(n_fold: int) -> int:
    """The most packed rows a SNP of any model with ``n_fold`` folds (BayesR's
    at n_fold >= 2): the rows by which a genotype's layout is chosen, so
    that every model's sweeps take it."""
    return max(5, 3 + 4 * (max(n_fold, 2) - 1))


def mc_layout(spec, X_blocks) -> SubBlocks:
    """The sub-blocks of a genotype X (nb S, n, W) laid out for blocks of
    spec.block (``prepare_gibbs_data``, :func:`sub_block_genotype`); raises
    where the sweeps do not take W at the spec's rows."""
    _, n, W = X_blocks.shape
    sb = SubBlocks.of(spec.block, W)
    R, xb = n_rows(spec), X_blocks.element_size()
    if mc_fits(R, n, W, xb):
        return sb
    if not mc_fits(R, n, W, xb, rows_smem=False) or mc_fits(R, n, 4, xb):
        raise ValueError(
            f"sweep_mc: a genotype of width {W} for blocks of {spec.block} is not one the "
            f"kernels take at {R} packed rows a SNP: lay it out with prepare_gibbs_data or "
            "sub_block_genotype")
    return SubBlocks(sb.B, sb.S, W, rows_global=True)


def segment_sub_blocks(spec, B: int) -> SubBlocks:
    """The segment sweep's sub-blocks: a drawer CTA of one chain fits at W,
    the packed rows staged in shared memory, or else read from global
    memory."""
    RP = padded_stride(summary_rows(spec))
    return kernel_width(B, lambda W: max(segment_smem(W, RP, 1, 4, 1, W)) <= SMEM_OPTIN,
                        "sweep_s_segment",
                        lambda W: max(segment_smem(W, 0, 1, 4, 1, W)) <= SMEM_OPTIN)


def tiled_sub_blocks(spec, B: int) -> SubBlocks:
    """The tiled sweep's tiles: its CTA fits at tiles of W, the packed rows
    staged in shared memory, or else read from global memory."""
    R = summary_rows(spec)
    return kernel_width(B, lambda W: tiled_smem(W, R) <= SMEM_OPTIN, "sweep_s_tiled",
                        lambda W: tiled_smem(W, R, rows_smem=False) <= SMEM_OPTIN)


# the kernels' layout of each segment and tile store (by the identity and
# version of its tensors): made at the first sweep over it and kept for the
# sweeps after it; an entry goes with any of its tensors
_LAYOUTS = {}


def _layout(tensors, sb: SubBlocks, make):
    key = tuple(id(t) for t in tensors) + (sb,)
    versions = tuple(t._version for t in tensors)
    hit = _LAYOUTS.get(key)
    if hit is not None and all(r() is t for r, t in zip(hit[0], tensors)) and hit[1] == versions:
        return hit[2]
    out = make()
    _LAYOUTS[key] = (tuple(weakref.ref(t) for t in tensors), versions, out)
    for t in tensors:
        weakref.finalize(t, _LAYOUTS.pop, key, None)
    return out


def sub_block_genotype(X_blocks, W_blocks, sb: SubBlocks) -> tuple:
    """A genotype in blocks of B (nb, n, B) and its Gram blocks (nb, B, B)
    in the sweeps' layout, as ``prepare_gibbs_data`` makes it: (nb S, n, W)
    and each sub-block's diagonal Gram block (nb S, W, W), the pad columns
    zero.  The inputs themselves where S = 1 and W = B; else a copy (for a
    genotype made elsewhere, e.g. the JAX package's)."""
    if sb.same:
        return X_blocks, W_blocks
    nb, n, B = X_blocks.shape
    Xk = torch.zeros((nb * sb.S, n, sb.W), dtype=X_blocks.dtype, device=X_blocks.device)
    Wk = torch.zeros((nb * sb.S, sb.W, sb.W), dtype=W_blocks.dtype, device=W_blocks.device)
    Xv, Wv = Xk.view(nb, sb.S, n, sb.W), Wk.view(nb, sb.S, sb.W, sb.W)
    for s in range(sb.S):
        c0, c1 = s * sb.W, min(B, (s + 1) * sb.W)
        Xv[:, s, :, :c1 - c0] = X_blocks[:, :, c0:c1]
        Wv[:, s, :c1 - c0, :c1 - c0] = W_blocks[:, c0:c1, c0:c1]
    return Xk, Wk


def cross_gram_batch(Xf, prev=None):
    """The cross-Grams X_k' X_{k-1} (nb, W, W) of a batch of consecutive
    kernel blocks Xf (nb, n, W), the first against ``prev`` (n, W), the
    block before the batch, or zero where there is none (the first block of
    a genotype or of a shard), in the dtype of Xf."""
    C = torch.empty((Xf.shape[0],) + (Xf.shape[2],) * 2, dtype=Xf.dtype, device=Xf.device)
    C[0] = 0.0 if prev is None else Xf[0].T @ prev
    if Xf.shape[0] > 1:
        torch.bmm(Xf[1:].transpose(1, 2), Xf[:-1], out=C[1:])
    return C


def cross_grams(X_blocks, dtype=F32, batch_bytes: int = 1 << 30):
    """C (nb S, W, W), C[k] = X_k' X_{k-1} over consecutive kernel blocks of
    a genotype in the sweeps' layout (C[0] zero), in ``dtype``, cast in
    batches of at most ``batch_bytes`` (``prepare_gibbs_data`` makes the
    same as ``GibbsData.C_blocks``).  Made once per genotype tensor for a
    one-chain sweep called without them (:func:`_layout`)."""
    def make():
        nbk, n, W = X_blocks.shape
        per = max(1, batch_bytes // (n * W * torch.finfo(dtype).bits // 8) - 1)
        C = torch.empty((nbk, W, W), dtype=dtype, device=X_blocks.device)
        prev = None
        for b0 in range(0, nbk, per):
            Xf = X_blocks[b0:b0 + per].to(dtype)
            C[b0:b0 + per] = cross_gram_batch(Xf, prev)
            prev = Xf[-1]
        return C

    return _layout((X_blocks,), ("cross", dtype), make)


def sub_block_segment(LD_seg, sb: SubBlocks):
    """A dense LD segment (nb B, nb B) in the kernels' layout (nb S W, nb S
    W), pad rows and columns zero: the segment itself where S W = B (its
    blocks of B are then S blocks of W as stored); else a copy made once."""
    if sb.span == sb.B:
        return LD_seg

    def make():
        nb = LD_seg.shape[0] // sb.B
        out = torch.zeros((nb * sb.span,) * 2, dtype=LD_seg.dtype, device=LD_seg.device)
        out.view(nb, sb.span, nb, sb.span)[:, :sb.B, :, :sb.B] = LD_seg.view(nb, sb.B, nb, sb.B)
        return out

    return _layout((LD_seg,), sb, make)


def sub_block_tiles(tiles, cols, valid, sb: SubBlocks) -> tuple:
    """A tile store of tiles of B (nbr, K, B, B) re-tiled into tiles of W:
    (nbr S, K S, W, W) with cols and valid (nbr S, K S).  Tile row (i, a)
    (rows a W .. a W + W - 1 of row i) takes sub-tile (a, b) of each slot k
    of row i, in slot order with its diagonal sub-tile (a, a) first, at
    block cols[i, k] S + b, valid as the slot; invalid slots point at their
    own row.  The same SNP order, the same LD entries; pad rows and columns
    zero.  Made once per store (:func:`_layout`)."""
    if sb.same:
        return tiles, cols, valid

    def make():
        nbr, K, B, _ = tiles.shape
        S, W, span = sb.S, sb.W, sb.span
        dev = tiles.device
        if span != B:
            tp = torch.zeros((nbr, K, span, span), dtype=tiles.dtype, device=dev)
            tp[:, :, :B, :B] = tiles
        else:
            tp = tiles
        t6 = tp.view(nbr, K, S, W, S, W)
        out = torch.empty((nbr, S, K * S, W, W), dtype=tiles.dtype, device=dev)
        c = cols.to(device=dev, dtype=torch.int64)
        v = valid.to(device=dev, dtype=torch.bool)
        own = torch.arange(nbr, device=dev)[:, None] * S
        cols_k = torch.empty((nbr, S, K * S), dtype=torch.int64, device=dev)
        valid_k = torch.empty((nbr, S, K * S), dtype=torch.bool, device=dev)
        for a in range(S):
            slots = [(0, a)] + [(k, b) for k in range(K) for b in range(S) if (k, b) != (0, a)]
            for q, (k, b) in enumerate(slots):
                out[:, a, q] = t6[:, k, a, :, b, :]
                valid_k[:, a, q] = v[:, k]
                cols_k[:, a, q] = torch.where(v[:, k], c[:, k] * S + b, own[:, 0] + a)
        return (out.reshape(nbr * S, K * S, W, W).contiguous(),
                cols_k.reshape(nbr * S, K * S).to(cols.dtype),
                valid_k.reshape(nbr * S, K * S).to(valid.dtype))

    return _layout((tiles, cols, valid), sb, make)


def tile_row_runs(tiles, cols, valid, runs: int) -> tuple:
    """A tile store's rows in ``runs`` contiguous runs of equal length, each
    (tiles, cols, valid) views of the store, made once per store
    (:func:`_layout`): the tiled sweep keeps its schedule per cols tensor,
    so a sweep over each run finds it from the second sweep on."""
    nl = tiles.shape[0] // runs

    def make():
        return tuple(tuple(t[r * nl:(r + 1) * nl] for t in (tiles, cols, valid))
                     for r in range(runs))

    return _layout((tiles, cols, valid), ("runs", runs), make)


def _chain_groups(C: int, G: int) -> list:
    """Slices of C chains, in order, in the fewest groups of at most G,
    their sizes at most one apart: a launch of fewer drawers leaves more
    SMs to the CTAs that serve them."""
    ng = -(-C // max(1, G))
    size, extra = divmod(C, ng)
    ends = [(g + 1) * size + min(g + 1, extra) for g in range(ng)]
    return [slice(a, b) for a, b in zip([0] + ends[:-1], ends)]


def rows_per_tile(n: int, device, K: int = 1) -> int:
    """Rows of n per row tile of the sweep (``device`` a CUDA device, or its
    SM count).  One chain: about one tile per SM but the drawer's, so every
    other SM takes part in each block's row work and the drawer, which owns
    no tile, keeps W, C and the packed rows in its shared memory (a chain's
    partial sums follow the tiling).  The K-chain kernel's tiles, about one
    per SM, are a multiple of MC_CHUNK_ROWS rows and the same for every
    K >= 2, so that they do not depend on K."""
    sms = (device if isinstance(device, int)
           else torch.cuda.get_device_properties(device).multi_processor_count)
    if K == 1:
        return max(MIN_TILE_ROWS, -(-n // max(sms - 1, 1)))
    return -(-n // (sms * MC_CHUNK_ROWS)) * MC_CHUNK_ROWS


def rows_mc_shape(K: int, tile: int) -> tuple:
    """Register-tile shape (TK, TR, RB, TC) of the K-chain rows kernel for a
    batch of K >= 2 chains over tiles of ``tile`` rows (csrc/blockgibbs.cu
    rows_mc_kernel): a warp's residual task is TK chains x TR rows a lane
    (RB row blocks of 32 TR rows in a chunk), its partial task TK chains x
    TC columns a lane.  At K <= 4 a task is one chain and half the chunk's
    rows or columns, so every warp has work; above, TK is the power of two
    that gives each of the 8 warps one block of chains, two rows a lane (one
    when a tile holds at most 32 rows).  The shape decides which thread
    sums what, never the order of a sum."""
    kc = min(K, MC_CHAINS)
    one = tile <= MC_CHUNK_ROWS
    if kc <= 4:
        return (1, 1, 1 if one else 2, 2)
    tk = next(t for t in (1, 2, 4, 8) if 8 * t >= kc)
    return (tk, 1 if one else 2, 1, 4)


def sweep1_tiles(c: int, grid: int, ntiles: int) -> range:
    """Row tiles that CTA ``c`` of a one-chain sweep of ``grid`` CTAs owns
    for the whole sweep: t = c - 1 (mod grid).  CTA 0, the drawer, owns the
    tiles the other CTAs leave (csrc/blockgibbs.cu sweep1_kernel)."""
    return range((c + grid - 1) % grid, ntiles, grid)


def sweep1_smem(B: int, R: int, rpt: int, xbytes: int, T: int, nb: int, drawer: bool,
                wb: int = 2, rows_smem: bool = True, cb: int = 1) -> int:
    """Shared memory bytes of a sweep1_kernel CTA (csrc/blockgibbs.cu
    s1_layout): the drawer's three mbarriers, ``wb`` buffers of W and
    ``cb`` of C, the packed rows double-buffered at padded_stride, seven
    warps' sums, dg and the next right-hand side; for T row tiles of
    ``rpt`` rows, yadj and u of its rows (each padded to 4 floats), dg of
    the block before, the 32 row classes' sums and ``nb`` X tile buffers a
    tile."""
    RS = padded_stride(R) if rows_smem else 0
    draw = 4 * (8 + (wb + cb) * B * B + 2 * B * RS + 9 * B) if drawer else 0
    yu = -(-(T * rpt) // 4) * 4
    rows = 4 * (2 * yu + (S1_CLASSES + 1) * B) + T * nb * rpt * B * xbytes if T > 0 else 0
    return draw + rows


def sweep1_plan(n: int, B: int, R: int, xbytes: int, sms: int,
                optin: int = SMEM_OPTIN, rows_smem: bool = True) -> dict:
    """The persistent one-chain sweep's launch: its row tiles
    (:func:`rows_per_tile` at K = 1: about one per SM but the drawer's), a
    grid of one CTA per tile plus the drawer, at most one CTA per SM (every
    CTA must be resident); and how many X buffers each tile gets in shared
    memory (``nbr`` for the other CTAs' tiles, ``nb0`` for the drawer's,
    where it owns any): 3 holds X_{b-1}, X_b and X_{b+1} (step b's
    correction's, the next correction's and its partials'), 1 holds X_{b-1}
    and reads X_{b+1} from global memory after an L2 prefetch, 0 reads both
    from global memory.  The drawer keeps two buffers of W (``wb``: W_{b+1}
    lands under block b's chain) and one of the cross-Gram C (``cb``:
    C_{b+1} lands there too), in that order of preference, where they fit
    beside its own tiles' X; else W_{b+1} lands after the chain and C is
    read from L2.  ``rows_smem`` False: the drawer reads the packed rows
    from global memory.  Returns rpt, ntiles, grid, nb0, nbr, wb, cb and
    smem (bytes a CTA)."""
    rpt = rows_per_tile(n, sms, 1)
    ntiles = -(-n // rpt)
    grid = min(1 + ntiles, sms)
    t0 = len(sweep1_tiles(0, grid, ntiles))
    tc = len(sweep1_tiles(1, grid, ntiles)) if grid > 1 else 0
    def fits(T, nb, drawer, wb=2, cb=1):
        return sweep1_smem(B, R, rpt, xbytes, T, nb, drawer, wb, rows_smem, cb) <= optin

    nbr = next((nb for nb in (3, 1) if fits(tc, nb, False)), 0)
    options = [(nb, wb, cb) for nb in ((3, 1, 0) if t0 else (0,)) for wb in (2, 1)
               for cb in (1, 0)]
    nb0, wb, cb = next((o for o in options if fits(t0, o[0], True, o[1], o[2])), options[-1])
    smem = max(sweep1_smem(B, R, rpt, xbytes, t0, nb0, True, wb, rows_smem, cb),
               sweep1_smem(B, R, rpt, xbytes, tc, nbr, False) if grid > 1 else 0)
    if smem > optin:
        raise ValueError(f"sweep_mc: a one-chain sweep at n={n}, B={B} needs {smem} bytes "
                         f"of shared memory a CTA, more than the {optin} the card has")
    return {"rpt": rpt, "ntiles": ntiles, "grid": grid, "nb0": nb0, "nbr": nbr, "wb": wb,
            "cb": cb, "smem": smem}


# the flags of the one-chain sweep on each device: 1 + ntiles unsigned
# counters (dg published; each tile's partials) whose values run on across
# sweeps, and the next sweep's epoch (it publishes epoch + 1 .. epoch + nbg)
_SWEEP1_FLAGS = {}


def _sweep1_flags(dev, ntiles: int) -> dict:
    st = _SWEEP1_FLAGS.get(str(dev))
    if st is None or st["flags"].numel() < 1 + ntiles:
        st = {"flags": torch.zeros(1 + max(ntiles, 256), dtype=torch.int32, device=dev),
              "epoch": 0}
        _SWEEP1_FLAGS[str(dev)] = st
    return st


def kernel_launches() -> dict:
    """Launches of each CUDA kernel since :func:`reset_kernel_launches`,
    counted in the libraries where each kernel is launched."""
    sweep1, rows_mc, draws = ctypes.c_longlong(), ctypes.c_longlong(), ctypes.c_longlong()
    build.library().hb_launch_counts(ctypes.byref(sweep1), ctypes.byref(rows_mc),
                                     ctypes.byref(draws))
    s = (ctypes.c_longlong * 2)()
    build.library("sgibbs.cu").hb_s_launch_counts(s)
    e = ctypes.c_longlong()
    build.library("mme.cu").hb_mme_launch_counts(ctypes.byref(e))
    return {"sweep1": sweep1.value, "rows_mc_kernel": rows_mc.value,
            "draws_kernel": draws.value, "segment_sweep": s[0],
            "tiled_sweep": s[1], "mme_sweep_kernel": e.value}


def reset_kernel_launches() -> None:
    build.library().hb_reset_launch_counts()
    build.library("sgibbs.cu").hb_s_reset_launch_counts()
    build.library("mme.cu").hb_mme_reset_launch_counts()


def _require_cuda(*tensors):
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"expected a CUDA tensor, got one on {t.device}")
        if t.device != tensors[0].device:
            raise ValueError("tensors on different devices")


def _sub_block_draws(spec, P_b, W_b, r0, sb: SubBlocks, draw):
    """One block's B draws for K chains as ``sb``'s sub-blocks: sub-block
    s draws (``draw(P_s, W_ss, r_s)`` -> (dg, track), each (W, K)) from
    r_s = r0_s + W[s, :s] dg[:s], the corrections of every earlier
    sub-block, as the block's own draws add them one by one."""
    B, K = r0.shape
    dt, dev, span, W = r0.dtype, r0.device, sb.span, sb.W
    Pp = inert_rows(spec, P_b.shape[1], P_b.dtype, dev)[None, :, None].repeat(span, 1, K)
    Pp[:B] = P_b
    Wp = torch.zeros((span, span), dtype=W_b.dtype, device=dev)
    Wp[:B, :B] = W_b
    rp = torch.zeros((span, K), dtype=dt, device=dev)
    rp[:B] = r0
    dg = torch.empty((span, K), dtype=dt, device=dev)
    track = torch.empty((span, K), dtype=dt, device=dev)
    for s in range(sb.S):
        sl = slice(s * W, (s + 1) * W)
        r_s = rp[sl] if s == 0 else rp[sl] + Wp[sl, :s * W].to(dt) @ dg[:s * W]
        dg[sl], track[sl] = draw(Pp[sl].contiguous(), Wp[sl, sl].contiguous(), r_s.contiguous())
    return dg[:B], track[:B]


def block_sub_blocks(spec, B: int) -> SubBlocks:
    """:func:`block_draws`' sub-blocks: the draws kernel fits at W, the
    packed rows staged in shared memory, or else read from global memory."""
    R = n_rows(spec)
    return kernel_width(B, lambda W: draws_smem(W, R) <= SMEM_OPTIN, "block_draws",
                        lambda W: draws_smem(W, 0) <= SMEM_OPTIN)


def block_draws_plain(spec, logpi_row, P_b, W_b, r0):
    """Plain version of :func:`block_draws`, in the dtype of ``r0``, by the
    same sub-blocks."""
    block_draws_plain.calls += 1
    dt = r0.dtype
    draw = lambda P, W, r: _draws_plain(spec, P.to(dt), W.to(dt), r)[1:]
    sb = block_sub_blocks(spec, r0.shape[0])
    if sb.same:
        return draw(P_b, W_b, r0)
    return _sub_block_draws(spec, P_b, W_b, r0, sb, draw)


block_draws_plain.calls = 0


def _block_draws_launch(spec, P_b, W_b, r0, rows_global=False):
    lib = build.library()
    B, K = r0.shape
    R = P_b.shape[1]
    r0t = r0.t().contiguous()
    W = W_b.contiguous()
    P = P_b.contiguous()
    Pg = snp_major_rows(P.permute(2, 0, 1)) if rows_global else None
    dg = torch.empty((B, K), dtype=F32, device=r0.device)
    track = torch.empty((B, K), dtype=F32, device=r0.device)
    code = lib.hb_block_draws(
        r0t.data_ptr(), W.data_ptr(), P.data_ptr(), B, R, K,
        spec.model_index, spec.n_fold, dg.data_ptr(), track.data_ptr(),
        None if Pg is None else Pg.data_ptr(),
        torch.cuda.current_stream(r0.device).cuda_stream)
    build.check(lib, code, "block_draws")
    block_draws.launches += 1
    return dg, track


@spanned("ops.block_draws")
def block_draws(spec, logpi_row, P_b, W_b, r0):
    """(dg, track) of one block of B sequential draws for K chains:
    r0 (B, K) = X_b' yadj, W_b (B, B), P_b (B, R, K) from :func:`pack_rows`.
    ``logpi_row`` (1, K) completes the contract of ``_s_block_draws``; the
    draws read the fold-0 logit from the packed rows, as there.  Any B and
    fold count: a block the kernel does not take as it is runs as
    sub-blocks (:func:`block_sub_blocks`), a launch each."""
    if r0.device.type == "cpu":
        return block_draws_plain(spec, logpi_row, P_b, W_b, r0)
    _require_cuda(r0, W_b, P_b)
    B, K = r0.shape
    R = P_b.shape[1]
    if (tuple(W_b.shape) != (B, B) or tuple(P_b.shape) != (B, R, K)
            or tuple(logpi_row.shape) != (1, K) or R != n_rows(spec) or K < 1):
        raise ValueError("block_draws: inconsistent shapes")
    if r0.dtype != F32 or W_b.dtype != F32 or P_b.dtype != F32:
        raise TypeError("block_draws: the kernel takes float32")
    sb = block_sub_blocks(spec, B)
    if sb.same:
        return _block_draws_launch(spec, P_b, W_b, r0, sb.rows_global)
    return _sub_block_draws(spec, P_b, W_b, r0, sb,
                            lambda P, W, r: _block_draws_launch(spec, P, W, r,
                                                                sb.rows_global))


block_draws.launches = 0


# ---------------------------------------------------------------------------
# sweep_mc: the fused K-chain sweep
# ---------------------------------------------------------------------------


def sweep_blocks(spec, consts_b, X_blocks, W_blocks, xpx, vx, vei_b, g_b, z_b, u_b,
                 chi_b, z2_b, vargL_b, yadj_b, u_vec_b, draws, block_range=None,
                 reduce_r0=None):
    """The block loop of the K-chain sweep with library products, in the
    dtype of ``yadj_b``, by :func:`mc_layout`'s sub-blocks: per kernel
    block r0 = X_b' yadj (then ``reduce_r0(r0)``, e.g. a sum over the ranks
    holding other individuals), ``draws(P_b, W_b, r0)`` -> (g, dg, track),
    each (W, K) (g None where the draws give only dg: then g = g_b - dg),
    and yadj += X_b dg.  At K >= 2 a chain's products are an elementwise
    product and a sum of its own: a matrix product over the chain batch may
    sum in an order that depends on K, and chain k must not depend on the
    other chains.  Returns sweep_mc's outputs."""
    sb = mc_layout(spec, X_blocks)
    off, nbg = block_range if block_range is not None else (0, X_blocks.shape[0] // sb.S)
    dt = yadj_b.dtype
    K = yadj_b.shape[0]
    P = _spread_rows(spec, sb, pack_rows(spec, consts_b, xpx, vx, vei_b, g_b, z_b, u_b,
                                         chi_b, vargL_b, dt))
    Bk, nbk, offk = sb.W, nbg * sb.S, off * sb.S
    P_blocks = to_block_layout(P, nbk, Bk)
    yadj = yadj_b.clone()
    u = u_vec_b.to(dt).clone()
    g_new = torch.empty((K, nbk * Bk), dtype=dt, device=yadj.device)
    track = torch.empty((K, nbk * Bk), dtype=torch.int32, device=yadj.device)
    for b in range(nbk):
        Xb = X_blocks[offk + b].to(dt)
        r0 = (yadj @ Xb).T if K == 1 else (yadj[:, :, None] * Xb).sum(1).T
        if reduce_r0 is not None:
            r0 = reduce_r0(r0.contiguous())
        gi, dg, tr = draws(P_blocks[b], W_blocks[offk + b].to(dt), r0)
        delta = (Xb @ dg).T if K == 1 else (Xb * dg.T[:, None, :]).sum(2)
        yadj += delta
        u -= delta
        g_new[:, b * Bk:(b + 1) * Bk] = (P_blocks[b][:, 1] - dg if gi is None else gi).T
        track[:, b * Bk:(b + 1) * Bk] = tr.T.to(torch.int32)
    return phase_c_mc(spec, consts_b, vx, vei_b, sb.gather(g_new), sb.gather(track), u_b,
                      z2_b, vargL_b, yadj, u)


def sweep_mc_plain(spec, consts_b, X_blocks, W_blocks, xpx, vx, vei_b, g_b,
                   z_b, u_b, chi_b, z2_b, vargL_b, yadj_b, u_vec_b,
                   block_range=None, C_blocks=None):
    """Plain version of :func:`sweep_mc`, in the dtype of ``yadj_b``, by the
    same sub-blocks (:func:`mc_layout`): :func:`sweep_blocks` with the
    plain draws.  On the CPU it takes the role of the JAX engine's
    ``_sweep_xla``.  ``C_blocks`` is taken and not read: each block's
    right-hand side is formed from the residual after the block before."""
    sweep_mc_plain.calls += 1
    return sweep_blocks(spec, consts_b, X_blocks, W_blocks, xpx, vx, vei_b, g_b, z_b, u_b,
                        chi_b, z2_b, vargL_b, yadj_b, u_vec_b,
                        lambda P, W, r: _draws_plain(spec, P, W, r), block_range)


sweep_mc_plain.calls = 0


@spanned("ops.sweep_mc")
def sweep_mc(spec, consts_b, X_blocks, W_blocks, xpx, vx, vei_b, g_b, z_b,
             u_b, chi_b, z2_b, vargL_b, yadj_b, u_vec_b, block_range=None,
             stamps=None, C_blocks=None):
    """Fused K-chain sweep; the contract of ``sweep_mc_t``
    (hibayes_tpu/ops/blockgibbs.py:695-764).

    X_blocks (nb_tot S, n, W) int8 or f32 and W_blocks (nb_tot S, W, W), the
    genotype and its Gram blocks in blocks of B = spec.block as S
    sub-blocks of W (``prepare_gibbs_data``'s layout, :func:`mc_layout`;
    S = 1 and W = B where the kernels take B as it is); per-SNP inputs are
    (m,) shared or (K, m) per chain, m = nbg * B; yadj_b, u_vec_b (K, n).
    ``block_range=(off, nbg)`` sweeps blocks [off, off + nbg) of X and W
    (indexed globally, in blocks of B) while the per-SNP inputs are the
    local slice.  Any B and fold count: the kernels sweep each block as its
    sub-blocks, the same SNPs in the same order.
    On the card one chain (K = 1) is one persistent launch of
    ``sweep1_kernel`` (:func:`sweep1_plan`; its flags run on across sweeps
    on each device, so two one-chain sweeps must not run at once on one
    device), which forms each block's right-hand side one block ahead and
    corrects it by the cross-Gram of consecutive blocks: ``C_blocks`` (nb_tot
    S, W, W), C[k] = X_k' X_{k-1}, indexed globally like W
    (``GibbsData.C_blocks``; made once per X where not given,
    :func:`cross_grams`); it counts ``ops.sweep1.blocks`` (blocks launched)
    and ``ops.sweep1.lookahead`` (blocks whose right-hand side the lookahead
    formed: all but a launch's first).  K >= 2 chains two launches a
    (sub-)block (``C_blocks`` unused).
    ``stamps`` (measurement only, on the card): an int64 tensor of at least
    16 (nbg S + 1) entries that gets, for each kernel block, %globaltimer ns at the
    stages of the sweep (csrc/blockgibbs.cu kStamps: at K = 1 the drawer's
    wait for the partials, the chain and the first rows CTA's wait and work;
    at K >= 2 the launches' stages and clock64 through the K-chain rows
    kernel's first chunk).
    Returns (g_new, track, vargL_new, yadj, u, vargi_acc, vargR_acc)."""
    if X_blocks.device.type == "cpu":
        return sweep_mc_plain(spec, consts_b, X_blocks, W_blocks, xpx, vx,
                              vei_b, g_b, z_b, u_b, chi_b, z2_b, vargL_b,
                              yadj_b, u_vec_b, block_range=block_range)
    _require_cuda(X_blocks, W_blocks, yadj_b, u_vec_b, g_b)
    sb = mc_layout(spec, X_blocks)
    nbk, n, Bk = X_blocks.shape
    nb_tot, B = nbk // sb.S, sb.B
    off, nbg = block_range if block_range is not None else (0, nb_tot)
    K = yadj_b.shape[0]
    if K < 1:
        raise ValueError("sweep_mc: no chains")
    if not (0 <= off and off + nbg <= nb_tot):
        raise ValueError(f"block_range {block_range} outside {nb_tot} blocks")
    if X_blocks.dtype not in (torch.int8, F32):
        raise TypeError(f"sweep_mc: X must be int8 or float32, got {X_blocks.dtype}")
    if W_blocks.dtype != F32 or yadj_b.dtype != F32:
        raise TypeError("sweep_mc: the kernel takes float32 W and residuals")
    if not X_blocks.is_contiguous() or X_blocks.data_ptr() % 16:
        raise ValueError("sweep_mc: X_blocks must be contiguous and 16-byte aligned")
    if (nbk % sb.S or tuple(W_blocks.shape) != (nbk, Bk, Bk) or tuple(yadj_b.shape) != (K, n)
            or tuple(u_vec_b.shape) != (K, n)):
        raise ValueError("sweep_mc: W, yadj or u do not match X and the chains")
    lib = build.library()
    P = pack_rows(spec, consts_b, xpx, vx, vei_b, g_b, z_b, u_b, chi_b,
                  vargL_b, F32)
    if tuple(P.shape) != (K, n_rows(spec), nbg * B):
        raise ValueError(f"sweep_mc: packed rows {tuple(P.shape)}, expected "
                         f"{(K, n_rows(spec), nbg * B)} for block_range {block_range}")
    nbg, off = nbg * sb.S, off * sb.S
    m_loc = nbg * Bk
    Pk = _spread_rows(spec, sb, P)
    P_blocks = to_block_layout(Pk, nbg, Bk)
    Pg = snp_major_rows(Pk.transpose(1, 2)) if sb.rows_global else None
    W = W_blocks.contiguous()
    yadj = yadj_b.contiguous().clone()
    u = u_vec_b.to(F32).contiguous().clone()
    dev = yadj.device
    g_new = torch.empty((K, m_loc), dtype=F32, device=dev)
    dg = torch.empty((K, m_loc), dtype=F32, device=dev)
    track_f = torch.empty((K, m_loc), dtype=F32, device=dev)
    tile = rows_per_tile(n, dev, K)
    ntiles = -(-n // tile)
    # one chain: two halves, block b's partials in half b mod 2
    partial = torch.empty((2 if K == 1 else 1, ntiles, K, Bk), dtype=F32, device=dev)
    if stamps is not None and (stamps.dtype != torch.int64 or stamps.device != dev
                               or stamps.numel() < 16 * (nbg + 1)):
        raise ValueError("sweep_mc: stamps must be int64 on the card, 16 per block + 16")
    if K == 1:
        props = torch.cuda.get_device_properties(dev)
        plan = sweep1_plan(n, Bk, P.shape[1], X_blocks.element_size(),
                           props.multi_processor_count,
                           getattr(props, "shared_memory_per_block_optin", SMEM_OPTIN),
                           rows_smem=not sb.rows_global)
        C = cross_grams(X_blocks) if C_blocks is None else C_blocks
        if C.dtype != F32 or tuple(C.shape) != (nbk, Bk, Bk) or C.device != dev:
            raise ValueError("sweep_mc: C_blocks must be float32 (nb_tot S, W, W) on X's device")
        C = C.contiguous()
        fl = _sweep1_flags(dev, ntiles)
        one = (C.data_ptr(), fl["flags"].data_ptr(), fl["epoch"] & 0xFFFFFFFF, plan["grid"],
               plan["nb0"], plan["nbr"], plan["wb"], plan["cb"])
        count("ops.sweep1.blocks", nbg)
        count("ops.sweep1.lookahead", max(nbg - 1, 0))
    else:
        fl, one = None, (None, None, 0, 0, 0, 0, 0, 0)
    code = lib.hb_sweep_mc(
        X_blocks.data_ptr(), int(X_blocks.dtype == torch.int8), W.data_ptr(),
        P_blocks.data_ptr(), off, nbg, n, tile,
        *(rows_mc_shape(K, tile) if K > 1 else (0, 0, 0, 0)), Bk, P.shape[1], K,
        spec.model_index,
        spec.n_fold, yadj.data_ptr(), u.data_ptr(), g_new.data_ptr(),
        dg.data_ptr(), track_f.data_ptr(), partial.data_ptr(), *one,
        None if stamps is None else stamps.data_ptr(), None if Pg is None else Pg.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if code != 0 and fl is not None:
        _SWEEP1_FLAGS.pop(str(dev), None)
    build.check(lib, code, "sweep_mc")
    if fl is not None:
        fl["epoch"] += nbg
    sweep_mc.launches += 1
    return phase_c_mc(spec, consts_b, vx, vei_b, sb.gather(g_new),
                      sb.gather(track_f).to(torch.int32), u_b, z2_b, vargL_b, yadj, u)


sweep_mc.launches = 0
# capability flag: sweep_mc (and its plain version) sweeps blocks [off, off
# + nbg) of the whole genotype in place (``block_range``), so a caller that
# sweeps part of the blocks passes the whole X, never a copy of a slice
sweep_mc.block_range_in_place = sweep_mc_plain.block_range_in_place = True


# ---------------------------------------------------------------------------
# summary-level (sbrm) sweeps: one chain, r_hat as the state
# ---------------------------------------------------------------------------


def guard_on(spec) -> bool:
    """Whether the summary sweeps apply the rejection guard: SBayesS
    semantics (``reject_guard``: chi-square-pruned, per-chromosome or tiled
    LD) for BayesC/Cpi and BayesR only."""
    return bool(spec.reject_guard) and spec.model_index in (4, 6)


def summary_rows(spec) -> int:
    """Rows per SNP of a summary sweep's packed rows: :func:`n_rows`, and
    the guard rows (:func:`n_guard_rows`) when :func:`guard_on`."""
    return n_rows(spec) + (n_guard_rows(spec) if guard_on(spec) else 0)


def _tally(tally, guard) -> None:
    """Add a sweep's guard counts ((K, 2) or (2,): first draws rejected,
    draws whose every candidate failed) into ``tally`` (the same shape,
    int64), when one is given."""
    if tally is not None:
        tally += guard.to(device=tally.device, dtype=tally.dtype).reshape(tally.shape)


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


def sweep_s_segment_plain(spec, LD_seg, r_seg, P, n, tally=None):
    """Plain version of :func:`sweep_s_segment`, in the dtype of ``r_seg``,
    by the same sub-blocks (:func:`segment_sub_blocks`).  With K chains each
    chain's update is an elementwise product and a sum of its own, so that
    it does not depend on the other chains."""
    sweep_s_segment_plain.calls += 1
    sb = segment_sub_blocks(spec, spec.block)
    out = _segment_plain(spec, sb.W, sub_block_segment(LD_seg, sb), sb.spread(r_seg),
                         _spread_rows(spec, sb, P), n, tally)
    return tuple(sb.gather(t) for t in out)


def _segment_plain(spec, B, LD_seg, r_seg, P, n, tally):
    mc = LD_seg.shape[0]
    dt = r_seg.dtype
    LD = LD_seg.to(dt)
    K = r_seg.shape[0] if r_seg.dim() == 2 else 1
    guard = torch.zeros((K, 2), dtype=torch.int64, device=r_seg.device)
    # the guard's bound and counts, passed only when it is on
    gd = ((torch.tensor(spec.vary, dtype=dt, device=r_seg.device), guard)
          if guard_on(spec) else ())
    if r_seg.dim() == 1:   # one chain: the single-chain sweep's products, unchanged
        P_blocks = _summary_blocks(P, mc // B, B, dt)
        r = r_seg.clone()
        dg = torch.empty((mc,), dtype=dt, device=r.device)
        track = torch.empty((mc,), dtype=dt, device=r.device)
        for b in range(mc // B):
            sl = slice(b * B, (b + 1) * B)
            _, d, t = _draws_plain(spec, P_blocks[b], n * LD[sl, sl], r[sl, None], *gd)
            r += n * (LD[:, sl] @ d[:, 0])
            dg[sl], track[sl] = d[:, 0], t[:, 0]
        _tally(tally, guard[0])
        return dg, track.to(torch.int32), r
    P_blocks = to_block_layout(P.to(dt), mc // B, B)          # (nb, B, R, K)
    r = r_seg.clone()
    dg = torch.empty((K, mc), dtype=dt, device=r.device)
    track = torch.empty((K, mc), dtype=dt, device=r.device)
    for b in range(mc // B):
        sl = slice(b * B, (b + 1) * B)
        _, d, t = _draws_plain(spec, P_blocks[b], n * LD[sl, sl], r[:, sl].T, *gd)
        r += n * (LD[:, sl] * d.T[:, None, :]).sum(2)
        dg[:, sl], track[:, sl] = d.T, t.T
    _tally(tally, guard)
    return dg, track.to(torch.int32), r


sweep_s_segment_plain.calls = 0


SEG_WARPS = 8         # warps of a segment-sweep CTA (csrc/sgibbs.cu kSegWarps)
SEG_TILES = 3         # row tiles in flight a row-owner warp (kTiles)


def segment_tile_rows(B: int) -> int:
    """Rows of a row-owner warp's tile, one a lane: 32, or 16 at B > 64 so
    that SEG_TILES tiles a warp fit in shared memory."""
    return 32 if B <= 64 else 16


def segment_smem(B: int, RP: int, cpc: int, rw: int, kch: int, lds: int) -> tuple:
    """Shared memory bytes of the segment sweep's drawer CTA (two Gram
    blocks, the tile LD[b + 1, b] at row stride lds, two blocks of packed
    rows at stride RP for cpc chains, four (cpc, B) buffers) and of a
    row-owner CTA (each warp's SEG_TILES tiles of segment_tile_rows(B) rows
    at stride B + 4, dg of one block for kch chains, r of its 8 rw rows for
    kch chains); csrc/sgibbs.cu seg_draw_floats, seg_own_floats."""
    draw = 4 * (2 * B * B + B * lds + 2 * cpc * B * RP + 4 * cpc * B)
    own = 4 * (SEG_WARPS * SEG_TILES * segment_tile_rows(B) * (B + 4) + kch * B
               + SEG_WARPS * rw * kch)
    return draw, own


def segment_plan(mc: int, B: int, K: int, R: int, sms: int,
                 optin: int = SMEM_OPTIN, rows_smem: bool = True) -> dict:
    """The persistent segment sweep's launch for a segment of mc rows,
    blocks of B, K chains, R packed rows: drawer CTAs of cpc chains (8, or
    fewer where their shared memory would not fit), the drawer's tile
    LD[b + 1, b] at row stride lds (B + 4, so that its threads' reads
    spread over the banks, where that fits, else B), row-owner CTAs of 8
    warps, each warp rw rows (a multiple of 4, so that the owners fill the
    SMs the drawers leave) in tiles of segment_tile_rows(B), and kch chains
    a row-owner pass (all K where they fit, else as many as fit).  At most
    one CTA an SM.  ``rows_smem`` False: the draws read the packed rows
    from global memory, none in the drawer's shared memory.  Returns cpc,
    ndraw, rw, nown, kch, trows, lds and smem (bytes a CTA); raises if no
    split fits."""
    RP = padded_stride(R) if rows_smem else 0
    cpc = next((c for c in (8, 4, 2, 1) if segment_smem(B, RP, c, 4, 1, B)[0] <= optin), None)
    if cpc is None:
        raise ValueError(f"sweep_s_segment: blocks of {B} do not fit a drawer CTA")
    lds = B + 4 if segment_smem(B, RP, cpc, 4, 1, B + 4)[0] <= optin else B
    ndraw = -(-K // cpc)
    room = sms - ndraw
    if room < 1:
        raise ValueError(f"sweep_s_segment: {K} chains take {ndraw} drawer CTAs, "
                         f"{sms} SMs leave none for the rows")
    rw = -(-mc // (room * SEG_WARPS))
    rw = -(-rw // 4) * 4
    nown = -(-(-(-mc // rw)) // SEG_WARPS)
    tiles = segment_smem(B, RP, cpc, rw, 0, lds)[1]
    kch = min(K, (optin - tiles) // (4 * (B + SEG_WARPS * rw)))
    if kch < 1:
        raise ValueError(f"sweep_s_segment: {rw} rows a warp at blocks of {B} do not "
                         f"fit a row-owner CTA")
    draw, own = segment_smem(B, RP, cpc, rw, kch, lds)
    return {"cpc": cpc, "ndraw": ndraw, "rw": rw, "nown": nown, "kch": kch,
            "trows": segment_tile_rows(B), "lds": lds, "smem": max(draw, own)}


def segment_rows(o: int, w: int, rw: int, mc: int) -> range:
    """Rows that warp w of row-owner CTA o owns for the whole segment sweep
    (csrc/sgibbs.cu seg_owner)."""
    r0 = (o * SEG_WARPS + w) * rw
    return range(min(r0, mc), min(r0 + rw, mc))


# the flags of the segment sweep on each device: each chain's and each
# row-owner CTA's progress, values that run on across sweeps, and the next
# sweep's epoch (it publishes epoch + 1 .. epoch + nb)
_SEGMENT_FLAGS = {}


def _segment_flags(dev, n: int) -> dict:
    st = _SEGMENT_FLAGS.get(str(dev))
    if st is None or st["flags"].numel() < n:
        st = {"flags": torch.zeros(max(n, 256), dtype=torch.int32, device=dev), "epoch": 0}
        _SEGMENT_FLAGS[str(dev)] = st
    return st


EXHAUST_SHIFT = 16   # the kernels' guard counts: rejected + (exhausted << 16) (draws.cuh)


def _guard_counts(nrej) -> torch.Tensor:
    """The kernels' encoded guard counts (..., rows) -> (..., 2) int64:
    first draws rejected, draws whose every candidate failed."""
    c = nrej.to(torch.int64)
    return torch.stack([(c & ((1 << EXHAUST_SHIFT) - 1)).sum(-1),
                        (c >> EXHAUST_SHIFT).sum(-1)], dim=-1)


@spanned("ops.sweep_s_segment")
def sweep_s_segment(spec, LD_seg, r_seg, P, n, stamps=None, tally=None):
    """Summary sweep of one or K chains over one padded dense LD segment;
    the contract of ``sweep_s_segment`` (hibayes_tpu/ops/blockgibbs.py:1207-1254)
    for one chain and of ``sweep_s_segment_t`` (:1325-1362) for K.

    LD_seg (mc, mc), mc a multiple of B; r_seg (mc,) or (K, mc) the
    segment's r_hat; P (R, mc) or (K, R, mc) the segment's packed rows
    (:func:`pack_rows`), followed by the guard rows (:func:`pack_retry_rows`)
    when :func:`guard_on`.  Per block: each chain's B draws against
    n LD[block, block] (with SBayesS semantics for BayesC/Cpi and BayesR,
    each followed by the rejection guard at ``spec.vary``: the tiled
    sweep's rule, :func:`guard_draw`), then r_seg += n LD[:, block] dg.
    ``tally`` (optional, int64 (2,) or (K, 2) on r_seg's device) gets each
    chain's guard counts added: draws whose first candidate was rejected,
    and those whose every candidate failed.  The JAX wrapper's
    ``consts`` carry only the fold-0 logit, which the packed rows hold, so
    the port takes none.  Returns (dg, track int32, r_seg_new), each (mc,)
    or (K, mc) as r_seg.

    Any B and fold count: the kernel sees the blocks as the sub-blocks of
    :func:`segment_sub_blocks` (the segment itself where they tile it, else
    a copy with inert pad rows made once per segment).
    On the card the sweep is one persistent launch (:func:`segment_plan`;
    its flags, per device, run on by an epoch: two segment sweeps must not
    run at once on one device); a batch whose drawers would leave no SM for
    the rows runs in groups of chains (:func:`segment_group`), a launch
    each.  ``stamps`` (the first group's) (measurement only): an int64
    tensor of at least 12 (mc / B) + 4 entries that gets, per block, the
    first drawer CTA's clock64 at the chain's start, after the barrier that
    follows its chains (dg published, the next block staged), after its
    contribution's sums, after the wait for the rows' owners and with r of
    the next block ready; the first row-owner CTA's once dg is seen, once
    the block is applied, after dg is loaded into shared memory, and its
    first warp's after its tile's wait and after its tile's sums; the
    first drawer warp's after its draws and after it published dg; then
    %globaltimer ns and clock64 at the drawer's start and end."""
    if r_seg.device.type == "cpu":
        return sweep_s_segment_plain(spec, LD_seg, r_seg, P, n, tally)
    _require_cuda(r_seg, LD_seg, P)
    chains = r_seg.dim() == 2
    mc, B, R = LD_seg.shape[0], spec.block, summary_rows(spec)
    K = r_seg.shape[0] if chains else 1
    if LD_seg.dtype != F32 or r_seg.dtype != F32 or P.dtype != F32:
        raise TypeError("sweep_s_segment: the kernel takes float32 (other "
                        "float types run on the CPU)")
    lead = (K,) if chains else ()
    if (tuple(LD_seg.shape) != (mc, mc) or mc % B or tuple(r_seg.shape) != lead + (mc,)
            or tuple(P.shape) != lead + (R, mc) or K < 1):
        raise ValueError(f"sweep_s_segment: LD {tuple(LD_seg.shape)}, r "
                         f"{tuple(r_seg.shape)} and packed rows {tuple(P.shape)} "
                         f"do not fit a segment of blocks of {B} with {R} rows")
    if not LD_seg.is_contiguous() or LD_seg.data_ptr() % 16:
        raise ValueError("sweep_s_segment: LD must be contiguous and 16-byte aligned")
    sb = segment_sub_blocks(spec, B)
    LDk = sub_block_segment(LD_seg, sb)
    rk, Pk = sb.spread(r_seg), _spread_rows(spec, sb, P)
    mck, Bk = LDk.shape[0], sb.W
    nb = mck // Bk
    if stamps is not None and (stamps.dtype != torch.int64 or stamps.device != r_seg.device
                               or stamps.numel() < 12 * nb + 4):
        raise ValueError("sweep_s_segment: stamps must be int64 on the card, 12 per block + 4")
    dev = r_seg.device
    props = torch.cuda.get_device_properties(dev)
    sms = props.multi_processor_count
    optin = getattr(props, "shared_memory_per_block_optin", SMEM_OPTIN)
    glob = sb.rows_global
    G = segment_group(mck, Bk, K, R, sms, optin, not glob)
    if not chains:
        out = _segment_launch(spec, LDk, rk[None], Pk[None], n, Bk, G, sms, optin, stamps,
                              tally if tally is None else tally[None], glob)
        return tuple(sb.gather(t[0]) for t in out)
    parts = [_segment_launch(spec, LDk, rk[g], Pk[g], n, Bk, min(G, g.stop - g.start), sms,
                             optin, stamps if g.start == 0 else None,
                             None if tally is None else tally[g], glob)
             for g in _chain_groups(K, G)]
    return tuple(sb.gather(torch.cat(t, dim=0)) for t in zip(*parts))


def segment_group(mc: int, B: int, K: int, R: int, sms: int, optin: int = SMEM_OPTIN,
                  rows_smem: bool = True) -> int:
    """The most chains of a segment sweep's launch (at most K) for which
    :func:`segment_plan` fits the card: a batch whose drawer CTAs would
    leave no SM for the rows runs in groups of that many chains, a launch
    each, in order."""
    G = K
    while True:
        try:
            segment_plan(mc, B, G, R, sms, optin, rows_smem)
            return G
        except ValueError:
            if G == 1:
                raise
            G = -(-G // 2)


def _segment_launch(spec, LD_seg, r_seg, P, n, B, K, sms, optin, stamps, tally,
                    rows_global=False):
    """One launch of the segment sweep for K chains (r_seg (K, mc), P (K, R,
    mc)) at blocks of B; returns (dg, track int32, r), each (K, mc).
    ``rows_global``: the draws read the packed rows from a SNP-major copy at
    padded_stride(R) in global memory."""
    guard = guard_on(spec)
    mc, R = LD_seg.shape[0], P.shape[1]
    nb = mc // B
    lib = build.library("sgibbs.cu")
    dev = r_seg.device
    plan = segment_plan(mc, B, K, R, sms, optin, not rows_global)
    fl = _segment_flags(dev, K + plan["nown"])
    Pc = P.contiguous()
    Pg = snp_major_rows(Pc.transpose(1, 2)) if rows_global else None
    r = r_seg.clone(memory_format=torch.contiguous_format)
    dg = torch.empty((K, mc), dtype=F32, device=dev)
    track = torch.empty((K, mc), dtype=F32, device=dev)
    snap = torch.empty((2, K, B), dtype=F32, device=dev)
    nrej = torch.empty((K, nb) if guard else (0,), dtype=torch.int32, device=dev)
    code = lib.hb_sweep_s_segment(
        LD_seg.data_ptr(), Pc.data_ptr(), mc, B, R, K, spec.model_index,
        spec.n_fold, int(guard), float(n), float(spec.vary),
        nrej.data_ptr() if guard else None, r.data_ptr(), dg.data_ptr(), track.data_ptr(),
        snap.data_ptr(), fl["flags"].data_ptr(), fl["epoch"] & 0xFFFFFFFF, plan["ndraw"],
        plan["cpc"], plan["nown"], plan["rw"], plan["kch"], plan["trows"], plan["lds"],
        None if stamps is None else stamps.data_ptr(), None if Pg is None else Pg.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if code != 0:
        _SEGMENT_FLAGS.pop(str(dev), None)
    build.check(lib, code, "sweep_s_segment")
    fl["epoch"] += nb
    sweep_s_segment.launches += 1
    if guard:
        _tally(tally, _guard_counts(nrej))
    return dg, track.to(torch.int32), r


sweep_s_segment.launches = 0


@dataclass
class TiledSchedule:
    """The order of the tiled sweep's contributions, built on the host once
    per layout (:func:`tiled_schedule`), and its counters on each device.

    A contribution is a valid slot (i, k): r_hat[block cols[i, k]] += n
    tiles[i, k]^T dg_i.  ``need[i]`` contributions reach block i from rows
    before i: row i's draws wait for them.  ``nxt[i]`` is row i's slot whose
    block is i + 1 (-1: none), which the kernel's drawer applies itself;
    ``items`` (nitems, 4) = (row, slot, target block, sequence number) are
    the other valid slots, row by row, and a contribution's sequence number
    is its place, by row, among the contributions to its block: it lands
    after every earlier one.  ``total[t]`` contributions reach block t.

    A shard's schedule (``row_base`` > 0, or fewer rows than blocks): rows
    i are local, global row row_base + i; targets, ``total`` and the
    counters run over all ``nblocks`` global blocks; ``need[i]`` counts
    only the shard's own rows before it (an earlier shard's contributions
    are in r_hat when its sweep starts), and the last local row's
    contribution to the next block, another shard's, is an item."""

    need: np.ndarray
    nxt: np.ndarray
    items: np.ndarray
    total: np.ndarray
    row_base: int = 0
    _state: dict = field(default_factory=dict, repr=False)

    @property
    def nbr(self) -> int:
        return int(self.need.shape[0])

    @property
    def nblocks(self) -> int:
        return int(self.total.shape[0])

    def device_state(self, dev, chains: int = 1):
        """The schedule's tensors and the counters of a sweep of ``chains``
        chains on ``dev`` (made, zeroed, once for each chain count: a batch
        never shares the one-chain sweep's counters) and the next sweep's
        epoch: sweep e starts with cnt[c, t] = e total[t] and publishes row
        flags e + 1, so nothing is reset between sweeps."""
        key = (str(dev), chains)
        if key not in self._state:
            i32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=dev)
            self._state[key] = {
                "need": i32(self.need), "nxt": i32(self.nxt), "total": i32(self.total),
                "items": i32(self.items.reshape(-1, 4)),
                "cnt": torch.zeros((chains, self.nblocks), dtype=torch.int32, device=dev),
                "flags": torch.zeros((chains, self.nbr), dtype=torch.int32, device=dev),
                "epoch": 0}
        return self._state[key]

    def forget(self, dev, chains: int = 1) -> None:
        """Drop the counters of ``chains`` chains on ``dev`` (after a failed
        sweep)."""
        self._state.pop((str(dev), chains), None)


def tiled_schedule(cols, valid, row_base: int = 0, nblocks=None) -> TiledSchedule:
    """The contribution order of the tiled sweep for a layout's (nbr, K)
    ``cols`` and ``valid`` (tensors or arrays; bands, bands with gaps and
    columns that are not a band alike).  Invalid slots (which point at their
    own row's block) carry no contribution.  ``row_base`` and ``nblocks``
    (default nbr): the rows are global rows row_base .. row_base + nbr - 1
    of a store of ``nblocks`` tile rows, whose block indices ``cols``
    holds (a shard of the rows, :class:`TiledSchedule`).  Raises if a valid
    slot points outside the blocks or two valid slots of a row at one
    block."""
    as_np = lambda a: (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                       else np.asarray(a))
    cols, valid = as_np(cols).astype(np.int64), as_np(valid).astype(bool)
    if cols.ndim != 2 or cols.shape != valid.shape:
        raise ValueError(f"cols {cols.shape} and valid {valid.shape} must be one (nbr, K) shape")
    nbr = cols.shape[0]
    nb = nbr if nblocks is None else int(nblocks)
    if row_base < 0 or row_base + nbr > nb:
        raise ValueError(f"rows {row_base} .. {row_base + nbr - 1} outside {nb} blocks")
    rows, slots = np.nonzero(valid)          # row-major: the sweep's order
    grow = rows + row_base
    tgt = cols[rows, slots]
    if ((tgt < 0) | (tgt >= nb)).any():
        raise ValueError("a valid slot points outside the tile rows' blocks")
    if np.unique(rows * nb + tgt).size != tgt.size:
        raise ValueError("two valid slots of one tile row point at one block")
    order = np.lexsort((rows, tgt))          # by block, then by row
    t_sorted = tgt[order]
    seq = np.empty_like(tgt)
    seq[order] = np.arange(tgt.size) - np.searchsorted(t_sorted, t_sorted, side="left")
    need_all = np.bincount(tgt[grow < tgt], minlength=nb)
    nxt = np.full(nbr, -1, dtype=np.int64)
    is_next = (tgt == grow + 1) & (rows + 1 < nbr)
    nxt[rows[is_next]] = slots[is_next]
    # the drawer's contribution is the last one block i + 1 waits for
    assert (seq[is_next] == need_all[tgt[is_next]] - 1).all()
    items = np.stack([rows, slots, tgt, seq], axis=1)[~is_next]
    return TiledSchedule(need=need_all[row_base:row_base + nbr], nxt=nxt, items=items,
                         total=np.bincount(tgt, minlength=nb), row_base=int(row_base))


# the schedule of each layout's cols tensor (by identity), with weak
# references to it and its valid tensor and both tensors' versions: a sweep
# over the same layout reuses it; an entry goes with its cols tensor
_SCHEDULES = {}


def _layout_schedule(cols, valid, row_base: int = 0, nblocks=None) -> TiledSchedule:
    versions = (cols._version, valid._version, row_base, nblocks)
    hit = _SCHEDULES.get(id(cols))
    if hit is None or hit[0]() is not cols or hit[1]() is not valid or hit[2] != versions:
        hit = (weakref.ref(cols), weakref.ref(valid), versions,
               tiled_schedule(cols, valid, row_base, nblocks))
        _SCHEDULES[id(cols)] = hit
        weakref.finalize(cols, _SCHEDULES.pop, id(cols), None)
    return hit[3]


def sweep_s_tiled_plain(spec, tiles, cols, valid, r_hat, P, n, tally=None, row_base=0):
    """Plain version of :func:`sweep_s_tiled`, in the dtype of ``r_hat``, on
    the same tiles (:func:`tiled_sub_blocks`): one chain, or C chains drawn
    side by side (each chain's draws elementwise, each contribution a
    product of its own), chain c bit for bit the one-chain call on chain c's
    inputs.  ``row_base`` as there."""
    sweep_s_tiled_plain.calls += 1
    sb = tiled_sub_blocks(spec, tiles.shape[2])
    tk, ck, vk = sub_block_tiles(tiles, cols, valid, sb)
    dg, track, r, rej = _tiled_plain(spec, tk, ck, vk, sb.spread(r_hat),
                                     _spread_rows(spec, sb, P), n, tally, row_base * sb.S)
    return sb.gather(dg), sb.gather(track), sb.gather(r), rej


def _tiled_plain(spec, tiles, cols, valid, r_hat, P, n, tally, row_base=0):
    nbr, K, B, _ = tiles.shape
    dt, dev = r_hat.dtype, r_hat.device
    one = r_hat.dim() == 1
    vary = torch.tensor(spec.vary, dtype=dt, device=dev) if guard_on(spec) else None
    P_blocks = to_block_layout((P[None] if one else P).to(dt), nbr, B)   # (nbr, B, R, C)
    r = (r_hat[None] if one else r_hat).clone()
    C = r.shape[0]
    rb = r.view(C, -1, B)   # every block of the store: rows draw at row_base + i
    cols_l, valid_l = cols.tolist(), valid.tolist()
    dg = torch.empty((C, nbr * B), dtype=dt, device=dev)
    track = torch.empty((C, nbr * B), dtype=dt, device=dev)
    guard = torch.zeros((C, 2), dtype=torch.int64, device=dev)
    for i in range(nbr):
        T = tiles[i].to(dt)
        _, d, t = _draws_plain(spec, P_blocks[i], n * T[0], rb[:, row_base + i].T, vary,
                               guard)
        d = d.T.contiguous()   # (C, B): each chain's dg a contiguous row
        for k in range(K):
            if valid_l[i][k]:   # invalid slots point at the own row: skipped
                for c in range(C):
                    rb[c, cols_l[i][k]] += n * (d[c] @ T[k])
        dg[:, i * B:(i + 1) * B], track[:, i * B:(i + 1) * B] = d, t.T
    _tally(tally, guard[0] if one else guard)
    if one:
        return dg[0], track[0].to(torch.int32), r[0], guard[0, 0].clone()
    return dg, track.to(torch.int32), r, guard[:, 0].clone()


sweep_s_tiled_plain.calls = 0


@spanned("ops.sweep_s_tiled")
def sweep_s_tiled(spec, tiles, cols, valid, r_hat, P, n, stamps=None, tally=None,
                  row_base=0):
    """Summary sweep of one chain or a batch of C chains over every tile row
    of a tiled sparse LD, or over a shard of its rows; the contract of
    ``sweep_s_tiled`` (hibayes_tpu/ops/blockgibbs.py:1730-1792), for each
    chain.

    tiles (nbr, K, B, B) with the diagonal tile in slot 0; cols, valid
    (nbr, K) with global block indices; r_hat (nb * B,), or (C, nb * B)
    for C chains, the whole state (nb >= row_base + nbr blocks); P (R, nbr
    * B) (or (C, R, nbr * B)) the packed rows of the swept rows, followed
    by the guard rows (:func:`pack_retry_rows`) when :func:`guard_on`.  Per
    tile row i, global row ``row_base`` + i: B draws against n tiles[i, 0]
    (guarded) from r_hat of that block, then for each valid slot
    r_hat[block cols[i, k]] += n tiles[i, k]^T dg.  ``row_base`` 0 with nb
    = nbr sweeps the whole store; a shard of the rows (the SNP-sharded
    sweep) gives its first global row, and r_hat returns with every
    contribution of the shard's rows, to any block.  Returns (dg, track int32,
    r_hat_new, rejected), each with r_hat's leading chain axis:
    ``rejected`` (0-d, or (C,)) counts the draws whose first candidate the
    guard rejected; ``tally`` (optional, int64 (2,) or (C, 2)) gets that
    count and the count of draws whose every candidate failed added.  Any
    tile and fold count: the kernel sweeps the store re-tiled into the
    tiles of :func:`tiled_sub_blocks` (the store itself where it takes B as
    it is: 64 or 128 from ``ldmat``; else :func:`sub_block_tiles`, made
    once per store), the same SNPs in the same order.

    On the card the sweep is one launch that applies the contributions in
    the order of :func:`tiled_schedule` of cols and valid, built at the
    first sweep over these two tensors (anew if either is changed in
    place) and kept with its counters (per chain count) for the sweeps
    after it.  A batch is the same launch with a drawer CTA per chain and
    each contribution's tile read once for all chains; chain c is bit for
    bit a one-chain launch on chain c's inputs.  The grid (the drawers and
    at least one CTA for the contributions) must be resident at once, so a
    batch larger than that runs in groups of
    chains, a launch each, in order (:func:`tiled_group`), which changes
    no number.  ``stamps`` (measurement only;
    chain 0's): an int64 tensor of at least 4 nbr + 4 entries that gets the
    drawer's clock64 at four points of each row (before its draws, after
    them, after the barrier that waits for the next row's loads, after its
    own contribution), then %globaltimer ns and clock64 at the sweep's
    start and end, nbr the rows of the re-tiled store."""
    if r_hat.device.type == "cpu":
        return sweep_s_tiled_plain(spec, tiles, cols, valid, r_hat, P, n, tally, row_base)
    _require_cuda(r_hat, tiles, cols, valid, P)
    nbr, K, B, _ = tiles.shape
    lead = tuple(r_hat.shape[:-1])
    C = r_hat.shape[0] if lead else 1
    R = summary_rows(spec)
    nb = r_hat.shape[-1] // B
    if tiles.dtype != F32 or r_hat.dtype != F32 or P.dtype != F32:
        raise TypeError("sweep_s_tiled: the kernel takes float32 (other float "
                        "types run on the CPU)")
    if (tuple(tiles.shape) != (nbr, K, B, B) or tuple(cols.shape) != (nbr, K)
            or tuple(valid.shape) != (nbr, K) or r_hat.dim() > 2 or C < 1
            or tuple(r_hat.shape) != lead + (nb * B,) or not 0 <= row_base <= nb - nbr
            or tuple(P.shape) != lead + (R, nbr * B)):
        raise ValueError(f"sweep_s_tiled: tiles {tuple(tiles.shape)}, cols/valid "
                         f"{tuple(cols.shape)}/{tuple(valid.shape)}, r_hat "
                         f"{tuple(r_hat.shape)} and packed rows {tuple(P.shape)} "
                         f"do not fit (R = {R}, row_base = {row_base})")
    if not tiles.is_contiguous() or tiles.data_ptr() % 16:
        raise ValueError("sweep_s_tiled: tiles must be contiguous and 16-byte aligned")
    sb = tiled_sub_blocks(spec, B)
    tk, ck, vk = sub_block_tiles(tiles, cols, valid, sb)
    schedule = _layout_schedule(ck, vk, row_base * sb.S, nb * sb.S)
    if stamps is not None and (stamps.dtype != torch.int64
                               or stamps.numel() < 4 * tk.shape[0] + 4):
        raise ValueError("sweep_s_tiled: stamps must be int64, 4 per row + 4")
    rk, Pk = sb.spread(r_hat), _spread_rows(spec, sb, P)
    glob = sb.rows_global
    G = tiled_group(spec, sb.W, schedule.items.shape[0], glob)
    if not lead:
        out = _tiled_launch(spec, tk, schedule, rk[None], Pk[None], n, stamps,
                            tally if tally is None else tally[None], glob)
        dg, track, r, counts = (t[0] for t in out)
    else:
        parts = [_tiled_launch(spec, tk, schedule, rk[g], Pk[g], n,
                               stamps if g.start == 0 else None,
                               None if tally is None else tally[g], glob)
                 for g in _chain_groups(C, G)]
        dg, track, r, counts = (torch.cat(t, dim=0) for t in zip(*parts))
    return sb.gather(dg), sb.gather(track), sb.gather(r), counts[..., 0]


def tiled_group(spec, B: int, nitems: int, rows_global: bool = False) -> int:
    """The most chains of one tiled-sweep launch at tiles of B on this
    card: the CTAs it holds at once (``hb_tiled_resident``), less the one
    item CTA when the layout has contributions to scatter."""
    lib = build.library("sgibbs.cu")
    out = ctypes.c_longlong()
    code = lib.hb_tiled_resident(B, spec.model_index, spec.n_fold, int(guard_on(spec)),
                                 int(not rows_global), ctypes.byref(out))
    build.check(lib, code, "tiled_group")
    return max(1, out.value - (1 if nitems else 0))


def _tiled_launch(spec, tiles, schedule, r_hat, P, n, stamps, tally, rows_global=False):
    """One launch of the tiled sweep for C chains (r_hat (C, nb B), P (C,
    R, nbr B)) over the schedule's rows; returns (dg, track int32, r_hat,
    guard counts (C, 2)).  ``rows_global``: the draws read the packed rows
    from a SNP-major copy at padded_stride(R) in global memory."""
    nbr, K, B, _ = tiles.shape
    C, R = r_hat.shape[0], P.shape[1]
    guard = guard_on(spec)
    lib = build.library("sgibbs.cu")
    dev = r_hat.device
    st = schedule.device_state(dev, C)
    Pc = P.contiguous()
    Pg = snp_major_rows(Pc.transpose(1, 2)) if rows_global else None
    r = r_hat.clone(memory_format=torch.contiguous_format)
    dg = torch.empty((C, nbr * B), dtype=F32, device=dev)
    track = torch.empty((C, nbr * B), dtype=F32, device=dev)
    nrej = torch.empty((C, nbr), dtype=torch.int32, device=dev)
    code = lib.hb_sweep_s_tiled(
        tiles.data_ptr(), nbr, schedule.row_base, schedule.nblocks, K, B, R, C,
        spec.model_index, spec.n_fold, int(guard),
        float(n), float(spec.vary), Pc.data_ptr(), r.data_ptr(), dg.data_ptr(),
        track.data_ptr(), nrej.data_ptr(), st["need"].data_ptr(), st["nxt"].data_ptr(),
        st["items"].data_ptr(), st["items"].shape[0], st["total"].data_ptr(),
        st["cnt"].data_ptr(), st["flags"].data_ptr(), st["epoch"] & 0xFFFFFFFF,
        None if stamps is None else stamps.data_ptr(), None if Pg is None else Pg.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if code != 0:
        schedule.forget(dev, C)
    build.check(lib, code, "sweep_s_tiled")
    st["epoch"] += 1
    sweep_s_tiled.launches += 1
    counts = _guard_counts(nrej)
    _tally(tally, counts)
    return dg, track.to(torch.int32), r, counts


sweep_s_tiled.launches = 0


def chain_latency(spec, W_b, P_b, r0, reps, vary=None):
    """Measurement only: ``reps`` blocks of B draws (one chain, one warp)
    back to back on the card, each starting from r0 and depending on the
    one before; W_b (B, B), P_b (B, R) with R the packed rows (and the
    guard rows when ``vary`` is given).  Returns the clock64 cycles of the
    whole run (a 0-d int64 tensor); time the call with CUDA events for
    seconds."""
    _require_cuda(W_b, P_b, r0)
    B, R = P_b.shape
    guard = vary is not None
    lib = build.library("sgibbs.cu")
    out = torch.empty((B,), dtype=F32, device=r0.device)
    cycles = torch.zeros((), dtype=torch.int64, device=r0.device)
    W, P, r = (t.to(F32).contiguous() for t in (W_b, P_b, r0))
    code = lib.hb_chain_latency(W.data_ptr(), P.data_ptr(), r.data_ptr(), B, R,
                                spec.model_index, spec.n_fold, int(guard),
                                float(vary or 0.0), int(reps), out.data_ptr(),
                                cycles.data_ptr(), torch.cuda.current_stream(r0.device).cuda_stream)
    build.check(lib, code, "chain_latency")
    return cycles


# ---------------------------------------------------------------------------
# single-step (ssbrm) epsilon sweep
# ---------------------------------------------------------------------------


def _mme_draws(Wb, r, invd, noise):
    """The T sequential site draws of one block: dx_j = r_j invd_j + noise_j
    with r_j = r0_j - sum_{i<j} Wb[j, i] dx_i, kept as r -= Wb[:, j] dx_j
    after each draw (``r`` is updated in place).  Wb (..., T, T) and r,
    invd, noise (..., T): one chain, or a batch on a leading axis, each
    chain's arithmetic elementwise and its own.  Each product and sum is
    rounded on its own, in the kernel's order (csrc/mme.cu)."""
    cols = Wb.unbind(-1)
    rv, iv, nv = r.unbind(-1), invd.unbind(-1), noise.unbind(-1)
    dx = []
    for j in range(r.shape[-1]):
        d = rv[j] * iv[j] + nv[j]
        r.sub_(cols[j] * d[..., None])
        dx.append(d)
    return torch.stack(dx, dim=-1)


def mme_block_draws_plain(W, r0, invd, noise):
    """Plain version of TPU kernel 10 (``mme_block_draws``,
    hibayes_tpu/ops/blockgibbs.py:1830-1847), in the dtype of ``r0``: one
    block's T sequential single-site draw deltas
    dx_j = (r0_j - sum_{i<j} W[j, i] dx_i) invd_j + noise_j.  W (T, T);
    r0, invd, noise (T,); padded sites carry invd = noise = 0, so dx = 0."""
    mme_block_draws_plain.calls += 1
    dt = r0.dtype
    return _mme_draws(W.to(dt), r0.clone(), invd.to(dt), noise.to(dt))


mme_block_draws_plain.calls = 0


def _block_constants(Wd_i, cnt, scale, ve, z):
    """Wb = scale Wd + diag(counts), and each site's invd and noise (0 where
    the diagonal is not positive: padded sites stay frozen); scale (K, 1, 1),
    ve (K, 1) and z (K, T) for K chains give (K, T, T) and (K, T)."""
    Wb = scale * Wd_i
    Wb.diagonal(dim1=-2, dim2=-1).add_(cnt)
    d = Wb.diagonal(dim1=-2, dim2=-1)
    ok = d > 0
    d_safe = torch.where(ok, d, torch.ones_like(d))
    zero = torch.zeros_like(d)
    invd = torch.where(ok, 1.0 / d_safe, zero)
    noise = torch.where(ok, torch.sqrt(ve / d_safe) * z, zero)
    return Wb, invd, noise


def mme_sweep_plain(sp, counts, scale, ve, z, x, res):
    """Plain version of :func:`mme_sweep`, in the dtype of ``res``: one
    chain, or K chains drawn side by side (each chain's draws elementwise,
    its scatter sums on their own), chain k bit for bit the one-chain call
    on chain k's inputs."""
    mme_sweep_plain.calls += 1
    dt, dev = res.dtype, res.device
    nbr, T, _ = sp.diag_blocks.shape
    one = res.dim() == 1
    res = (res[None] if one else res).clone()
    x_new = (x[None] if one else x).to(dt).clone()
    z = z[None] if one else z
    K = res.shape[0]
    scale = torch.as_tensor(scale, dtype=dt, device=dev).reshape(K)
    ve = torch.as_tensor(ve, dtype=dt, device=dev).reshape(K, 1)
    blk_ptr, row_ptr = sp.blk_ptr.tolist(), sp.row_ptr.tolist()
    for i in range(nbr):
        sl = slice(i * T, (i + 1) * T)
        Wb, invd, noise = _block_constants(sp.diag_blocks[i].to(dt), counts[sl].to(dt),
                                           scale[:, None, None], ve, z[:, sl].to(dt))
        dx = _mme_draws(Wb, res[:, sl].clone(), invd, noise)
        x_new[:, sl] += dx
        u0, u1 = blk_ptr[i], blk_ptr[i + 1]
        if u1 > u0:
            e0, e1 = row_ptr[u0], row_ptr[u1]
            lengths = (sp.row_ptr[u0 + 1:u1 + 1] - sp.row_ptr[u0:u1]).to(torch.int64)
            terms = sp.ent_val[e0:e1].to(dt) * dx[:, sp.ent_col[e0:e1].to(torch.int64)]
            rows = sp.urow[u0:u1].to(torch.int64)
            for k in range(K):
                res[k, rows] -= scale[k] * torch.segment_reduce(terms[k], "sum",
                                                                lengths=lengths)
    return (x_new[0], res[0]) if one else (x_new, res)


mme_sweep_plain.calls = 0


MME_RECORD_HEAD = 8   # ints of an epsilon record before its row pointers (csrc/mme.cu kRecHead)


def mme_tile(T: int) -> int:
    """The epsilon kernel's slot width for blocks of T sites: 32, 64 or 128,
    the least >= T (a lane owns TM / 32 sites; csrc/mme.cu mme_chain)."""
    if not 0 < T <= MAX_BLOCK:
        raise ValueError(f"mme_sweep: blocks of {T} sites (at most {MAX_BLOCK})")
    return 32 if T <= 32 else (64 if T <= 64 else 128)


def mme_site_owner(k: int, TM: int) -> tuple:
    """(lane, slot) of the drawer warp that holds site k's residual and dx
    in the epsilon chain (csrc/mme.cu mme_chain): lane l owns sites
    S l .. S l + S - 1, S = TM / 32."""
    S = TM // 32
    return k // S, k % S


def mme_plan_host(blk_ptr, urow, row_ptr, ent_col, ent_val, nbr: int, T: int) -> dict:
    """The epsilon sweep's host plan for diagonal blocks 0 .. nbr - 1 of a
    layout (numpy or CPU tensors: blk_ptr, urow, row_ptr, ent_col; ent_val
    float32).  Each forward row u of block i (target block tb = urow[u] // T)
    goes to one of three groups:

    * near (tb = i + 1 < nbr): the drawer sums its terms right after block
      i's draws and subtracts them from block i + 1's residual before its
      draws; packed in block i's record by target site k = urow[u] - tb T:
      ``nptr`` (TM + 1 offsets) and the (column, value bits) pairs;
    * two on (tb = i + 2 < nbr) and far (every other row, those past the
      swept blocks too): applied by the scatter warps in the phase after
      block i's draws, the former to block i + 2's residual in shared
      memory (a mask in the record), the latter to res in global memory;
      listed in ``far_rows`` as (row, first entry, end entry, tb or -1),
      block i's at rec[i, 0] .. rec[i, 1].

    Every row keeps its entries in stored order and each target its source
    blocks in sweep order.  Returns rec (nbr, RI) int32, far_rows (n, 4)
    int32 (at least one row), TM, RI, ncap (the most near entries of a
    block), dist (rows by target-block distance) and the counts of near,
    two-on and far rows."""
    as_np = lambda a: (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                       else np.asarray(a))
    TM = mme_tile(T)
    bp = as_np(blk_ptr).astype(np.int64)[:nbr + 1]
    urow, row_ptr = as_np(urow).astype(np.int64), as_np(row_ptr).astype(np.int64)
    ent_col = as_np(ent_col).astype(np.int64)
    ent_bits = np.ascontiguousarray(as_np(ent_val), dtype=np.float32).view(np.int32)
    if bp.shape[0] != nbr + 1 or (np.diff(bp) < 0).any():
        raise ValueError("mme_plan: blk_ptr must rise over nbr + 1 entries")
    u = np.arange(bp[0], bp[nbr])
    src = np.searchsorted(bp, u, side="right") - 1
    tgt = urow[u]
    tb = tgt // T
    if (tb <= src).any():
        raise ValueError("mme_plan: a triplet row is not below its block (forward rows only)")
    e0, e1 = row_ptr[u], row_ptr[u + 1]
    if (e1 < e0).any() or (ent_col[e0.min(initial=0):e1.max(initial=0)] >= T).any():
        raise ValueError("mme_plan: row pointers must rise and columns lie in the block")
    dist = tb - src
    near = (dist == 1) & (tb < nbr)
    two = (dist == 2) & (tb < nbr)
    far = ~near
    # the scatter's rows, block by block in stored order
    fu = np.flatnonzero(far)
    far_rows = np.stack([tgt[fu], e0[fu], e1[fu], np.where(two[fu], tb[fu], -1)], axis=1)
    fr_ptr = np.concatenate([[0], np.cumsum(np.bincount(src[fu], minlength=nbr))])
    # the near rows' entries per block, by target site
    nu = np.flatnonzero(near)
    ns, nk, nlen = src[nu], tgt[nu] - tb[nu] * T, e1[nu] - e0[nu]
    per_block = np.bincount(ns, weights=nlen, minlength=nbr).astype(np.int64)
    ncap = max(2, int(per_block.max(initial=0)))
    ncap += ncap % 2
    ent0 = MME_RECORD_HEAD + -(-(TM + 1) // 4) * 4
    RI = -(-(ent0 + 2 * ncap) // 4) * 4
    rec = np.zeros((nbr, RI), dtype=np.int64)
    rec[:, 0], rec[:, 1] = fr_ptr[:-1], fr_ptr[1:]
    cnt = np.zeros((nbr, TM), dtype=np.int64)
    cnt[ns, nk] = nlen
    rec[:, MME_RECORD_HEAD + 1:MME_RECORD_HEAD + TM + 1] = np.cumsum(cnt, axis=1)
    total = int(nlen.sum())
    if total:
        first = np.concatenate([[0], np.cumsum(nlen)[:-1]])
        eidx = np.repeat(e0[nu] - first, nlen) + np.arange(total)
        blk = np.repeat(ns, nlen)
        pos = np.arange(total) - np.concatenate([[0], np.cumsum(per_block)[:-1]])[blk]
        rec[blk, ent0 + 2 * pos] = ent_col[eidx]
        rec[blk, ent0 + 2 * pos + 1] = ent_bits[eidx]
    tu = np.flatnonzero(two)
    k2 = tgt[tu] - tb[tu] * T
    mask = np.zeros((nbr, 4), dtype=np.uint32)
    np.bitwise_or.at(mask, (src[tu], k2 // 32), (np.uint32(1) << (k2 % 32).astype(np.uint32)))
    rec[:, 4:8] = mask.view(np.int32)
    if far_rows.shape[0] == 0:
        far_rows = np.zeros((1, 4), dtype=np.int64)
    return {"rec": rec.astype(np.int32), "far_rows": far_rows.astype(np.int32), "TM": TM,
            "RI": RI, "ncap": ncap, "dist": np.bincount(dist, minlength=2),
            "near_rows": int(near.sum()), "two_rows": int(two.sum()),
            "far_rows_n": int(far.sum() - two.sum()),
            "max_row": int(tgt.max(initial=-1))}


@dataclass
class MmePlan:
    """The epsilon sweep's plan of one layout cut to nbr blocks
    (:func:`mme_plan`): the host plan's fields and its device tensors."""

    host: dict
    Dt: torch.Tensor        # (nbr, TM, TM): Dt[i, j, k] = diag_blocks[i, k, j], zero past T
    rec: torch.Tensor       # (nbr, RI) int32
    far_rows: torch.Tensor  # (n, 4) int32
    ent: torch.Tensor       # (nent, 2) int32: (column, value bits) of every triplet


# the plan of each layout (by the identity of its tensors and the blocks
# swept), with weak references to them and their versions: a sweep over the
# same layout reuses it; an entry goes with its diagonal blocks
_MME_PLANS = {}


def mme_plan(sp, nbr: int) -> MmePlan:
    """The plan of layout ``sp`` swept over blocks 0 .. nbr - 1, built on
    the first sweep (anew if one of its tensors is changed in place) and
    kept for the sweeps after it."""
    ts = (sp.diag_blocks, sp.blk_ptr, sp.urow, sp.row_ptr, sp.ent_col, sp.ent_val)
    key = tuple(id(t) for t in ts) + (nbr,)
    versions = tuple(t._version for t in ts)
    hit = _MME_PLANS.get(key)
    if hit is not None and all(r() is t for r, t in zip(hit[0], ts)) and hit[1] == versions:
        return hit[2]
    T = sp.diag_blocks.shape[1]
    host = mme_plan_host(sp.blk_ptr, sp.urow, sp.row_ptr, sp.ent_col, sp.ent_val, nbr, T)
    dev, TM = sp.diag_blocks.device, host["TM"]
    Dt = torch.zeros((nbr, TM, TM), dtype=F32, device=dev)
    Dt[:, :T, :T] = sp.diag_blocks[:nbr].transpose(1, 2)
    ent = torch.stack([sp.ent_col.to(torch.int32), sp.ent_val.contiguous().view(torch.int32)],
                      dim=1).contiguous()
    if ent.shape[0] == 0:
        ent = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    plan = MmePlan(host=host, Dt=Dt,
                   rec=torch.as_tensor(host["rec"], device=dev),
                   far_rows=torch.as_tensor(host["far_rows"], device=dev), ent=ent)
    _MME_PLANS[key] = (tuple(weakref.ref(t) for t in ts), versions, plan)
    weakref.finalize(sp.diag_blocks, _MME_PLANS.pop, key, None)
    return plan


@spanned("ops.mme_sweep")
def mme_sweep(sp, counts, scale, ve, z, x, res, stamps=None):
    """The epsilon sweep of ``blocked_mme_gibbs_sparse``
    (hibayes_tpu/engine/gibbs.py:576-654) after its residual, for one chain
    or a batch of K: for each diagonal block i in order, the T site draws
    of TPU kernel 10 against Wb = scale sp.diag_blocks[i] + diag(counts),
    then res[row] -= scale sum_k A[row, k] dx_k over the block's forward
    triplets.

    ``sp`` holds the layout of :class:`~hibayes_tpu_torch.engine.gibbs.EpslSparse`
    (diag_blocks (nbr, T, T); the triplets grouped by target row: blk_ptr,
    urow, row_ptr, ent_col, ent_val), shared by the chains, as ``counts``
    (nbr T,) is.  One chain: z, x (nbr T,); res the residual b - (scale A +
    diag(counts)) x, long enough for every triplet row; scale and ve 0-d
    tensors or floats.  K chains: z, x (K, nbr T), res (K, L), scale and ve
    (K,).  Returns (x_new, res after the sweep), shaped as x and res.  The
    sweep reads blk_ptr[0..nbr] only, so the first k blocks alone are a
    layout with diag_blocks[:k] and blk_ptr[:k + 1], and counts, z, x cut
    to k T.  On the card: float32 only, T <= 128, one launch (a CTA a
    chain, each chain bit for bit a one-chain launch on its inputs),
    ordered by :func:`mme_plan` of the layout (built at the first sweep
    over it).  ``stamps`` (measurement only; chain 0's): an int64 tensor of
    at least 6 (nbr + 1) + 4 entries that gets clock64 stamps per block
    (its chain's start and end and the drawer's end, the end of its
    scatter, and the ends of warp 3's and the loader's work in its phase),
    then %globaltimer ns and clock64 at the sweep's start and end."""
    if res.device.type == "cpu":
        return mme_sweep_plain(sp, counts, scale, ve, z, x, res)
    D = sp.diag_blocks
    _require_cuda(res, D, counts, z, x, sp.ent_val)
    nbr, T, _ = D.shape
    if not (0 < T <= MAX_BLOCK and 0 < nbr and sp.blk_ptr.shape[0] > nbr):
        raise ValueError(f"mme_sweep: blocks of {T} sites (at most {MAX_BLOCK}), "
                         f"{nbr} blocks and {sp.blk_ptr.shape[0]} block pointers")
    if any(t.dtype != F32 for t in (D, counts, z, x, res, sp.ent_val)):
        raise TypeError("mme_sweep: the kernel takes float32 (other float types "
                        "run on the CPU)")
    q = nbr * T
    lead = tuple(res.shape[:-1])
    K = res.shape[0] if lead else 1
    if (tuple(D.shape) != (nbr, T, T) or counts.shape != (q,) or res.dim() > 2
            or any(t.shape != lead + (q,) for t in (z, x)) or res.shape[-1] < q):
        raise ValueError(f"mme_sweep: blocks {tuple(D.shape)}, counts/z/x "
                         f"{tuple(counts.shape)}/{tuple(z.shape)}/{tuple(x.shape)} and "
                         f"res {tuple(res.shape)} do not fit")
    ints = (sp.blk_ptr, sp.urow, sp.row_ptr, sp.ent_col)
    if any(t.dtype != torch.int32 or t.device != res.device for t in ints):
        raise TypeError("mme_sweep: the triplet index arrays must be int32 on the card")
    if stamps is not None and (stamps.dtype != torch.int64 or stamps.device != res.device
                               or stamps.numel() < 6 * (nbr + 1) + 4):
        raise ValueError("mme_sweep: stamps must be int64 on the card, 6 per block + 10")
    dev = res.device
    plan = mme_plan(sp, nbr)
    if plan.host["max_row"] >= res.shape[-1]:
        raise ValueError(f"mme_sweep: a triplet row ({plan.host['max_row']}) lies past "
                         f"res ({res.shape[-1]})")
    lib = build.library("mme.cu")
    RI = plan.host["RI"]
    optin = getattr(torch.cuda.get_device_properties(dev), "shared_memory_per_block_optin",
                    SMEM_OPTIN)
    if lib.hb_mme_smem_bytes(T, RI) > optin:
        raise ValueError(f"mme_sweep: a block couples to the next through "
                         f"{plan.host['ncap']} entries; with blocks of {T} its staging "
                         f"needs {lib.hb_mme_smem_bytes(T, RI)} bytes of shared memory, "
                         f"more than the card's {optin}")
    scale_t = torch.as_tensor(scale, dtype=F32, device=dev).reshape(lead).contiguous()
    ve_t = torch.as_tensor(ve, dtype=F32, device=dev).reshape(lead).contiguous()
    cc, zc = counts.contiguous(), z.contiguous()
    x_in = x.contiguous()
    x_new = torch.empty_like(x_in)
    r = res.clone(memory_format=torch.contiguous_format)
    code = lib.hb_mme_sweep(
        plan.Dt.data_ptr(), plan.rec.data_ptr(), plan.far_rows.data_ptr(),
        plan.ent.data_ptr(), cc.data_ptr(), scale_t.data_ptr(), ve_t.data_ptr(),
        zc.data_ptr(), x_in.data_ptr(), x_new.data_ptr(), r.data_ptr(), r.shape[-1],
        plan.far_rows.shape[0], plan.ent.shape[0], nbr, T, RI, K,
        None if stamps is None else stamps.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, code, "mme_sweep")
    mme_sweep.launches += 1
    return x_new, r


mme_sweep.launches = 0


def mme_chain_latency(W, counts, z, scale, ve, r0, reps):
    """Measurement only: ``reps`` chains of one diagonal block's T draws
    (one warp, the block staged as the sweep stages it) back to back on the
    card, each from r0 and depending on the one before; W (T, T) the raw
    block of A, counts, z, r0 (T,).  Returns the clock64 cycles of the
    whole run (a 0-d int64 tensor)."""
    _require_cuda(W, counts, z, r0)
    T = W.shape[0]
    mme_tile(T)
    dev = r0.device
    lib = build.library("mme.cu")
    out = torch.empty((T,), dtype=F32, device=dev)
    cycles = torch.zeros((), dtype=torch.int64, device=dev)
    Wc, cc, zc, rc = (t.to(F32).contiguous() for t in (W, counts, z, r0))
    sc, vc = (torch.as_tensor(v, dtype=F32, device=dev).reshape(()) for v in (scale, ve))
    code = lib.hb_mme_chain_latency(Wc.data_ptr(), cc.data_ptr(), zc.data_ptr(), sc.data_ptr(),
                                    vc.data_ptr(), rc.data_ptr(), T, int(reps), out.data_ptr(),
                                    cycles.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, code, "mme_chain_latency")
    return cycles
