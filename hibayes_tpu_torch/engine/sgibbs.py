"""Summary-level MCMC engine (SBayes) over LD matrices: one device, one chain
or a batch of K chains.

PyTorch port of hibayes_tpu/engine/sgibbs.py (reference: src/SBayesD.cpp,
src/SBayesS.cpp).  The chain state is ``r_hat``, the adjusted X'y vector;
each SNP draw is followed by r_hat += (g_old - g_new) n LD[:, i]
(SBayesD.cpp:264-267).  Blocked, per block b of B SNPs:

    r_local = r_hat[block]
    for j in 0..B-1:  rhs = r_local[j] + xpx_j g_j; draw; r_local += dg n LD[block, j]
    r_hat  += n LD[:, block] dg_b

Dense, chi-square-pruned and chromosome-block LD live as padded dense
segments (``sweep_s_segment``); tiled sparse LD as its tile store
(``sweep_s_tiled``).  Both are CUDA kernels for tensors on a GPU and their
plain versions on the CPU (ops/blockgibbs.py).  SBayesS semantics (every
layout but DenseLD) are carried by ``varediff`` (per-SNP residual
inflation, SBayesS.cpp:131-141) and the rejection guard, which both sweeps
apply by the rule of the JAX package's tiled kernel: 8 pre-drawn candidates
(stream 15), the first that passes, else 0.  The JAX package runs its
segment layouts, and its chain batches on tiled LD (vmapped single
chains), through an XLA scan that redraws up to 100 times
(``_reject_redraw``); the two rules differ only where all 8 candidates
fail, which the sweeps count (``tally``).

Every random number of iteration ``it`` comes from an
:class:`~hibayes_tpu_torch.engine.rng.IterNoise`, as in engine/gibbs.py;
an iteration's functions take one chain's state or a batch's (a leading
chain axis, ``noise`` a list of one IterNoise per chain), as there.

On a mesh with a ``snp`` axis (parallel/mesh.py) each rank holds a
contiguous run of a tiled LD's tile rows and the ranks sweep them in turn,
or at once in merge rounds (``concurrent``), against the whole r_hat
(``sweep_s_tiled(..., row_base=)``), one chain; the rest of the chain
runs replicated.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from ..data.ld import BlockDiagLD, as_numpy
from ..data.sparse_ld import TiledSparseLD, _tensor
from ..math.distributions import inv_gaussian_from
from ..ops import blockgibbs
from ..parallel.distributed import all_gather, axis_sum, broadcast
from ..utils.profiling import span, spanned
from .gibbs import (_dot, _draw, alphabet_global_updates, batch_results, chain_noise,
                    check_chain_options, contiguous_state, pad_to_block, pip_counters,
                    posterior_rates, rhat_diagnostics, run_loop, stack_state)
from .rng import (STREAM_S_VARA, STREAM_SNP_CHI, STREAM_SNP_U, STREAM_SNP_Z,
                  STREAM_SNP_Z2, STREAM_SNP_ZR, STREAM_VE, IterNoise)


class SChainState(NamedTuple):
    """State of one summary chain.  ``it`` is a Python int; the rest are
    tensors on the chain's device."""

    it: int
    r_hat: torch.Tensor      # (m_pad,)
    g: torch.Tensor          # (m_pad,)
    varg: torch.Tensor
    vargL: torch.Tensor      # (m_pad,) BayesL local variances (size 0 otherwise)
    lambda2: torch.Tensor
    pi: torch.Tensor
    vara_fold: torch.Tensor
    vara: torch.Tensor
    vare: torch.Tensor
    track: torch.Tensor      # (m_pad,) int32
    nzrate: torch.Tensor     # (m_pad,)
    wppa: torch.Tensor       # (nw,)


class SGibbsData(NamedTuple):
    ld_segs: tuple           # per segment (mc_pad, mc_pad), covariance scale
    xy: torch.Tensor         # (m_pad,)
    xpx: torch.Tensor        # (m_pad,) = diag(LD) * n
    vx: torch.Tensor         # (m_pad,) = diag(LD), 0 for masked/padded SNPs
    real: torch.Tensor       # (m_pad,) bool: real AND estimable SNPs
    varediff: torch.Tensor   # (m_pad,)
    fold: torch.Tensor
    windindx0: torch.Tensor  # (m_pad,) int64
    yy: torch.Tensor         # scalar
    # tiled sparse LD (data/sparse_ld.py); ld_segs is () then
    ld_tiles: torch.Tensor | None = None   # (nbr, K_max, T, T)
    ld_cols: torch.Tensor | None = None    # (nbr, K_max) int32
    ld_valid: torch.Tensor | None = None   # (nbr, K_max) bool


def _segment(values, mc_pad: int, dtype, device) -> torch.Tensor:
    """One LD segment (numpy or torch) zero-padded to (mc_pad, mc_pad) on
    ``device``; no copy when it already has that size, type and place."""
    t = values if isinstance(values, torch.Tensor) else torch.from_numpy(
        np.asarray(values, dtype=np.float64))
    mc = t.shape[0]
    if mc == mc_pad:
        return t.to(device=device, dtype=dtype).contiguous()
    seg = torch.zeros((mc_pad, mc_pad), dtype=dtype, device=device)
    seg[:mc, :mc] = t.to(device=device, dtype=dtype)
    return seg


@spanned("model.prepare")
def prepare_sgibbs_data(sumstat, ld, *, fold=None, windindx=None, nw=0,
                        block=64, dtype=torch.float32, device="cpu"):
    """Initialise from COJO-style summary statistics and an LD object.

    sumstat: (m, 4) array of [MAF, BETA, SE, N].  Returns (data, n_eff,
    vary, nvar0, seg_sizes, seg_real).  Port of ``prepare_sgibbs_data``
    (hibayes_tpu/engine/sgibbs.py:78-188; reference src/SBayesD.cpp:92-115):
    the statistics in float64 numpy, then the device tensors.  An LD held
    as a tensor on ``device`` (dense values, or the tile store) is used in
    place when no padding or cast is needed."""
    device = torch.device(device)
    ss = np.asarray(sumstat, dtype=np.float64)
    m = ss.shape[0]
    if ld.m != m:
        raise ValueError("Number of SNPs not equals.")
    ncol = ss[:, 3]
    n_eff = int(np.round(np.nanmean(ncol[np.isfinite(ncol)])))
    est = np.isfinite(ss[:, 1]) & np.isfinite(ss[:, 2]) & np.isfinite(ss[:, 3])
    nvar0 = int((~est).sum())

    diag = np.asarray(ld.diag, dtype=np.float64)
    xpx = diag * n_eff
    xy = np.where(est, xpx * ss[:, 1], 0.0)
    yyi = np.where(est, xpx * (ss[:, 1] ** 2 + (ss[:, 3] - 2.0) * ss[:, 2] ** 2), 0.0)
    count_y = int(est.sum())
    if count_y == 0:
        raise ValueError("Lack of SE.")
    yy = float(yyi.sum() / count_y)
    vary = yy / (n_eff - 1)

    nnz = np.asarray(ld.nnz_per_col(), dtype=np.float64)
    varediff = (m - nnz) / m
    windindx = np.asarray(windindx) if windindx is not None else None

    def vec(a, dt=dtype):
        return torch.as_tensor(a, dtype=dt, device=device)

    def common(pads, m_pad):
        """Per-SNP vectors laid out by ``pads``: (offset, real, padded) per segment."""
        def lay(a, fill=0.0):
            return np.concatenate([np.pad(a[o:o + r], (0, p - r), constant_values=fill)
                                   for o, r, p in pads])
        return dict(
            xy=vec(lay(xy)), xpx=vec(lay(xpx)),
            vx=vec(lay(np.where(est, diag, 0.0))),
            real=vec(lay(est, False), torch.bool),
            varediff=vec(lay(varediff)),
            fold=vec(fold if fold is not None else np.zeros(2)),
            windindx0=(vec(lay(windindx - 1, nw), torch.int64) if windindx is not None
                       else torch.zeros((m_pad,), dtype=torch.int64, device=device)),
            yy=vec(yy),
        )

    if isinstance(ld, TiledSparseLD):
        if block != ld.tile:
            raise ValueError(f"block ({block}) must equal the LD tile size ({ld.tile})")
        m_pad = ld.m_pad
        data = SGibbsData(
            ld_segs=(), **common([(0, m, m_pad)], m_pad),
            ld_tiles=_tensor(ld.tiles, device, dtype).contiguous(),
            ld_cols=_tensor(ld.col_idx, device, torch.int32),
            ld_valid=_tensor(ld.valid, device, torch.bool),
        )
        return data, n_eff, vary, nvar0, (m_pad,), (m,)

    # segment layout: each chromosome block padded to a multiple of `block`
    raw = list(ld.blocks) if isinstance(ld, BlockDiagLD) else [ld.values]
    seg_real = tuple(int(b.shape[0]) for b in raw)
    seg_sizes = tuple(pad_to_block(mc, block) for mc in seg_real)
    offs = np.cumsum((0,) + seg_real[:-1])
    segs = tuple(_segment(b, p, dtype, device) for b, p in zip(raw, seg_sizes))
    data = SGibbsData(ld_segs=segs,
                      **common(list(zip(offs, seg_real, seg_sizes)), sum(seg_sizes)))
    return data, n_eff, vary, nvar0, seg_sizes, seg_real


def init_s_state(spec, data: SGibbsData, priors, pi_init) -> SChainState:
    dt, dev = data.xy.dtype, data.xy.device
    m_pad = spec.m_pad

    def full(shape, v):
        return torch.full(shape, float(v), dtype=dt, device=dev)

    return SChainState(
        it=0,
        r_hat=data.xy,  # r_hat starts at xy (SBayesD.cpp:106)
        g=full((m_pad,), 0.0),
        varg=full((), priors.varg),
        vargL=full((m_pad,) if spec.model_index == 5 else (0,), priors.varg),
        lambda2=full((), priors.lambda2),
        pi=torch.as_tensor(np.asarray(pi_init), dtype=dt, device=dev),
        vara_fold=full((), priors.varg) * data.fold,
        vara=full((), priors.vara),
        vare=full((), priors.vare),
        track=torch.zeros((m_pad,), dtype=torch.int32, device=dev),
        nzrate=full((m_pad,), 0.0),
        wppa=full((spec.nw,), 0.0),
    )


def _s_snapshot(spec, state: SChainState) -> dict:
    return {
        "pi": state.pi,
        "Vg": state.vara,
        "Ve": state.vare,
        "h2": state.vara / (state.vara + state.vare),
        "alpha": state.g,
        "lambda": torch.sqrt(state.lambda2),
    }


def _on_mesh(data: SGibbsData, mesh):
    """This rank's part of ``data`` and the mesh (None where it has one
    rank)."""
    if mesh is None or mesh.world == 1:
        return data, None
    from ..parallel.mesh import shard_sgibbs_data

    return shard_sgibbs_data(data, mesh), mesh


def tiles_cut(spec, data: SGibbsData) -> bool:
    """Whether ``data`` holds a part of its tiled LD's tile rows."""
    return (data.ld_tiles is not None
            and int(data.ld_tiles.shape[0]) * int(data.ld_tiles.shape[2]) != spec.m_pad)


def _tiled_sweep_snp_sharded(spec, data: SGibbsData, r_hat, P, mesh, tally=None):
    """The SNP-sharded tiled sweep of one chain
    (``_tiled_sweep_snp_sharded``, hibayes_tpu/engine/sgibbs.py:470-648):
    rank s of the ``snp`` axis holds tile rows [s nl, (s + 1) nl), swept by
    TPU kernel 9 at their ``row_base`` (``blockgibbs.sweep_s_tiled``).

    turn (exact): in turn t the rank of index t sweeps its rows against the
    whole r_hat, the others wait, and r_hat reaches every rank by a
    broadcast from it (the owner's values bit for bit, where the JAX
    package merges r + psum(r2 - r)).

    concurrent: in each of Rm = ``spec.merge_rounds`` rounds every rank
    sweeps its next nl/Rm rows at once against the round-start r_hat, and
    the ranks merge by r + axis_sum(r2 - r) (hibayes_tpu/engine/sgibbs.py:
    573-614).  Near-exact here: only LD tiles that span a shard boundary
    couple the shards.  The rounds' rows are views made once per store
    (``blockgibbs.tile_row_runs``), so every sweep finds its schedule.

    ``P`` holds the packed and guard rows of all m_pad SNPs (the guard's
    candidates drawn over the whole m_pad, stream 15, as one device draws
    them).  Returns (dg, track, r_hat) over all SNPs, gathered on every
    rank; the guard counts of every shard go into ``tally``."""
    if spec.shard_schedule == "pipeline":
        raise ValueError(
            "shard_schedule='pipeline' is an individual-level (ibrm) schedule; the "
            "summary engine supports 'turn' (exact) and 'concurrent' (near-exact here: "
            "cross-shard coupling is bounded by LD tiles spanning shard boundaries)")
    S, s = mesh.size("snp"), mesh.index("snp")
    nl, B = int(data.ld_tiles.shape[0]), int(data.ld_tiles.shape[2])
    base = s * nl
    P_loc = P[..., base * B:(base + nl) * B]
    own = None if tally is None else torch.zeros_like(tally)
    if spec.shard_schedule == "concurrent":
        Rm = spec.merge_rounds
        if nl % Rm:
            raise ValueError(f"merge_rounds ({Rm}) must divide the {nl} local LD tile rows")
        nb_g = nl // Rm
        parts = []
        for r, rows in enumerate(blockgibbs.tile_row_runs(data.ld_tiles, data.ld_cols,
                                                          data.ld_valid, Rm)):
            dg, track, rh2, _ = blockgibbs.sweep_s_tiled(
                spec, *rows, r_hat, P_loc[..., r * nb_g * B:(r + 1) * nb_g * B], spec.n,
                tally=own, row_base=base + r * nb_g)
            r_hat = r_hat + axis_sum(rh2 - r_hat, mesh, "snp")
            parts.append((dg, track))
        dg, track = (torch.cat(x) for x in zip(*parts))
    else:
        for t in range(S):
            if t == s:
                dg, track, r_hat, _ = blockgibbs.sweep_s_tiled(
                    spec, data.ld_tiles, data.ld_cols, data.ld_valid, r_hat, P_loc, spec.n,
                    tally=own, row_base=base)
            r_hat = broadcast(r_hat, mesh, "snp", t)
    if tally is not None:
        tally += axis_sum(own, mesh, "snp")
    return (all_gather(dg, mesh, "snp"), all_gather(track, mesh, "snp"), r_hat)


def _s_pre_sweep(spec, data: SGibbsData, noise, state: SChainState) -> dict:
    """The sweep's random numbers, constants and packed rows
    (hibayes_tpu/engine/sgibbs.py:197-241 and the packing of :268-281), for
    one chain (P (R, m_pad)) or a batch (P (K, R, m_pad))."""
    dt, dev = data.xy.dtype, data.xy.device
    m_pad, mi = spec.m_pad, spec.model_index
    lead = tuple(state.vara.shape)
    full = lambda v: torch.full(lead + (m_pad,), v, dtype=dt, device=dev)
    z_snp = _draw(noise, lambda nz: nz.normal(STREAM_SNP_Z, (m_pad,)))
    if mi == 6:  # BayesR Gumbel-max fold selection: n_fold uniforms per SNP
        u_snp = _draw(noise, lambda nz: nz.uniform(STREAM_SNP_U, (m_pad, spec.n_fold)))
    elif mi in (3, 4, 5) or spec.reject_guard:
        u_snp = _draw(noise, lambda nz: nz.uniform(STREAM_SNP_U, (m_pad,)))
    else:
        u_snp = full(0.5)
    if mi in (2, 3):
        chi_snp = _draw(noise, lambda nz: nz.chisq(STREAM_SNP_CHI, spec.dfvara + 1.0, (m_pad,)))
    else:
        chi_snp = full(1.0)
    if mi == 5:
        z2_snp = _draw(noise, lambda nz: nz.normal(STREAM_SNP_Z2, (m_pad,)))
    else:
        z2_snp = full(0.0)

    # per-SNP residual variance varediff * vara + vare (SBayesS.cpp:285);
    # varediff == 0 for dense LD reduces it to vare (SBayesD semantics)
    vei = data.varediff * state.vara[..., None] + state.vare[..., None]
    chains = (lambda v: v) if lead else (lambda v: v[None])   # the pack's chain axis
    consts_b = {
        "varg": chains(state.varg),
        "s2varg_df": torch.full(lead or (1,), spec.s2varg * spec.dfvara, dtype=dt,
                                device=dev),
        "logpi": chains(torch.log(state.pi)),
        "lambda2": chains(state.lambda2),
        "vara_fold": chains(state.vara_fold),
        "fold": data.fold.expand((lead or (1,)) + tuple(data.fold.shape)),
    }
    vargL_full = (state.vargL if state.vargL.numel()
                  else torch.zeros(lead + (m_pad,), dtype=dt, device=dev))
    P = blockgibbs.pack_rows(spec, consts_b, data.xpx, data.vx, chains(vei),
                             chains(state.g), chains(z_snp), chains(u_snp),
                             chains(chi_snp), chains(vargL_full), dt)
    if blockgibbs.guard_on(spec):   # the guard's candidates (every SBayesS layout)
        z_retry = _draw(noise, lambda nz: nz.normal(STREAM_SNP_ZR, (blockgibbs.N_RETRY, m_pad)))
        P = torch.cat([P, blockgibbs.pack_retry_rows(
            spec, consts_b, data.xpx, data.vx, chains(vei), chains(z_retry), dt)], dim=1)
    return {"P": P if lead else P[0], "vei": vei, "vargL_full": vargL_full,
            "rnd": (z_snp, u_snp, chi_snp, z2_snp)}


def _s_sweep_accums(spec, data: SGibbsData, state: SChainState, vei, g, track,
                    u_snp, z2_snp, vargL_full):
    """Order-independent post-sweep accumulators: BayesC's nonzero-effect
    variance sum, BayesR's per-fold sum, BayesL's per-SNP inverse-Gaussian
    local variances (``_s_sweep_accums``, hibayes_tpu/engine/sgibbs.py:650-683)."""
    dt, dev = data.xy.dtype, data.xy.device
    mi = spec.model_index
    zero = torch.zeros((), dtype=dt, device=dev)
    vargi_acc = torch.where(track == 1, g * g, zero).sum(-1) if mi == 4 else zero
    if mi == 6:
        ffold = data.fold[track.long()]
        vargR_acc = torch.where(track > 0, g * g / torch.clamp_min(ffold, 1e-30),
                                zero).sum(-1)
    else:
        vargR_acc = zero
    if mi == 5 and state.vargL.numel():
        lam2 = state.lambda2[..., None]
        mu_ig = torch.sqrt(vei) * torch.sqrt(lam2) / torch.clamp_min(torch.abs(g), 1e-30)
        vargi = 1.0 / inv_gaussian_from(z2_snp, u_snp, mu_ig, lam2)
        ok = (vargi > 0) if spec.vargl_strict_pos else (vargi >= 0)
        vargL = torch.where((data.vx > 0) & ok, vargi, vargL_full)
    else:
        vargL = state.vargL
    return vargi_acc, vargR_acc, vargL


def _s_finish(spec, data: SGibbsData, noise, state: SChainState, g, track,
              vargL, r_hat, vargi_acc, vargR_acc) -> SChainState:
    """Post-sweep global updates: mixture and variance hyper-updates, Vg/Ve
    draws from quadratic forms in r_hat with the negative-Ve guard
    (SBayesD.cpp:458-468), PIP/WPPA counters
    (``_s_finish``, hibayes_tpu/engine/sgibbs.py:686-723)."""
    n = spec.n
    varg, pi, vara_fold, lambda2 = alphabet_global_updates(
        spec, noise, g, track, data.real, data.fold, vargi_acc, vargR_acc,
        vargL if state.vargL.numel() else torch.zeros_like(g),
        state.varg, state.pi, state.vara_fold, state.lambda2,
    )
    chi_a = _draw(noise, lambda nz: nz.chisq(STREAM_S_VARA, n + spec.dfvara))
    vara = (_dot(g, data.xy - r_hat) + spec.s2vara * spec.dfvara) / chi_a
    chi_e = _draw(noise, lambda nz: nz.chisq(STREAM_VE, n + spec.dfvare))
    vare = (data.yy - _dot(g, data.xy + r_hat) + spec.s2vare * spec.dfvare) / chi_e
    vare = torch.where(vare < 0, 0.5 * vara, vare)
    nzrate, wppa = pip_counters(spec, data, state, track)
    return contiguous_state(SChainState(
        it=state.it + 1, r_hat=r_hat, g=g, varg=varg, vargL=vargL,
        lambda2=lambda2, pi=pi, vara_fold=vara_fold, vara=vara, vare=vare,
        track=track, nzrate=nzrate, wppa=wppa,
    ))


def one_s_iteration(spec, data: SGibbsData, seed: int, state: SChainState,
                    noise=None, mesh=None, tally=None) -> SChainState:
    """One summary iteration of one chain: the sweep's random numbers and
    packed rows, the segment or tiled sweep, the global updates.  ``noise``
    defaults to the port's own streams for (seed, state.it).  ``tally``
    (optional, int64 (2,) on the chain's device) gets the guard's counts
    added (first draws rejected, draws whose every candidate failed).  On
    a mesh every rank calls it alike (``data`` whole or this rank's part:
    ``shard_sgibbs_data``)."""
    with span("engine.iteration", it=state.it):
        data, mesh = _on_mesh(data, mesh)
        if noise is None:
            noise = IterNoise(seed, state.it, data.xy.device, data.xy.dtype)
        return _s_iteration(spec, data, noise, state, tally, mesh)


def one_s_iteration_batch(spec, data: SGibbsData, seed: int, states: SChainState,
                          noise=None, tally=None) -> SChainState:
    """One summary iteration of K chains (``one_s_iteration_batch``,
    hibayes_tpu/engine/sgibbs.py:732-838): ``states`` holds a leading chain
    axis; each segment is one K-chain ``sweep_s_segment``, a tiled LD one
    K-chain ``sweep_s_tiled`` (where the JAX package runs vmapped single
    chains through its guarded XLA scan, which redraws up to 100 times: the
    port keeps its 8-candidate guard, whose exhausted draws ``tally``
    counts).  ``noise`` defaults to each chain's own streams; ``tally`` is
    (K, 2)."""
    K = int(states.vara.shape[0])
    with span("engine.iteration", it=states.it):
        if noise is None:
            noise = chain_noise(seed, states.it, K, data.xy.device, data.xy.dtype)
        return _s_iteration(spec, data, noise, states, tally)


def _s_iteration(spec, data: SGibbsData, noise, state: SChainState,
                 tally=None, mesh=None) -> SChainState:
    with span("engine.pre_sweep"):
        pre = _s_pre_sweep(spec, data, noise, state)
    P = pre["P"]
    with span("engine.sweep"):
        if mesh is not None and tiles_cut(spec, data):
            dg, track, r_hat = _tiled_sweep_snp_sharded(spec, data, state.r_hat, P, mesh,
                                                        tally)
        elif data.ld_tiles is not None:
            dg, track, r_hat, _ = blockgibbs.sweep_s_tiled(
                spec, data.ld_tiles, data.ld_cols, data.ld_valid, state.r_hat, P, spec.n,
                tally=tally)
        else:
            parts, off = [], 0
            for seg, mc in zip(data.ld_segs, spec.seg_sizes):
                sl = slice(off, off + mc)
                parts.append(blockgibbs.sweep_s_segment(spec, seg, state.r_hat[..., sl],
                                                        P[..., sl], spec.n, tally=tally))
                off += mc
            dg, track, r_hat = (torch.cat(x, dim=-1) for x in zip(*parts))
    with span("engine.post_sweep"):
        g = state.g - dg.to(state.g.dtype)
        _, u_snp, _, z2_snp = pre["rnd"]
        vargi_acc, vargR_acc, vargL = _s_sweep_accums(
            spec, data, state, pre["vei"], g, track, u_snp, z2_snp, pre["vargL_full"])
        return _s_finish(spec, data, noise, state, g, track, vargL,
                         r_hat.to(state.r_hat.dtype), vargi_acc, vargR_acc)


def segment_unpad_index(spec) -> np.ndarray:
    """Indices of the real SNPs within the segment-padded layout."""
    idx, off = [], 0
    for mc_pad, mc_real in zip(spec.seg_sizes, spec.seg_real):
        idx.extend(range(off, off + mc_real))
        off += mc_pad
    return np.asarray(idx, dtype=np.int64)


def run_s_chain(spec, data: SGibbsData, priors, pi_init, seed=666666,
                progress=False, chunk_records=0, mesh=None, checkpoint_path=None):
    """Run one summary chain; returns (final_state, samples, extras), as
    ``run_s_chain`` (hibayes_tpu/engine/sgibbs.py:1011-1062).  ``extras``
    holds pip, wppa, nzct, the chain's wall ``seconds``, taken once the
    device has finished its iterations, and ``guard``: the guard's counts
    over the chain (first draws rejected, draws whose every candidate
    failed; zeros without the guard).  ``checkpoint_path`` saves and
    resumes the chain with its guard counts (:func:`~.gibbs.run_loop`).  On
    a mesh every rank calls it alike; rank 0 writes the checkpoint."""
    data, mesh = _on_mesh(data, mesh)
    tally = torch.zeros((2,), dtype=torch.int64, device=data.xy.device)
    state, samples, seconds = run_loop(
        spec, init_s_state(spec, data, priors, pi_init),
        lambda st: one_s_iteration(spec, data, seed, st, tally=tally, mesh=mesh),
        lambda st: _s_snapshot(spec, st), progress, chunk_records, checkpoint_path,
        carry={"tally": tally}, mesh=mesh)
    if not bool(torch.isfinite(state.vare)):
        warnings.warn("chain diverged: residual variance is non-finite at the "
                      "final iteration", UserWarning, stacklevel=2)
    pip, wppa, nzct = posterior_rates(spec, state)
    real_cols = segment_unpad_index(spec)
    if samples:
        samples["alpha"] = samples["alpha"][:, real_cols]
    extras = {"pip": as_numpy(pip)[real_cols], "wppa": as_numpy(wppa),
              "nzct": nzct, "seconds": seconds, "guard": as_numpy(tally)}
    return state, samples, extras


def run_s_chains(spec, data: SGibbsData, priors, pi_init, seed=666666, nchains=4,
                 checkpoint_path=None, progress=False, chunk_records=0, mesh=None):
    """Run ``nchains`` independent summary chains as one batch on any LD
    layout (``run_s_chains``, hibayes_tpu/engine/sgibbs.py:874-927).  Returns (states, samples,
    extras) as :func:`~hibayes_tpu_torch.engine.gibbs.run_chains`: samples
    (nchains, n_records, ...), pip and wppa averaged over chains, ``rhat``,
    the wall ``seconds`` and ``guard`` (nchains, 2), each chain's guard
    counts, which a checkpoint carries.  One chain runs :func:`run_s_chain`,
    with the chain axis added (on ``mesh``, where given); a batch runs on
    one device."""
    check_chain_options(nchains, mesh)
    if nchains > 1 and mesh is not None:
        raise ValueError("run_s_chains(nchains > 1, mesh=...): the summary chain batch "
                         "runs on one device; run one chain on a mesh")
    if nchains == 1:
        state, samples, extras = run_s_chain(spec, data, priors, pi_init, seed=seed,
                                             progress=progress, chunk_records=chunk_records,
                                             checkpoint_path=checkpoint_path, mesh=mesh)
        samples = {k: v[None] for k, v in samples.items()}
        return (stack_state(state, 1), samples,
                {**extras, "rhat": rhat_diagnostics(samples), "guard": extras["guard"][None]})
    tally = torch.zeros((nchains, 2), dtype=torch.int64, device=data.xy.device)
    states, samples, seconds = run_loop(
        spec, stack_state(init_s_state(spec, data, priors, pi_init), nchains),
        lambda ss: one_s_iteration_batch(spec, data, seed, ss, tally=tally),
        lambda ss: _s_snapshot(spec, ss), progress, chunk_records, checkpoint_path,
        carry={"tally": tally})
    samples, extras = batch_results(spec, states, samples, segment_unpad_index(spec),
                                    seconds)
    return states, samples, {**extras, "guard": as_numpy(tally)}
