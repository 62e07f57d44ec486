"""Summary-level MCMC engine (SBayes) over LD matrices: one device, one chain
or (on dense and block-segment LD) a batch of K chains.

PyTorch port of hibayes_tpu/engine/sgibbs.py (reference: src/SBayesD.cpp,
src/SBayesS.cpp).  The chain state is ``r_hat``, the adjusted X'y vector;
each SNP draw is followed by r_hat += (g_old - g_new) n LD[:, i]
(SBayesD.cpp:264-267).  Blocked, per block b of B SNPs:

    r_local = r_hat[block]
    for j in 0..B-1:  rhs = r_local[j] + xpx_j g_j; draw; r_local += dg n LD[block, j]
    r_hat  += n LD[:, block] dg_b

Dense and chromosome-block LD live as padded dense segments
(``sweep_s_segment``); tiled sparse LD as its tile store, swept with the
SBayesS rejection guard (``sweep_s_tiled``).  Both are CUDA kernels for
tensors on a GPU and their plain versions on the CPU (ops/blockgibbs.py).
SBayesS semantics are carried by ``varediff`` (per-SNP residual inflation,
SBayesS.cpp:131-141) and the guard.

Every random number of iteration ``it`` comes from an
:class:`~hibayes_tpu_torch.engine.rng.IterNoise`, as in engine/gibbs.py;
an iteration's functions take one chain's state or a batch's (a leading
chain axis, ``noise`` a list of one IterNoise per chain), as there.
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
from .gibbs import (_dot, _draw, alphabet_global_updates, batch_results, chain_noise,
                    check_chain_options, pad_to_block, pip_counters, posterior_rates,
                    rhat_diagnostics, run_loop, stack_state)
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


def _check_ported(spec, data: SGibbsData, mesh=None, nchains: int = 1) -> None:
    """Raise for the summary configurations whose code paths are still to
    be ported (ROADMAP.md, queue 1)."""
    if nchains > 1 and data.ld_tiles is not None:
        raise NotImplementedError(
            "a chain batch on a tiled LD is not ported yet: the JAX package runs "
            "it as vmapped single chains through the XLA scan with _reject_redraw, "
            "whose guard has no kernel here (ROADMAP queue 1, item 6 with item 16)")
    if mesh is not None or spec.emulate_shards > 1 or spec.shard_schedule != "turn":
        raise NotImplementedError(
            "meshes and shard schedules are not ported yet (ROADMAP queue 1, "
            "items 13-14)")
    if data.ld_tiles is None and spec.reject_guard:
        raise NotImplementedError(
            "MCMC on SparseLD or BlockDiagLD runs the JAX package's guarded "
            "per-SNP scan (_reject_redraw), which is not ported yet (ROADMAP "
            "queue 1, item 16); method='CG' runs on them")
    if data.ld_tiles is not None and spec.block % 128:
        raise NotImplementedError(
            f"a tiled LD with tile {spec.block} (not a multiple of 128) runs "
            "the JAX package's guarded per-SNP scan, which is not ported yet "
            "(ROADMAP queue 1, item 16)")


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
    if data.ld_tiles is not None and blockgibbs.guard_on(spec):
        z_retry = noise.normal(STREAM_SNP_ZR, (blockgibbs.N_RETRY, m_pad))
        P = torch.cat([P, blockgibbs.pack_retry_rows(
            spec, consts_b, data.xpx, data.vx, vei[None], z_retry[None], dt)], dim=1)
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
    return SChainState(
        it=state.it + 1, r_hat=r_hat, g=g, varg=varg, vargL=vargL,
        lambda2=lambda2, pi=pi, vara_fold=vara_fold, vara=vara, vare=vare,
        track=track, nzrate=nzrate, wppa=wppa,
    )


def one_s_iteration(spec, data: SGibbsData, seed: int, state: SChainState,
                    noise=None, mesh=None) -> SChainState:
    """One summary iteration of one chain: the sweep's random numbers and
    packed rows, the segment or tiled sweep, the global updates.  ``noise``
    defaults to the port's own streams for (seed, state.it)."""
    _check_ported(spec, data, mesh)
    if noise is None:
        noise = IterNoise(seed, state.it, data.xy.device, data.xy.dtype)
    return _s_iteration(spec, data, noise, state)


def one_s_iteration_batch(spec, data: SGibbsData, seed: int, states: SChainState,
                          noise=None) -> SChainState:
    """One summary iteration of K chains on dense or block-segment LD
    (``one_s_iteration_batch``, hibayes_tpu/engine/sgibbs.py:732-838):
    ``states`` holds a leading chain axis; each segment is one K-chain
    ``sweep_s_segment``.  ``noise`` defaults to each chain's own streams."""
    K = int(states.vara.shape[0])
    _check_ported(spec, data, None, K)
    if noise is None:
        noise = chain_noise(seed, states.it, K, data.xy.device, data.xy.dtype)
    return _s_iteration(spec, data, noise, states)


def _s_iteration(spec, data: SGibbsData, noise, state: SChainState) -> SChainState:
    pre = _s_pre_sweep(spec, data, noise, state)
    P = pre["P"]
    if data.ld_tiles is not None:
        dg, track, r_hat, _ = blockgibbs.sweep_s_tiled(
            spec, data.ld_tiles, data.ld_cols, data.ld_valid, state.r_hat, P, spec.n)
    else:
        parts, off = [], 0
        for seg, mc in zip(data.ld_segs, spec.seg_sizes):
            sl = slice(off, off + mc)
            parts.append(blockgibbs.sweep_s_segment(spec, seg, state.r_hat[..., sl],
                                                    P[..., sl], spec.n))
            off += mc
        dg, track, r_hat = (torch.cat(x, dim=-1) for x in zip(*parts))
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
                progress=False, chunk_records=0, mesh=None):
    """Run one summary chain; returns (final_state, samples, extras), as
    ``run_s_chain`` (hibayes_tpu/engine/sgibbs.py:1011-1062) without
    checkpoints.  ``extras`` holds pip, wppa, nzct and the chain's wall
    ``seconds``, taken once the device has finished its iterations."""
    _check_ported(spec, data, mesh)
    state, samples, seconds = run_loop(
        spec, init_s_state(spec, data, priors, pi_init),
        lambda st: one_s_iteration(spec, data, seed, st), lambda st: _s_snapshot(spec, st),
        progress, chunk_records)
    if not bool(torch.isfinite(state.vare)):
        warnings.warn("chain diverged: residual variance is non-finite at the "
                      "final iteration", UserWarning, stacklevel=2)
    pip, wppa, nzct = posterior_rates(spec, state)
    real_cols = segment_unpad_index(spec)
    if samples:
        samples["alpha"] = samples["alpha"][:, real_cols]
    extras = {"pip": as_numpy(pip)[real_cols], "wppa": as_numpy(wppa),
              "nzct": nzct, "seconds": seconds}
    return state, samples, extras


def run_s_chains(spec, data: SGibbsData, priors, pi_init, seed=666666, nchains=4,
                 checkpoint_path=None, progress=False, chunk_records=0, mesh=None):
    """Run ``nchains`` independent summary chains as one batch on dense or
    block-segment LD (``run_s_chains``, hibayes_tpu/engine/sgibbs.py:874-927,
    without checkpoints).  Returns (states, samples, extras) as
    :func:`~hibayes_tpu_torch.engine.gibbs.run_chains`: samples (nchains,
    n_records, ...), pip and wppa averaged over chains, ``rhat`` and the wall
    ``seconds``.  One chain runs :func:`run_s_chain`, with the chain axis
    added."""
    check_chain_options(nchains, mesh, checkpoint_path, progress)
    if nchains == 1:
        state, samples, extras = run_s_chain(spec, data, priors, pi_init, seed=seed)
        samples = {k: v[None] for k, v in samples.items()}
        return (stack_state(state, 1), samples,
                {**extras, "rhat": rhat_diagnostics(samples)})
    _check_ported(spec, data, mesh, nchains)
    states, samples, seconds = run_loop(
        spec, stack_state(init_s_state(spec, data, priors, pi_init), nchains),
        lambda ss: one_s_iteration_batch(spec, data, seed, ss),
        lambda ss: _s_snapshot(spec, ss))
    samples, extras = batch_results(spec, states, samples, segment_unpad_index(spec),
                                    seconds)
    return states, samples, extras
