"""`sbrm`: summary-level Bayesian regression over LD matrices.

PyTorch port of hibayes_tpu/model/sbrm.py on one device, for one chain
or a batch of chains with R-hat (reference
front end: R/sbayes.r:101-239): LD-type dispatch (dense ->
SBayesD semantics; chi-square-pruned, chromosome-block or tiled -> SBayesS
semantics with varediff inflation and the rejection guard), windows,
defaults, and the conjugate-gradient solver (method="CG", src/cg.cpp).

MCMC runs on DenseLD, SparseLD and BlockDiagLD (the dense segment sweep,
one segment per chromosome block) and on TiledSparseLD (the tiled sweep,
any tile: other tiles than it takes are re-tiled,
ops/blockgibbs.py:sub_block_tiles), one chain or a batch.  Every
layout but DenseLD applies the SBayesS rejection guard
by the rule of the JAX package's tiled kernel (8 pre-drawn candidates); the
JAX package's per-SNP scan on SparseLD and BlockDiagLD redraws up to 100
times, and the two differ only where all 8 candidates fail (counted in
``BlrMod.guard``).  "CG" runs on all four.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.ld import BlockDiagLD, DenseLD, SparseLD
from ..data.sparse_ld import TiledSparseLD, _tensor, _tiled_matvec
from ..data.sumstats import sumstat_matrix
from ..engine import gibbs as G
from ..engine import sgibbs as SG
from ..math.solvers import conj_grad
from .ibrm import _resolve_windows, pool_chains, resolve_device, resolve_iteration_defaults
from .results import BlrMod

S_METHODS = (
    "BayesB", "BayesA", "BayesL", "BayesRR", "BayesBpi", "BayesC",
    "BayesCpi", "BayesR", "CG",
)

# above this SNP count a scipy-sparse LD goes to the O(nnz) tiled layout:
# SparseLD.from_scipy densifies to (m, m)
_SPARSE_DENSIFY_LIMIT = 20_000


def _coerce_ld(ldm):
    """An LD object from what the caller passed (``_coerce_ld``,
    hibayes_tpu/model/sbrm.py:39-56); a square torch tensor is a DenseLD
    kept where it is."""
    if isinstance(ldm, (DenseLD, SparseLD, BlockDiagLD, TiledSparseLD)):
        return ldm
    if isinstance(ldm, torch.Tensor):
        if ldm.ndim == 2 and ldm.shape[0] == ldm.shape[1]:
            return DenseLD(values=ldm)
        raise TypeError("Unrecognized type of ldm.")
    try:
        import scipy.sparse as sp

        if sp.issparse(ldm):
            if ldm.shape[0] > _SPARSE_DENSIFY_LIMIT:
                return TiledSparseLD.from_scipy(ldm, tile=128)
            return SparseLD.from_scipy(ldm)
    except ImportError:
        pass
    arr = np.asarray(ldm)
    if arr.ndim == 2 and arr.shape[0] == arr.shape[1]:
        return DenseLD(values=arr.astype(np.float64))
    raise TypeError("Unrecognized type of ldm.")


def sbrm(
    sumstat,
    ldm,
    method="BayesCpi",
    map=None,
    Pi=None,
    lambda_=None,
    fold=None,
    niter=None,
    nburn=None,
    thin=5,
    windsize=None,
    windnum=None,
    vg=None,
    dfvg=None,
    s2vg=None,
    ve=None,
    dfve=None,
    s2ve=None,
    printfreq=100,
    seed=666666,
    threads=0,
    verbose=True,
    block=64,
    dtype=torch.float32,
    nchains=1,
    checkpoint=None,
    progress=False,
    mesh=None,
    shard_schedule="turn",
    merge_rounds=1,
    device=None,
) -> BlrMod:
    """Fit summary-level chains on ``device`` (default "cuda"; the CPU only
    when asked for with device="cpu").  ``ldm`` is a DenseLD, SparseLD,
    BlockDiagLD or TiledSparseLD, a scipy sparse matrix, or a square numpy
    array or torch tensor (a tensor on the card is used in place).  On the
    card the sweep kernels take float32 only.  ``nchains > 1`` runs that
    many chains as one batch on any LD layout (``run_s_chains``): the summaries pool every chain's records and
    ``rhat`` holds each parameter's split R-hat.  ``guard`` holds each
    chain's guard counts (draws whose first candidate was rejected, and of
    those the ones whose 8 candidates all failed).  ``checkpoint`` (a path
    prefix) saves the chain or batch, with those counts, after every
    ``printfreq`` iterations (a tenth of the records for a batch) and
    resumes it from there, bit for bit.  ``threads`` (the JAX package's host codec
    threads) is accepted and unused.  ``mesh`` (parallel/mesh.py, every rank
    calling sbrm alike) shards a tiled LD's tile rows over its ``snp`` axis,
    one chain only, as in the JAX package; ``shard_schedule`` is how the
    shards sweep: "turn" (exact, in turn) or "concurrent" (all shards sweep
    against the r_hat of the round's start, ``merge_rounds`` merges an
    iteration; near-exact here, as only LD tiles that span a shard boundary
    couple the shards).  Without a mesh, or on an LD that is not tiled,
    both run the exact sweep.  Rank 0 alone prints."""
    if method not in S_METHODS:
        raise ValueError(f"unknown method '{method}'; choose from {S_METHODS}")
    device = resolve_device(device)
    ld = _coerce_ld(ldm)
    ss = sumstat_matrix(sumstat)
    m = ss.shape[0]
    if ld.m != m:
        raise ValueError("Number of SNPs not equals.")
    sparse_semantics = isinstance(ld, (SparseLD, BlockDiagLD, TiledSparseLD))
    if isinstance(ld, TiledSparseLD):
        block = ld.tile  # the sweep block IS the LD tile

    windindx, windinfo, nw = _resolve_windows(method, map, windsize, windnum, m)

    if method == "CG":
        return _fit_cg(ss, ld, lambda_, verbose, device)

    if nchains > 1 and mesh is not None:
        raise ValueError(
            "sbrm(nchains>1, mesh=...) is not supported: the summary "
            "multi-chain runner executes single-device.  Run one chain "
            "with mesh=, or multiple chains without a mesh.")
    verbose = verbose and (mesh is None or mesh.rank == 0)
    if device.type == "cuda" and dtype != torch.float32:
        raise TypeError("on the card the sbrm sweep kernels take float32 only")

    niter, nburn, Pi, fold = resolve_iteration_defaults(method, niter, nburn, thin, Pi, fold)
    if method in ("BayesRR", "BayesA", "BayesL"):
        Pi = np.array([0.0, 1.0])
        fixpi = True
    else:
        fixpi = method in ("BayesB", "BayesC")

    data, n_eff, vary, nvar0, seg_sizes, seg_real = SG.prepare_sgibbs_data(
        ss, ld, fold=fold, windindx=windindx, nw=nw, block=block, dtype=dtype,
        device=device,
    )
    sumvx = float(np.sum(np.asarray(ld.diag)))
    # summary-level prior defaulting (src/SBayesD.cpp:116-152)
    pr = G.resolve_priors(
        None, sumvx, float(Pi[0]), nr=0,
        vg=vg, dfvg=dfvg, s2vg=s2vg, ve=ve, dfve=dfve, s2ve=s2ve, vary=vary,
    )
    spec = G.GibbsSpec(
        model=method, n=n_eff, m=m, m_pad=int(sum(seg_sizes)), block=block,
        nc=0, nlevels=(), n_fold=len(Pi), niter=niter, nburn=nburn, thin=thin,
        nvar0=nvar0, nw=nw, fixpi=fixpi,
        dfvara=pr.dfvara, s2vara=pr.s2vara, dfvare=pr.dfvare, s2vare=pr.s2vare,
        s2varg=pr.s2varg, lambda_rate0=pr.lambda_rate0,
        vargl_strict_pos=True, real_excl_nvar0=True,
        reject_guard=sparse_semantics, vary=vary,
        seg_sizes=seg_sizes, seg_real=seg_real, shard_schedule=shard_schedule,
        merge_rounds=int(merge_rounds),
    )
    if verbose:
        kind = "sparse/block" if sparse_semantics else "dense"
        print(f"Prior parameters:\n    Model fitted at [{method}] ({kind} LD)")
        print(f"    Population size {n_eff}\n    Number of markers {m}")
        print(f"    Markers used for analysis {m - nvar0}")
        print(f"    Phenotypic var {vary:.5f}")
        print(f"    Total iterations {niter}, burn-in {nburn}")
        print(f"    Device {device}")
    if nchains > 1:
        state, samples, extras = SG.run_s_chains(spec, data, pr, Pi, seed=seed,
                                                 nchains=nchains, progress=progress,
                                                 checkpoint_path=checkpoint)
        samples = pool_chains(samples)
    else:
        progress = progress or (verbose and printfreq > 0)
        chunk_records = max(int(printfreq) // max(thin, 1), 1) if printfreq else 0
        state, samples, extras = SG.run_s_chain(
            spec, data, pr, Pi, seed=seed, progress=progress, chunk_records=chunk_records,
            checkpoint_path=checkpoint, mesh=mesh)
    elapsed = extras["seconds"]
    if verbose:
        print(f"MCMC finished: {spec.niter_eff} iterations of {nchains} chain(s) in "
              f"{elapsed:.1f}s ({nchains * spec.niter_eff * m / max(elapsed, 1e-9):.3g} "
              f"SNP-updates/s on {device})")

    s = dict(samples)
    gwas = None
    if windinfo is not None:
        gwas = dict(windinfo)
        gwas["WPPA"] = np.asarray(extras["wppa"])
    return BlrMod(
        call="b ~ nD⁻¹Vα + e",
        model_desc=f"Summary level Bayesian model fit by [{method}]",
        method=method,
        pi=s["pi"].mean(axis=0),
        Vg=float(s["Vg"].mean()),
        Ve=float(s["Ve"].mean()),
        h2=float(s["h2"].mean()),
        alpha=s["alpha"].mean(axis=0),
        pip=np.asarray(extras["pip"]),
        gwas=gwas,
        rhat=extras.get("rhat"),
        chain_seconds=elapsed,
        guard=np.asarray(extras["guard"]).reshape(nchains, 2),
        MCMCsamples=s,
    )


def _fit_cg(ss, ld, lambda_, verbose, device) -> BlrMod:
    """Conjugate-gradient solver (method="CG", src/cg.cpp:4-129; the JAX
    package's ``_fit_cg``, hibayes_tpu/model/sbrm.py:203-277).  It solves in
    float64 on ``device``: the stopping rule is an absolute residual norm
    of 1e-6, which float32 round-off can keep it from reaching."""
    f64 = torch.float64
    m = ss.shape[0]
    ncol = ss[:, 3]
    n_eff = int(np.round(np.nanmean(ncol[np.isfinite(ncol)])))
    diag = np.asarray(ld.diag, dtype=np.float64)
    xpx = diag * n_eff
    xy = xpx * np.nan_to_num(ss[:, 1])
    est = np.isfinite(ss[:, 2]) & np.isfinite(ss[:, 1])
    yyi = np.where(est, xpx * (ss[:, 1] ** 2 + (ss[:, 3] - 2.0) * ss[:, 2] ** 2), 0.0)
    county = int(est.sum())
    if county == 0:
        raise ValueError("Lack of SE.")
    vary = yyi.sum() / county / (n_eff - 1)

    lam = None
    if lambda_ is not None:
        lam = np.asarray(lambda_, dtype=np.float64)
        if lam.ndim == 0 or lam.size == 1:
            lam = np.full(m, float(lam))
        elif lam.size != m:
            raise ValueError("length of lambda should be equal to the number of SNPs.")

    def vec(a):
        return torch.as_tensor(a, dtype=f64, device=device)

    def solve(matvec, b, lam_part):
        x, it, err = conj_grad(matvec, vec(b), lam=None if lam_part is None else vec(lam_part))
        if verbose:
            print(f"CG finished in {it} iterations, err={err:.3g}")
        return x

    if isinstance(ld, BlockDiagLD):
        # block-diagonal system: an independent solve per chromosome block
        g = np.zeros(m)
        off = 0
        for b_, s_ in zip(ld.blocks, ld.sizes):
            bj = _tensor(b_, device, f64)
            x = solve(lambda v, bj=bj: bj @ v, xy[off:off + s_] / n_eff,
                      lam[off:off + s_] if lam is not None else None)
            g[off:off + s_] = x.cpu().numpy()
            off += s_
    elif isinstance(ld, TiledSparseLD):
        # O(nnz) matvec over the stored tiles
        tiles = _tensor(ld.tiles, device, f64)
        cols = _tensor(ld.col_idx, device)
        val = _tensor(ld.valid, device)
        mp = ld.m_pad

        def mv(v):
            vp = torch.zeros(mp, dtype=f64, device=device)
            vp[:m] = v
            return _tiled_matvec(tiles, cols, val, vp)[:m]

        g = solve(mv, xy / n_eff, lam).cpu().numpy()
    else:
        LD = _tensor(ld.values, device, f64)
        g = solve(lambda v: LD @ v, xy / n_eff, lam).cpu().numpy()

    vg = n_eff * float(g @ ld.matvec(g)) / (n_eff - 1)
    ve_out = vary - vg
    if verbose:
        print(f"    Genetic var {vg:.4f}\n    Residual var {ve_out:.4f}")
    return BlrMod(
        call="b ~ nD⁻¹Vα + e",
        model_desc="Summary level Bayesian model fit by [CG]",
        method="CG",
        Vg=vg,
        Ve=ve_out,
        h2=vg / max(vg + ve_out, 1e-30),
        alpha=g,
        MCMCsamples={},
    )
