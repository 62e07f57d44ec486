"""`ibrm`: individual-level Bayesian regression (y = Xb + Rr + Ma + e).

PyTorch port of hibayes_tpu/model/ibrm.py on one device, for one chain or
a batch of chains with R-hat: id alignment, formula parsing, NA masking,
GWAS windows, iteration and prior defaults, the phenotyped / unphenotyped
split, the chain, and GEBV and WPPA assembly (reference: R/bayes.r:121-320).
Every method, BSLMM included (its GRM eigenbasis from math/grm.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.windows import build_windows
from ..engine import gibbs as G
from ..math.grm import make_grm
from ..ops import blockgibbs
from ..parallel.mesh import SnpShard
from .formula import build_model_frame
from .results import BlrMod

METHODS = (
    "BayesCpi", "BayesA", "BayesL", "BSLMM", "BayesR",
    "BayesB", "BayesC", "BayesBpi", "BayesRR",
)
_NO_GWAS = ("BayesA", "BayesRR", "BayesL")


def _align_data_to_ids(data: dict, ids: np.ndarray) -> dict:
    """data[match(M.id, data[,1]), ] — rows reordered to ids, absent -> NA.
    (reference: R/bayes.r:161-165)"""
    keys = list(data.keys())
    id_col = np.asarray(data[keys[0]]).astype(str)
    if len(np.intersect1d(id_col, ids)) == 0:
        raise ValueError("no shared individuals between 'M.id' and the first column in 'data'.")
    pos = {v: i for i, v in enumerate(id_col)}
    idx = np.array([pos.get(i, -1) for i in ids])
    safe = np.clip(idx, 0, None)
    out = {}
    for k in keys:
        col = np.asarray(data[k])
        vals = col[safe]
        if col.dtype.kind in "fc":
            vals = vals.astype(np.float64)
            vals[idx < 0] = np.nan
        else:
            vals = vals.astype(object)
            vals[idx < 0] = "NA"
            vals = np.array([str(v) for v in vals])
        out[k] = vals
    return out


def resolve_iteration_defaults(method, niter, nburn, thin, Pi, fold):
    """Reference defaulting (R/bayes.r:264-279)."""
    if niter is None:
        niter = 50000 if method == "BayesR" else 20000
    if nburn is None:
        nburn = 30000 if method == "BayesR" else 12000
    if thin >= (niter - nburn):
        raise ValueError("bad setting for collecting frequency 'thin'.")
    if Pi is None:
        if method == "BayesR":
            Pi = np.array([0.95, 0.02, 0.02, 0.01])
            if fold is None:
                fold = np.array([0.0, 0.0001, 0.001, 0.01])
        else:
            Pi = np.array([0.95, 0.05])
    else:
        Pi = np.asarray(Pi, dtype=np.float64)
    if method == "BayesR" and fold is None:
        raise ValueError("'fold' should be provided for BayesR model.")
    if len(Pi) < 2:
        raise ValueError("Pi should be a vector.")
    if abs(Pi.sum() - 1.0) > 1e-8:
        raise ValueError("sum of Pi should be 1.")
    if Pi[0] == 1:
        raise ValueError("all markers have no effect size.")
    if ((Pi < 0) | (Pi > 1)).any():
        raise ValueError("elements of Pi should be at the range of [0, 1]")
    return niter, nburn, Pi, (np.asarray(fold, np.float64) if fold is not None else None)


def _resolve_windows(method, map_, windsize, windnum, m):
    if windsize is None and windnum is None:
        return None, None, 0
    if method in _NO_GWAS:
        raise ValueError(f"can not implement GWAS analysis for the method: {method}")
    if map_ is None:
        raise ValueError("map information must be provided.")
    chrom = np.asarray(map_["Chr"] if isinstance(map_, dict) else map_[:, 1])
    pos = np.asarray(map_["Pos"] if isinstance(map_, dict) else map_[:, 2], dtype=np.float64)
    if len(chrom) != m:
        raise ValueError("number of SNPs mismatched between 'map' and 'M'.")
    windindx, windinfo = build_windows(chrom, pos, windsize=windsize, windnum=windnum)
    return windindx, windinfo, int(windindx.max())


def _is_integer(M) -> bool:
    if isinstance(M, torch.Tensor):
        return not M.dtype.is_floating_point
    return np.issubdtype(M.dtype, np.integer)


def _rows(M, mask: np.ndarray):
    """M[mask] for a numpy array or a torch tensor (no copy when all rows)."""
    if mask.all():
        return M
    if isinstance(M, torch.Tensor):
        return M[torch.as_tensor(mask, device=M.device)]
    return M[mask]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: "cuda" unless the caller names
    another.  Without a CUDA device, only an explicit device="cpu" runs."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU "
            "(the plain PyTorch versions of the kernels)")
    return device


def _compute_dtype(device: torch.device):
    # f64 on the CPU, as the JAX package's host product; f32 (TF32 off) on a GPU
    return torch.float64 if device.type == "cpu" else torch.float32


def _in_snp_order(mesh, add, out):
    """``add(out)`` summed over the ranks of ``mesh``'s snp axis in their
    order, every rank getting the sum: rank s adds its part onto the sum of
    ranks 0 .. s - 1 and hands it on (a broadcast), so that the additions
    are the one-device loop's, in its order, bit for bit.  ``add(out)``
    where the genotype is not sharded (mesh None)."""
    if mesh is None:
        return add(out)
    from ..parallel.distributed import broadcast

    for t in range(mesh.size("snp")):
        if t == mesh.index("snp"):
            out = add(out)
        out = broadcast(out, mesh, "snp", t)
    return out


def _genotype_products(M, A: np.ndarray, device, mesh=None, start: int = 0) -> np.ndarray:
    """M @ A.T for an (n, m) genotype (numpy or torch, any device) and
    A (r, m), on ``device`` in column chunks of M of at most 256 MB in the
    compute type, each cast from its storage type there: no f32 or f64 copy
    of the whole genotype is made.  On a SNP-sharded ``mesh`` M holds
    columns [start, start + M.shape[1]) of A's m: the chunks are the whole
    genotype's cut at the shards' edges, summed in SNP order
    (:func:`_in_snp_order`)."""
    device = torch.device(device)
    cdt = _compute_dtype(device)
    n, m_here = M.shape
    At = torch.as_tensor(np.asarray(A).T, dtype=cdt, device=device)
    step = max(1, (1 << 28) // (max(n, 1) * cdt.itemsize))

    def add(out):
        c0 = 0
        while c0 < m_here:
            c1 = min(m_here, (start + c0) // step * step + step - start)
            out.addmm_(G._columns(M, c0, c1, cdt, device), At[start + c0:start + c1])
            c0 = c1
        return out

    out = _in_snp_order(mesh, add, torch.zeros((n, At.shape[1]), dtype=cdt, device=device))
    return out.to(torch.float64).cpu().numpy()


def _block_products(gdata: G.GibbsData, n: int, A: np.ndarray, mesh=None) -> np.ndarray:
    """X_phen @ A.T from the chain's own block-layout genotype, A (r, m); on
    a SNP-sharded ``mesh`` (``gdata`` of a SnpShard: this rank's blocks)
    summed over the shards in block order (:func:`_in_snp_order`)."""
    device = gdata.X_blocks.device
    cdt = _compute_dtype(device)
    Gm = torch.zeros((gdata.xpx.shape[0], A.shape[0]), dtype=cdt, device=device)
    Gm[: A.shape[1]] = torch.as_tensor(np.asarray(A).T, dtype=cdt, device=device)
    S = blockgibbs.SubBlocks.of(gdata.block, gdata.X_blocks.shape[2]).S
    cols = gdata.X_blocks.shape[0] // S * gdata.block
    c0 = mesh.index("snp") * cols if mesh is not None else 0
    out = torch.zeros((gdata.X_blocks.shape[1], A.shape[0]), dtype=cdt, device=device)
    out = _in_snp_order(mesh, lambda o: G.genotype_matmul(
        gdata.X_blocks, Gm[c0:c0 + cols], cdt, gdata.block, out=o), out)
    return out[:n].to(torch.float64).cpu().numpy()


def ibrm(
    formula,
    data=None,
    M=None,
    M_id=None,
    method="BayesCpi",
    map=None,
    Pi=None,
    fold=None,
    niter=None,
    nburn=None,
    thin=5,
    windsize=None,
    windnum=None,
    dfvr=None,
    s2vr=None,
    vg=None,
    dfvg=None,
    s2vg=None,
    ve=None,
    dfve=None,
    s2ve=None,
    lambda_=0.0,
    printfreq=100,
    seed=666666,
    threads=0,
    verbose=True,
    block=64,
    dtype=torch.float32,
    checkpoint=None,
    progress=False,
    nchains=1,
    mesh=None,
    shard_schedule="turn",
    merge_rounds=1,
    emulate_shards=0,
    device=None,
) -> BlrMod:
    """Fit on ``device`` (default "cuda"; the CPU only when asked for with
    device="cpu"; the header names it).  ``M`` is an (n, m) numpy array or
    torch tensor on any device; integer genotypes are stored as int8.
    ``nchains > 1`` runs that many chains as one batch (``run_chains``):
    the summaries pool every chain's records and ``rhat`` holds each
    parameter's split R-hat.  The keywords are the JAX package's:
    ``threads`` (its host codec threads) is accepted and unused;
    ``lambda_`` is BSLMM's GRM ridge; ``checkpoint`` (a path prefix) saves
    the chain or batch after every ``printfreq`` iterations (a tenth of the
    records for a batch) and resumes it from there, bit for bit.

    ``mesh`` (parallel/mesh.py:make_mesh, every rank of a torchrun job
    calling ibrm alike) shards the individuals over its ``ind`` axis and
    the SNP blocks over its ``snp`` axis; ``shard_schedule`` is how the
    SNP shards sweep: "turn" (exact: one shard at a time), "pipeline"
    (exact: all shards busy, chain groups ring-rotating; ``nchains`` a
    multiple of the shards) or "concurrent" (relaxed: all shards sweep
    against the residual of the round's start, ``merge_rounds`` merges an
    iteration; it warns where m > n, its biased regime: prefer "pipeline"
    or "turn" there); ``emulate_shards`` > 1 runs the pipeline or the
    concurrent schedule with that many shards on one device.  Rank 0
    alone prints.

    A genotype larger than one device is given on a mesh with an ``snp``
    axis as each rank's own columns: ``M`` a
    :class:`~hibayes_tpu_torch.parallel.mesh.SnpShard` (values, start, m)
    holding columns ``mesh.snp_range(m, block, multiple)`` of the m SNPs,
    ``multiple`` being ``merge_rounds`` for the concurrent schedule and 1
    otherwise (``parallel.distributed.load_plink_snp_sharded`` reads one
    from a .bed).  No rank then holds the whole genotype, on the host or on
    its device: set-up lays out this rank's blocks (``prepare_gibbs_data``),
    and the GEBV and residuals sum each rank's products in SNP order, every
    rank getting the fit, bit for bit the fit from the whole genotype.
    ``map`` stays whole (m rows).  BSLMM, whose GRM needs every SNP, is
    refused."""
    if method not in METHODS:
        raise ValueError(f"unknown method '{method}'; choose from {METHODS}")
    verbose = verbose and (mesh is None or mesh.rank == 0)
    if data is None:
        raise ValueError("no data assigned.")
    if M is None:
        raise ValueError("no genotype data.")
    if M_id is None:
        raise ValueError("please assign the individuals id to 'M.id'.")
    device = resolve_device(device)
    shard = M if isinstance(M, SnpShard) else None
    if shard is not None:
        if mesh is None or mesh.size("snp") <= 1:
            raise ValueError("a SnpShard genotype needs a mesh with an snp axis")
        if method == "BSLMM":
            raise ValueError("BSLMM's GRM needs every SNP on each rank: give it the whole "
                             "genotype, not a SnpShard")
        M = shard.values
    M_values = M if isinstance(M, torch.Tensor) else (
        M.values if hasattr(M, "values") else np.asarray(M))
    M_id = np.asarray(M_id).astype(str)
    if len(M_id) != M_values.shape[0]:
        raise ValueError("number of individuals mismatched in 'M' and 'M.id'.")

    aligned = _align_data_to_ids(data, M_id)
    mf = build_model_frame(formula, aligned)
    keep = mf.keep_mask
    y = mf.y
    n = len(y)
    m = M_values.shape[1] if shard is None else int(shard.m)

    windindx, windinfo, nw = _resolve_windows(method, map, windsize, windnum, m)
    niter, nburn, Pi, fold = resolve_iteration_defaults(method, niter, nburn, thin, Pi, fold)

    M_phen = _rows(M_values, keep)
    Mp = _rows(M_values, ~keep) if (~keep).any() else None

    # RR/A/L force the mixture off (src/Bayes.cpp:288-291)
    if method in ("BayesRR", "BayesA", "BayesL"):
        Pi = np.array([0.0, 1.0])
        fixpi = True
    else:
        fixpi = method in ("BayesB", "BayesC")

    use_bslmm = method == "BSLMM"
    K = Kval = None
    if use_bslmm:
        Kval, K = make_grm(M_phen, lambda_=lambda_, eigen=True, dtype=dtype, device=device)

    nc = mf.X.shape[1] if mf.X is not None else 0
    nlevels = tuple(int(len(lv)) for lv in mf.R_levels)
    # SNP-sharded meshes and the emulations need the shards (times the
    # merge rounds of the concurrent schedule) to divide the block count
    snp_shards = mesh.size("snp") if mesh is not None else 1
    s_eff = snp_shards if snp_shards > 1 else max(int(emulate_shards), 1)
    nbm = s_eff * (int(merge_rounds) if shard_schedule == "concurrent" else 1)
    gdata = G.prepare_gibbs_data(
        y, M_phen if shard is None else shard._replace(values=M_phen), C=mf.X,
        r_codes=tuple(mf.R_codes), r_nlevels=nlevels,
        fold=fold, windindx=windindx, nw=nw, K=K, Kval=Kval, block=block, dtype=dtype,
        geno_dtype="int8" if _is_integer(M_phen) else None, device=device,
        nblocks_multiple=nbm, mesh=mesh if shard is not None else None,
    )
    vx = gdata.vx.cpu().numpy()
    nvar0 = int((vx[:m] == 0).sum())
    pr = G.resolve_priors(
        y, float(vx.sum()), float(Pi[0]), nr=len(nlevels),
        vg=vg, dfvg=dfvg, s2vg=s2vg, ve=ve, dfve=dfve, s2ve=s2ve,
        dfvr=dfvr, s2vr=s2vr,
    )
    spec = G.GibbsSpec(
        model=method, n=int(gdata.y.shape[0]), n_real=n,
        m=m, m_pad=int(gdata.xpx.shape[0]), block=gdata.block,
        nc=nc, nlevels=nlevels, n_fold=len(Pi), niter=niter, nburn=nburn,
        thin=thin, nvar0=nvar0, nw=nw, fixpi=fixpi,
        dfvara=pr.dfvara, s2vara=pr.s2vara, dfvare=pr.dfvare, s2vare=pr.s2vare,
        dfr=pr.dfr, s2r=pr.s2r, s2varg=pr.s2varg, lambda_rate0=pr.lambda_rate0,
        use_bslmm=use_bslmm, shard_schedule=shard_schedule,
        merge_rounds=int(merge_rounds), emulate_shards=int(emulate_shards),
    )

    if verbose:
        _print_header(spec, pr, Pi, fold, method, n, m, nc, nlevels, nw, device)
    if nchains > 1:
        state, samples, extras = G.run_chains(spec, gdata, pr, Pi, seed=seed,
                                              nchains=nchains, progress=progress,
                                              checkpoint_path=checkpoint, mesh=mesh)
        samples = pool_chains(samples)
    else:
        # reference UX: per-printfreq progress rows (Bayes.cpp:884-914)
        progress = progress or (verbose and printfreq > 0)
        chunk_records = max(int(printfreq) // max(thin, 1), 1) if printfreq else 0
        state, samples, extras = G.run_chain(
            spec, gdata, pr, Pi, seed=seed, progress=progress,
            chunk_records=chunk_records, checkpoint_path=checkpoint, mesh=mesh,
        )
    elapsed = extras["seconds"]
    if verbose:
        print(f"MCMC finished: {spec.niter_eff} iterations of {nchains} chain(s) in "
              f"{elapsed:.1f}s ({nchains * spec.niter_eff * m / max(elapsed, 1e-9):.3g} "
              f"SNP-updates/s on {device})")

    res = _assemble_results(
        method, formula, spec, samples, extras, mf, y, M_id, keep, gdata, Mp,
        windinfo, sumvx=float(vx.sum()),
        model_desc=f"Individual level Bayesian model fit by [{method}]",
        snp_mesh=None if shard is None else mesh, start=0 if shard is None else shard.start,
    )
    res.rhat = extras.get("rhat")
    return res


def pool_chains(samples: dict) -> dict:
    """(nchains, n_records, ...) records -> (nchains * n_records, ...) for
    the summaries (the chain and record counts given explicitly: -1 is
    ambiguous for an empty parameter)."""
    return {k: v.reshape((v.shape[0] * v.shape[1],) + v.shape[2:])
            for k, v in samples.items()}


def _print_header(spec, pr, Pi, fold, method, n, m, nc, nlevels, nw, device):
    name = "Bayes Ridge Regression" if method == "BayesRR" else method
    print("Prior parameters:")
    print(f"    Model fitted at [{name}]")
    print(f"    Number of observations {n}")
    print(f"    Number of covariates {nc + 1}")
    print(f"    Number of envir-random effects {len(nlevels)}")
    print(f"    Number of markers {m}")
    print(f"    Pi {np.round(Pi, 4)}")
    if method == "BayesR":
        print(f"    Group fold {fold}")
    print(f"    Total number of iteration {spec.niter}")
    print(f"    Total number of burn-in {spec.nburn}")
    print(f"    Phenotypic var {pr.vary:.5f}")
    print(f"    Genetic var {pr.vara:.5f}")
    print(f"    Residual var {pr.vare:.5f}")
    print(f"    Marker var {pr.varg:.5f}")
    if nw:
        print(f"    Number of windows for GWAS analysis {nw}")
    print(f"    Device {device}")


def bslmm_snp_effects(gdata: G.GibbsData, n: int, m: int, k_mean, sumvx: float):
    """BSLMM's posterior-mean polygenic effect k (n,) mapped into SNP space
    (reference src/Bayes.cpp:955-969), by the JAX package's pseudo-inverse
    rule (hibayes_tpu/model/ibrm.py:319-330): eigenvalues below 1e-6 of the
    largest are dropped, Kg = (K' k) / Kval / sum(vx), and the effects are
    M' (K Kg), centred.  M' is applied on the device from the chain's int8
    blocks (``genotype_rmatmul``); no float copy of the genotype is made.
    Returns (m,) float64."""
    cdt = _compute_dtype(gdata.X_blocks.device)
    K = gdata.K.to(cdt)
    Kv = gdata.Kval.to(torch.float64)
    cutoff = 1e-6 * Kv.max()
    inv_Kv = torch.where(Kv > cutoff, 1.0 / torch.clamp_min(Kv, cutoff), 0.0).to(cdt)
    k = torch.as_tensor(k_mean, dtype=cdt, device=K.device)
    Kg = (k @ K) * inv_Kv / sumvx
    ghat = G.genotype_rmatmul(gdata.X_blocks[:, :n], K @ Kg, cdt, gdata.block)[:m]
    ghat = ghat.to(torch.float64).cpu().numpy()
    return ghat - ghat.mean()


def _assemble_results(method, formula, spec, samples, extras, mf, y, M_id,
                      keep, gdata, Mp, windinfo, sumvx=1.0, model_desc="", snp_mesh=None,
                      start=0):
    """The fit's results.  With ``snp_mesh``, ``gdata`` and ``Mp`` hold a
    rank's SNP columns alone (from column ``start``), and the GEBV and
    residuals sum the ranks' products in SNP order."""
    s = dict(samples)
    alpha_s = s["alpha"]  # (records, m)
    if method == "BSLMM" and "k_estR" in s:
        # the polygenic effect folded into every effect sample, as the JAX
        # package does
        alpha_s = alpha_s + bslmm_snp_effects(gdata, len(y), spec.m,
                                              s["k_estR"].mean(axis=0), sumvx)[None, :]
        s["alpha"] = alpha_s
    alpha = alpha_s.mean(axis=0)
    mu = float(s["mu"].mean())
    pi_mean = s["pi"].mean(axis=0)
    beta = s["beta"].mean(axis=0) if spec.nc else None
    vr = s["Vr"].mean(axis=0) if len(spec.nlevels) else None
    r_est = s["r"].mean(axis=0) if len(spec.nlevels) else None

    # GEBV samples for ALL genotyped ids incl. unphenotyped (R/bayes.r:303-308),
    # on the device from the int8 genotype
    n = len(y)
    g_samples = np.zeros((len(M_id), alpha_s.shape[0]))
    g_samples[keep] = _block_products(gdata, n, alpha_s, snp_mesh)
    if Mp is not None:
        g_samples[~keep] = _genotype_products(Mp, alpha_s, gdata.X_blocks.device, snp_mesh,
                                              start)
    s["g"] = g_samples
    gebv = {"id": M_id, "gebv": g_samples.mean(axis=1)}

    # residuals from posterior means (src/Bayes.cpp:942-1011)
    e = y - mu
    if beta is not None:
        e = e - mf.X @ beta
    if r_est is not None:
        off = 0
        for i, lv in enumerate(mf.R_levels):
            e = e - r_est[off: off + len(lv)][mf.R_codes[i]]
            off += len(lv)
    e = e - _block_products(gdata, n, alpha[None, :], snp_mesh)[:, 0]

    r_dict = None
    if r_est is not None:
        r_dict = {"Levels": np.concatenate(list(mf.R_levels)), "Estimation": r_est}
    gwas = None
    if windinfo is not None:
        gwas = dict(windinfo)
        gwas["WPPA"] = np.asarray(extras["wppa"])

    return BlrMod(
        call=f"{formula} + M",
        model_desc=model_desc,
        method=method,
        mu=mu,
        pi=pi_mean,
        beta=beta,
        beta_names=mf.X_names,
        r=r_dict,
        r_names=mf.R_names,
        r_nlevels=tuple(len(lv) for lv in mf.R_levels),
        Vr=vr,
        Vg=float(s["Vg"].mean()),
        Ve=float(s["Ve"].mean()),
        h2=float(s["h2"].mean()),
        alpha=alpha,
        g=gebv,
        e={"id": M_id[keep], "e": e},
        pip=np.asarray(extras["pip"]),
        gwas=gwas,
        Va=float(s["Va"].mean()) if "Va" in s else None,
        Vb=float(s["Vb"].mean()) if "Vb" in s else None,
        chain_seconds=extras["seconds"],
        MCMCsamples=s,
    )
