"""`ssbrm`: single-step Bayesian regression with pedigree.

y = Xb + Rr + M a + J j + U eps + e over genotyped AND non-genotyped
individuals (reference: R/ssbayes.r:115-351).  PyTorch port of
hibayes_tpu/model/ssbrm.py for one chain on one device: MAF filter,
pedigree merge and ordering, Henderson A-inverse, the imputation operator
(a dense direct solve, or matrix-free batched PCG at scale), genotype
imputation, the J covariate, the chain with the epsilon term, and GEBV for
every pedigree id.

The genotype and its imputed rows stay on the device: the MAF filter, the
stacked [M; Mn] of the phenotyped, the GEBV and the residuals are computed
there in column chunks, so no wide host copy of the genotype is made.
"""

from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from ..data.pedigree import (ImputationOperator, make_ainv, make_ped,
                             rcm_permutation, solve_a_ng)
from ..engine import gibbs as G
from .formula import build_model_frame
from .ibrm import (METHODS, _block_products, _compute_dtype, _genotype_products,
                   _print_header, _resolve_windows, resolve_device,
                   resolve_iteration_defaults)
from .results import BlrMod

CHUNK_BYTES = 1 << 28   # genotype columns cast at once on the device


def _col_chunks(n_rows: int, m: int, itemsize: int):
    step = max(1, CHUNK_BYTES // (max(n_rows, 1) * itemsize))
    return [(c0, min(m, c0 + step)) for c0 in range(0, m, step)]


def _cols(M, c0, c1, dtype, device, rows=None):
    """Columns [c0, c1) of a numpy or torch genotype (rows ``rows``, all by
    default) as a tensor of ``dtype`` on ``device``."""
    if isinstance(M, torch.Tensor):
        X = M[:, c0:c1]
        if rows is not None:
            X = X.index_select(0, torch.as_tensor(rows, device=M.device))
        return X.to(device=device, dtype=dtype)
    X = M[:, c0:c1] if rows is None else M[rows, c0:c1]
    return torch.from_numpy(np.ascontiguousarray(X)).to(device=device, dtype=dtype)


def _allele_freq(M) -> np.ndarray:
    """Column means / 2 of the genotype, exact in float64 (integer sums)."""
    n, m = M.shape
    if not isinstance(M, torch.Tensor):
        return np.asarray(M).mean(axis=0, dtype=np.float64) / 2.0
    dev = M.device
    out = torch.empty((m,), dtype=torch.float64, device=dev)
    for c0, c1 in _col_chunks(n, m, 8):
        out[c0:c1] = M[:, c0:c1].to(torch.float64).sum(dim=0)
    return (out / n / 2.0).cpu().numpy()


def ssbrm(
    formula,
    data=None,
    M=None,
    M_id=None,
    pedigree=None,
    method="BayesCpi",
    map=None,
    Pi=None,
    fold=None,
    niter=None,
    nburn=None,
    thin=5,
    windsize=None,
    windnum=None,
    maf=0.01,
    dfvr=None,
    s2vr=None,
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
    dtype=None,
    ainv_compat_hibayes=False,
    nchains=1,
    impute="auto",
    chunk_cols=4096,
    mesh=None,
    checkpoint=None,
    progress=False,
    device=None,
) -> BlrMod:
    """Fit one single-step chain on ``device`` (default "cuda"; the CPU only
    when asked for with device="cpu").  ``M`` (n_g, m) is a numpy array or a
    torch tensor on any device; ``pedigree`` a dict of (id, sire, dam)
    columns or an (n, 3) array.  ``dtype`` defaults to float32 on a GPU
    (the kernels' type) and float64 on the CPU.  ``threads`` (the JAX
    package's host codec threads) is accepted and unused.

    impute: "direct" solves the dense (n_ng, n_g) imputation operator and
    keeps the dense epsilon A-inverse (the reference's path,
    R/ssbayes.r:296-307, for small pedigrees); "pcg" imputes matrix-free by
    batched PCG in ``chunk_cols`` column chunks and packs a sparse epsilon
    A-inverse (RCM-ordered diagonal blocks and triplets), so no dense
    (n_ng, n_g) or (qe, qe) matrix exists; "auto" takes "pcg" when
    n_ng * n_g exceeds 2^24.  ``setup_seconds`` of the result splits the
    set-up into pedigree, imputation and data preparation."""
    if method == "BSLMM":
        raise ValueError("BSLMM is not supported for the single-step model.")
    if method not in METHODS:
        raise ValueError(f"unknown method '{method}'")
    if nchains != 1:
        raise NotImplementedError(
            "ssbrm(nchains>1) is not ported yet: its epsilon sweep (mme_sweep) "
            "would run over K chains (ROADMAP queue 1, item 6)")
    if mesh is not None:
        raise NotImplementedError(
            "meshes are not ported yet (ROADMAP queue 1, item 13)")
    if checkpoint is not None:
        raise NotImplementedError(
            "checkpoint/resume is not ported yet (ROADMAP queue 1, item 7)")
    if data is None:
        raise ValueError("no data assigned.")
    if M is None:
        raise ValueError("no genotype data.")
    if M_id is None:
        raise ValueError("please assign the individuals id to 'M.id'.")
    if pedigree is None:
        raise ValueError("pedigree should be provided for single-step bayesian model.")
    if impute not in ("auto", "direct", "pcg"):
        raise ValueError("impute must be 'auto', 'direct' or 'pcg'")
    device = resolve_device(device)
    dt = _compute_dtype(device) if dtype is None else dtype
    if device.type == "cuda" and dt != torch.float32:
        raise TypeError("on the card the sweep kernels take float32 only")
    t_start = time.perf_counter()

    M_values = M if isinstance(M, torch.Tensor) else np.asarray(
        M.values if hasattr(M, "values") else M)
    M_id = np.asarray(M_id).astype(str)
    if len(M_id) != M_values.shape[0]:
        raise ValueError("number of individuals mismatched in 'M' and 'M.id'.")
    m = M_values.shape[1]

    windindx, windinfo, nw = _resolve_windows(method, map, windsize, windnum, m)
    niter, nburn, Pi, fold = resolve_iteration_defaults(method, niter, nburn, thin, Pi, fold)
    if method in ("BayesRR", "BayesA", "BayesL"):
        Pi = np.array([0.0, 1.0])
        fixpi = True
    else:
        fixpi = method in ("BayesB", "BayesC")

    # --- MAF filter: zero out rare columns (R/ssbayes.r:263-264) ---
    p = _allele_freq(M_values)
    p = np.minimum(p, 1.0 - p)
    rare = p < maf
    if rare.any():
        if isinstance(M_values, torch.Tensor):
            M_values = M_values.clone()
            M_values[:, torch.as_tensor(rare, device=M_values.device)] = 0
        else:
            M_values = M_values.copy()
            M_values[:, rare] = 0

    # --- pedigree merge: genotyped-but-unpedigreed become founders ---
    ped = np.stack(
        [np.asarray(pedigree[k]).astype(str) for k in list(pedigree)[:3]], axis=1
    ) if isinstance(pedigree, dict) else np.asarray(pedigree).astype(str)
    if ped.shape[1] != 3:
        raise ValueError("3 columns ('id', 'sir', 'dam') are required in pedigree.")
    ped_all_ids = np.unique(ped.astype(str))
    extra = M_id[~np.isin(M_id, ped_all_ids)]
    if len(extra) == len(M_id):
        raise ValueError("no shared individuals between 'M.id' and 'pedigree'.")
    if len(extra):
        ped = np.vstack([ped, np.stack([extra, np.full(len(extra), "0"),
                                        np.full(len(extra), "0")], axis=1)])

    # --- phenotype alignment + model frame (on data's own rows) ---
    keys = list(data.keys())
    data_ids = np.asarray(data[keys[0]]).astype(str)
    mf_all = build_model_frame(formula, {k: np.asarray(v) for k, v in data.items()})
    keep0 = mf_all.keep_mask
    y_ids = data_ids[keep0]

    # --- pedigree ordering + A-inverse ---
    ped_ids, s_idx, d_idx = make_ped(ped[:, 0], ped[:, 1], ped[:, 2])
    if np.isin(ped_ids, M_id).all():
        raise ValueError(
            "all individuals have been genotyped, no necessaries to fit single-step bayes model."
        )
    # drop phenotyped ids absent from pedigree/genotype (R/ssbayes.r:277-284)
    in_ped = np.isin(y_ids, ped_ids)
    if (~in_ped).all():
        raise ValueError("no shared individuals between 'data' and 'pedigree'.")
    if (~in_ped).any():
        drop_ids = set(y_ids[~in_ped])
        sel = np.array([i not in drop_ids for i in data_ids])
        keep0 = keep0 & sel
        y_ids = data_ids[keep0]

    Ai = make_ainv(s_idx, d_idx, compat_hibayes=ainv_compat_hibayes)
    g_pos = {v: i for i, v in enumerate(ped_ids)}
    g_indx = np.array([g_pos[i] for i in M_id])
    ng_mask = np.ones(len(ped_ids), dtype=bool)
    ng_mask[g_indx] = False
    ng_indx = np.flatnonzero(ng_mask)
    scale_path = impute == "pcg" or (
        impute == "auto" and len(ng_indx) * len(g_indx) > (1 << 24)
    )
    # rows, then columns: np.ix_ on a sparse matrix samples the full dense
    # index pattern
    Ai_rows = Ai.tocsr()[ng_indx]
    Ai_nn = Ai_rows.tocsc()[:, ng_indx]
    if scale_path:
        # RCM-cluster the non-genotyped block (denser diagonal blocks, fewer
        # scattered triplets for the epsilon Gibbs); results are keyed by id
        perm = rcm_permutation(Ai_nn)
        ng_indx = ng_indx[perm]
        Ai_rows = Ai.tocsr()[ng_indx]
        Ai_nn = Ai_rows.tocsc()[:, ng_indx]
    Mn_id = ped_ids[ng_indx]
    Ai_ng = Ai_rows.tocsc()[:, g_indx]
    t_ped = time.perf_counter()

    if verbose:
        print(f"{len(ped_ids)} pedigree ids; imputing genotype for {len(Mn_id)} "
              f"individuals ({'matrix-free PCG' if scale_path else 'direct solve'})")
    J = np.full(len(M_id), -1.0)
    if scale_path:
        a_op = ImputationOperator(Ai_nn, Ai_ng, device=device)
        Jn = a_op.apply(J).cpu().numpy()
        A_ng = None
    else:
        A_ng = solve_a_ng(Ai_nn, Ai_ng)   # (n_ng, n_g) dense imputation operator
        Jn = A_ng @ J

    # --- reorder phenotypes to [genotyped; imputed] (R/ssbayes.r:310-319) ---
    sub_data = {k: np.asarray(v)[keep0] for k, v in data.items()}
    mf = build_model_frame(formula, sub_data)
    assert mf.keep_mask.all()
    y = mf.y
    geno_pheno = np.isin(M_id, y_ids)
    y_M_id = M_id[geno_pheno]
    mn_rows_pheno = np.flatnonzero(np.isin(Mn_id, y_ids))
    y_Mn_id = Mn_id[mn_rows_pheno]
    y_id_comb = np.concatenate([y_M_id, y_Mn_id])
    pos_y = {v: i for i, v in enumerate(y_ids)}
    y_indx = np.array([pos_y[i] for i in y_id_comb])
    y_ord = y[y_indx]
    X_ord = mf.X[y_indx] if mf.X is not None else None
    r_codes_ord = tuple(c[y_indx] for c in mf.R_codes)
    y_Mn_indx = mn_rows_pheno.astype(np.int64)

    # [M; Mn] of the phenotyped, on the device in the chain's type; only the
    # phenotyped non-genotyped rows are imputed
    n_gp, ne = len(y_M_id), len(y_Mn_id)
    rows_g = np.flatnonzero(geno_pheno)
    yM = torch.empty((n_gp + ne, m), dtype=dt, device=device)
    for c0, c1 in _col_chunks(n_gp, m, 8):
        yM[:n_gp, c0:c1] = _cols(M_values, c0, c1, dt, device, rows_g)
    if scale_path:
        a_op.impute(M_values, rows_needed=mn_rows_pheno, chunk_cols=chunk_cols,
                    verbose=verbose, out=yM[n_gp:])
    else:
        A_rows = torch.as_tensor(A_ng[mn_rows_pheno], dtype=dt, device=device)
        for c0, c1 in _col_chunks(len(M_id), m, 8):
            yM[n_gp:, c0:c1] = A_rows @ _cols(M_values, c0, c1, dt, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_imp = time.perf_counter()
    yJ = np.concatenate([J[geno_pheno], Jn[mn_rows_pheno]])

    qe = len(Mn_id)
    if ne == 0:
        warnings.warn(
            "all phenotypic individuals have genotype information, "
            "thus can't fit imputation errors."
        )

    n = len(y_ord)
    nc = X_ord.shape[1] if X_ord is not None else 0
    nlevels = tuple(int(len(lv)) for lv in mf.R_levels)

    gdata = G.prepare_gibbs_data(
        y_ord, yM, C=X_ord, r_codes=r_codes_ord, r_nlevels=nlevels,
        fold=fold, windindx=windindx, nw=nw,
        epsl_yJ=yJ if ne else None,
        epsl_A=(Ai_nn if scale_path else np.asarray(Ai_nn.todense())) if ne else None,
        epsl_codes=y_Mn_indx if ne else None,
        qe=qe if ne else 0,
        block=block, dtype=dt, device=device,
    )
    del yM
    vx = gdata.vx.cpu().numpy()
    nvar0 = int((vx[:m] == 0).sum())
    pr = G.resolve_priors(
        y_ord, float(vx.sum()), float(Pi[0]), nr=len(nlevels),
        vg=vg, dfvg=dfvg, s2vg=s2vg, ve=ve, dfve=dfve, s2ve=s2ve,
        dfvr=dfvr, s2vr=s2vr,
    )
    spec = G.GibbsSpec(
        # ne == 0 drops the epsilon arguments, so prepare_gibbs_data may pad
        # the rows: array sizes use the padded count, statistics the real one
        model=method, n=int(gdata.y.shape[0]), n_real=n,
        m=m, m_pad=int(gdata.xpx.shape[0]),
        block=int(gdata.X_blocks.shape[2]),
        nc=nc, nlevels=nlevels, n_fold=len(Pi), niter=niter, nburn=nburn, thin=thin,
        nvar0=nvar0, nw=nw, fixpi=fixpi,
        dfvara=pr.dfvara, s2vara=pr.s2vara, dfvare=pr.dfvare, s2vare=pr.s2vare,
        dfr=pr.dfr, s2r=pr.s2r, s2varg=pr.s2varg, lambda_rate0=pr.lambda_rate0,
        ne=ne if ne else 0, qe=qe if ne else 0,
        qe_pad=int(gdata.epsl_counts.shape[0]) if ne else 0,
    )
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_prep = time.perf_counter()
    setup = {"pedigree": t_ped - t_start, "imputation": t_imp - t_ped,
             "prepare": t_prep - t_imp}
    if verbose:
        _print_header(spec, pr, Pi, fold, method, n, m, nc, nlevels, nw, device)
        print(f"    Observations with genotype {n - ne}")
        print(f"    Observations with imputed genotype {ne}")
        print("    Set-up seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in setup.items()))
    progress = progress or (verbose and printfreq > 0)
    chunk_records = max(int(printfreq) // max(thin, 1), 1) if printfreq else 0
    state, samples, extras = G.run_chain(
        spec, gdata, pr, Pi, seed=seed, progress=progress, chunk_records=chunk_records,
    )
    elapsed = extras["seconds"]
    if verbose:
        print(f"MCMC finished: {spec.niter_eff} iterations in {elapsed:.1f}s "
              f"({spec.niter_eff * m / max(elapsed, 1e-9):.3g} SNP-updates/s "
              f"on {device})")

    # assemble: GEBV for ALL pedigree ids = [J; Jn] J + [M; Mn] alpha (+ eps)
    s = dict(samples)
    alpha_s = s["alpha"]
    all_ids = np.concatenate([M_id, Mn_id])
    top = _genotype_products(M_values, alpha_s, device)   # (n_g, records)
    if scale_path:
        # A.ng @ (M @ alpha') == Mn @ alpha' without imputing every row
        lower = a_op.apply(top).cpu().numpy()
    else:
        lower = A_ng @ top
    g_samples = np.vstack([top, lower])
    if ne:
        Jcat = np.concatenate([J, Jn])
        g_samples = g_samples + Jcat[:, None] * s["J"][None, :]
        g_samples[len(M_id):] += s["epsilon"].T
    s["g"] = g_samples
    gebv = {"id": all_ids, "gebv": g_samples.mean(axis=1)}

    mu = float(s["mu"].mean())
    beta = s["beta"].mean(axis=0) if nc else None
    r_est = s["r"].mean(axis=0) if nlevels else None

    e = y_ord - mu
    if beta is not None:
        e = e - X_ord @ beta
    if r_est is not None:
        off = 0
        for i, lv in enumerate(mf.R_levels):
            e = e - r_est[off: off + len(lv)][r_codes_ord[i]]
            off += len(lv)
    e = e - _block_products(gdata, n, alpha_s.mean(axis=0)[None, :])[:, 0]
    if ne:
        e = e - float(s["J"].mean()) * yJ
        eps_mean = s["epsilon"].mean(axis=0)
        e[n - ne:] = e[n - ne:] - eps_mean[y_Mn_indx]

    # residuals reported per original phenotype order (R/ssbayes.r:339-341)
    e_full = np.full(len(y_ids), np.nan)
    e_full[y_indx] = e

    r_dict = None
    if r_est is not None:
        r_dict = {"Levels": np.concatenate(list(mf.R_levels)), "Estimation": r_est}
    gwas = None
    if windinfo is not None:
        gwas = dict(windinfo)
        gwas["WPPA"] = np.asarray(extras["wppa"])

    return BlrMod(
        call=f"{formula} + J + M[pedigree]",
        model_desc=f"Single-step Bayesian model fit by [{method}]",
        method=method,
        mu=mu,
        pi=s["pi"].mean(axis=0),
        beta=beta,
        beta_names=mf.X_names,
        r=r_dict,
        r_names=mf.R_names,
        r_nlevels=tuple(len(lv) for lv in mf.R_levels),
        Vr=s["Vr"].mean(axis=0) if nlevels else None,
        Vg=float(s["Vg"].mean()),
        Ve=float(s["Ve"].mean()),
        h2=float(s["h2"].mean()),
        alpha=alpha_s.mean(axis=0),
        g=gebv,
        e={"id": y_ids, "e": e_full},
        pip=np.asarray(extras["pip"]),
        gwas=gwas,
        Veps=float(s["Veps"].mean()) if ne else None,
        J=float(s["J"].mean()) if ne else None,
        epsilon={"id": Mn_id, "epsilon": s["epsilon"].mean(axis=0)} if ne else None,
        chain_seconds=elapsed,
        setup_seconds=setup,
        MCMCsamples=s,
    )
