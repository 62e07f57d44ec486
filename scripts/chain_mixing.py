#!/usr/bin/env python3
"""How fast a chain batch mixes, for the gates of chip_smoke.py's
multi-chain phases.  Four studies:

    python3 scripts/chain_mixing.py rehearse     # CPU, about 15 minutes
    python3 scripts/chain_mixing.py reference    # CPU, needs the JAX package
    python3 scripts/chain_mixing.py windows      # on the card
    python3 scripts/chain_mixing.py ssbrm_reference   # CPU, needs the JAX package
    python3 scripts/chain_mixing.py fault [PHASE ...] # on the card: 4c 4b 10a 10b

rehearse: chip_smoke.py phase 4c's recipe (BayesCpi, n=4,096, m=65,536,
  B=128, 500 causal SNPs, h2=0.5, 200 iterations, burn-in 100, thin 5) on
  the CPU with 2 chains and the plain sweep: GEBV accuracy of each chain
  and pooled, corr(chain 0, chain 1), split R-hat.
reference: split R-hat of Ve, Vg and pi where m >> n (BayesCpi, n=512,
  m=8,192, 50 causal SNPs, 4 chains of 400 iterations) from the JAX
  package's run_chains and from the port's, and each chain's mean Ve.
windows: phases 4c (64 chains, 1,500 iterations), 4b (the flagship with
  4 chains, 800 iterations) and 6b (sbrm dense, 4 chains, 1,000
  iterations) from iteration 0, split R-hat of Ve, Vg and h2 over windows
  of 20 kept records, with GEBV agreement of chains 0 and 1 and accuracy
  per window, one JSON line per phase.
fault: phases 4c and 4b as chip_smoke.py runs them (the same genotypes and
  calls, seeds 2024 and 2025), sound and with a planted fault: "once", each
  chain k sweeps iteration 100 (the first kept one) against chain k+1's
  residual; "always", every sweep does.  One JSON line per run with the
  numbers the gates read (split R-hat of Ve and Vg, corr of chains 0 and
  1's GEBV, pooled accuracy), so each bar can sit between sound and faulty.
  Phases 10a (ssbrm, 4 chains, on phase 7's cohort: the fault in the
  epsilon sweep, each chain k drawing epsilon against chain k+1's
  residual) and 10b (sbrm, 4 chains, on phase 5's tiled LD: each chain k
  sweeping against chain k+1's r_hat) likewise, with their gates' numbers
  (R-hat of Ve, Veps and J and the GEBV agreement on the ids with data;
  R-hat of Vg and each chain's accuracy).  Default: every phase.
ssbrm_reference: split R-hat of J, Veps and Ve from the JAX package's
  ssbrm(nchains=4) and the port's on one small cohort of phase 10a's shape
  (fault 23 in ROADMAP.md).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def rehearse(seed=2024):
    import torch

    import chip_smoke as cs
    import hibayes_tpu_torch as htt

    torch.set_num_threads(4)
    gen = torch.Generator().manual_seed(seed)
    M, data, gv = cs.simulate(torch, 4096, 65536, gen, torch.device("cpu"))
    t0 = time.time()
    fit = htt.ibrm("y ~ x1 + (1|grp)", data=data, M=M, M_id=data["id"], method="BayesCpi",
                   niter=200, nburn=100, thin=5, block=128, seed=seed, device="cpu",
                   nchains=2, verbose=False)
    g0, g1 = cs.chain_gebv(fit, 2, 20)
    gvn = gv.numpy()
    print(f"rehearse seed {seed} ({time.time() - t0:.0f} s): corr(chain 0, chain 1) "
          f"{np.corrcoef(g0, g1)[0, 1]:.4f}; accuracy chain 0 {np.corrcoef(g0, gvn)[0, 1]:.4f}, "
          f"chain 1 {np.corrcoef(g1, gvn)[0, 1]:.4f}, pooled "
          f"{np.corrcoef(fit.g['gebv'], gvn)[0, 1]:.4f}; R-hat Ve {fit.rhat['Ve']:.4f} "
          f"Vg {fit.rhat['Vg']:.4f}", flush=True)


def reference(niter=400):
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import torch

    from hibayes_tpu.engine import gibbs as G
    from hibayes_tpu_torch.engine import gibbs as TG

    torch.set_num_threads(4)
    rng = np.random.default_rng(1)
    n, m = 512, 8192
    M = rng.binomial(2, rng.uniform(0.05, 0.5, m), size=(n, m)).astype(np.int8)
    b = np.zeros(m)
    b[rng.choice(m, 50, replace=False)] = rng.normal(size=50)
    gv = M @ b
    y = (gv - gv.mean()) / gv.std() * np.sqrt(0.5) + rng.normal(0, np.sqrt(0.5), n)
    data = G.prepare_gibbs_data(y, M, block=128, geno_dtype="int8")
    pi = np.array([0.95, 0.05])
    pr = G.resolve_priors(y, float(np.asarray(data.vx).sum()), pi[0], nr=0)
    kw = dict(model="BayesCpi", n=n, m=m, m_pad=int(data.xpx.shape[0]), block=128, nc=0,
              nlevels=(), n_fold=2, niter=niter, nburn=100, thin=5,
              nvar0=int((np.asarray(data.vx)[:m] == 0).sum()), dfvara=pr.dfvara,
              s2vara=pr.s2vara, dfvare=pr.dfvare, s2vare=pr.s2vare, s2varg=pr.s2varg,
              lambda_rate0=pr.lambda_rate0)
    runs = (("JAX", lambda: G.run_chains(G.GibbsSpec(**kw), data, pr, pi, seed=3, nchains=4)),
            ("port", lambda: TG.run_chains(
                TG.GibbsSpec(**kw), TG.prepare_gibbs_data(y, M, block=128, geno_dtype="int8",
                                                          device="cpu"),
                pr, pi, seed=3, nchains=4)))
    for name, run in runs:
        t0 = time.time()
        _, smp, ex = run()
        r = ex["rhat"]
        print(f"reference {name} ({time.time() - t0:.0f} s): R-hat Ve {r['Ve']:.4f} Vg "
              f"{r['Vg']:.4f} pi {r['pi']:.4f}; chain means of Ve "
              f"{np.round(np.asarray(smp['Ve']).mean(1), 4).tolist()}", flush=True)


def ssbrm_reference(niter=200, nburn=100, nchains=4):
    """Split R-hat of J, Veps and Ve from the JAX package's ssbrm(nchains=4)
    and the port's on one small cohort of phase 10a's shape (m >> records,
    most ids without a genotype): 4,000 ids, 800 genotyped (m=4,000), 200
    genotyped and 200 non-genotyped phenotyped, 200 iterations, burn-in
    100, thin 5 (20 records a chain, as 10a), chain seeds 1-3."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import torch

    import hibayes_tpu_torch as htt
    from hibayes_tpu.model.ssbrm import ssbrm as jax_ssbrm
    from tests.test_torch_ssbrm import _ss_problem

    torch.set_num_threads(4)
    prob = _ss_problem(seed=11, nfound=200, nkid=3800, n_g=800, m=4000, n_causal=40,
                       n_pg=200, n_pn=200)
    keys = ("data", "M", "M_id", "pedigree")
    kw = dict(method="BayesCpi", niter=niter, nburn=nburn, thin=5, verbose=False,
              impute="pcg", chunk_cols=256, nchains=nchains)
    n_rec = (niter - nburn) // 5
    for seed in (1, 2, 3):
        for name, run in (("JAX", lambda: jax_ssbrm("y~1", **{k: prob[k] for k in keys},
                                                    seed=seed, **kw)),
                          ("port", lambda: htt.ssbrm("y~1", **{k: prob[k] for k in keys},
                                                     seed=seed, device="cpu", **kw))):
            t0 = time.time()
            fit = run()
            means = {k: np.round(np.asarray(fit.MCMCsamples[k]).reshape(nchains, n_rec)
                                 .mean(1), 4).tolist() for k in ("J", "Veps", "Ve")}
            print("ssbrm_reference", json.dumps({
                "package": name, "seed": seed, "seconds": round(time.time() - t0, 1),
                **{f"rhat_{k}": float(fit.rhat[k]) for k in ("J", "Veps", "Ve", "Vg")},
                "chain_means": means}), flush=True)


def windows(w=20):
    import torch

    import chip_smoke as cs
    import hibayes_tpu_torch as htt
    from hibayes_tpu_torch.engine import gibbs as TG

    dev = torch.device("cuda")
    smi = cs.smi_line()
    print(smi, flush=True)
    gen = torch.Generator(device=dev).manual_seed(2024)

    def rows(fit, K, n_rec, gv=None):
        s = fit.MCMCsamples
        out = []
        for start in range(0, n_rec - w + 1, w):
            sl = slice(start, start + w)
            row = {"records": [start, start + w]}
            for k in ("Ve", "Vg", "h2"):
                row[k] = TG.gelman_rubin(s[k].reshape(K, n_rec)[:, sl])
            if gv is not None:
                g = s["g"].reshape(s["g"].shape[0], K, n_rec)
                row["corr01"] = float(np.corrcoef(g[:, 0, sl].mean(1), g[:, 1, sl].mean(1))[0, 1])
                row["acc"] = float(np.corrcoef(g[:, :, sl].mean((1, 2)), gv)[0, 1])
            out.append(row)
        return out

    for what, n, m, method, K, niter in (("4c", 4096, 65536, "BayesCpi", 64, 1500),
                                          ("4b", 50_000, 65536, "BayesR", 4, 800)):
        M, data, gv = cs.simulate(torch, n, m, gen, dev)
        fit = htt.ibrm("y ~ x1 + (1|grp)", data=data, M=M, M_id=data["id"], method=method,
                       niter=niter, nburn=0, thin=5, block=128, seed=2024, device=dev,
                       nchains=K, verbose=False)
        print(what, json.dumps({"ms_per_iter": 1e3 * fit.chain_seconds / niter,
                                "windows": rows(fit, K, niter // 5, gv.cpu().numpy())}),
              flush=True)
        del M, data, gv, fit
        torch.cuda.empty_cache()
    LD = cs.ar1_ld(torch, 32768, dev)
    ss, _ = cs.summary_stats(torch, lambda v: LD @ v, 32768, 32768, gen, dev)
    fit = htt.sbrm(ss, LD, method="BayesCpi", niter=1000, nburn=0, thin=5, seed=2024,
                   device=dev, nchains=4, verbose=False)
    print("6b", json.dumps({"ms_per_iter": 1e3 * fit.chain_seconds / 1000,
                            "windows": rows(fit, 4, 200)}), flush=True)


def _planted(fn, index, kind, at):
    """``fn`` with argument ``index`` (a chain batch's state) rolled by one
    chain, at its call ``at`` ("once") or at every call ("always"): chain k
    then sweeps against chain k+1's state."""
    calls = [0]

    def wrapped(*a, **kw):
        if kind == "always" or calls[0] == at:
            a = a[:index] + (a[index].roll(-1, 0),) + a[index + 1:]
        calls[0] += 1
        return fn(*a, **kw)
    wrapped.launches = fn.launches   # the wrapper counts through this name
    return wrapped


def fault(phases=("4c", "4b", "10a", "10b"), niter=200, nburn=100, at=100):
    import torch

    import chip_smoke as cs
    import hibayes_tpu_torch as htt
    from hibayes_tpu_torch.ops import blockgibbs as TB

    dev = torch.device("cuda")
    print(cs.smi_line(), flush=True)
    gen = torch.Generator(device=dev).manual_seed(2024)
    n_rec = (niter - nburn) // 5
    sound = {k: getattr(TB, k) for k in ("sweep_mc", "mme_sweep", "sweep_s_tiled")}
    faulty = {"4c": ("sweep_mc", 13), "4b": ("sweep_mc", 13), "10a": ("mme_sweep", 6),
              "10b": ("sweep_s_tiled", 4)}

    def runs(what):
        for seed in (2024, 2025):
            for kind in ("none", "once", "always"):
                name, index = faulty[what]
                for k, fn in sound.items():
                    setattr(TB, k, fn)
                if kind != "none":
                    setattr(TB, name, _planted(sound[name], index, kind, at))
                yield seed, kind

    def line(what, seed, kind, **nums):
        print(what, json.dumps({"seed": seed, "fault": kind, **nums}), flush=True)

    try:
        if "4c" in phases or "4b" in phases:
            cs.simulate(torch, 4096, 1024, gen, dev)   # chip_smoke.py's draws before phase 4
            flagship = cs.simulate(torch, 50_000, 65536, gen, dev)
            mc64 = cs.simulate(torch, 4096, 65536, gen, dev)
            for what, (M, data, gv), method, K in (("4c", mc64, "BayesCpi", 64),
                                                   ("4b", flagship, "BayesR", 4)):
                if what not in phases:
                    continue
                gvn = gv.cpu().numpy()
                for seed, kind in runs(what):
                    fit = htt.ibrm("y ~ x1 + (1|grp)", data=data, M=M, M_id=data["id"],
                                   method=method, niter=niter, nburn=nburn, thin=5,
                                   block=128, seed=seed, device=dev, nchains=K,
                                   verbose=False)
                    g0, g1 = cs.chain_gebv(fit, K, n_rec)[:2]
                    ve = fit.MCMCsamples["Ve"].reshape(K, n_rec).mean(axis=1)
                    line(what, seed, kind, rhat_Ve=fit.rhat["Ve"], rhat_Vg=fit.rhat["Vg"],
                         corr01=float(np.corrcoef(g0, g1)[0, 1]),
                         acc=float(np.corrcoef(fit.g["gebv"], gvn)[0, 1]),
                         ve_spread=float((ve.max() - ve.min()) / ve.mean()),
                         finite=bool(np.isfinite(fit.MCMCsamples["g"]).all()),
                         Ve=fit.Ve, h2=fit.h2)
                    del fit
            del flagship, mc64
            torch.cuda.empty_cache()
        if "10b" in phases:
            from hibayes_tpu_torch.data import sparse_ld as TSLD

            tld = cs.banded_ld(torch, TSLD, 500_000, dev)
            ss, b_true = cs.summary_stats(torch, cs.tiled_matvec(torch, tld), 500_000,
                                          tld.m_pad, gen, dev)
            for seed, kind in runs("10b"):
                fit = htt.sbrm(ss, tld, method="BayesCpi", fold=np.array([0.0, 1.0]),
                               niter=niter, nburn=nburn, thin=5, seed=seed, device=dev,
                               nchains=4, verbose=False)
                alpha = cs.per_chain(fit, "alpha", 4, n_rec)
                line("10b", seed, kind, rhat_Vg=fit.rhat["Vg"], rhat_Ve=fit.rhat["Ve"],
                     acc=float(np.corrcoef(fit.alpha, b_true)[0, 1]),
                     acc_per_chain=[float(np.corrcoef(alpha[c].mean(0), b_true)[0, 1])
                                    for c in range(4)],
                     finite=bool(np.isfinite(alpha).all()), guard=np.asarray(fit.guard).tolist())
                del fit
            del tld
            torch.cuda.empty_cache()
        if "10a" in phases:
            ids, sires, dams, gi, phe, Mg, gv, y, _ = cs.ssbrm_cohort(
                torch, 100_000, 100_000, 2024, gen, dev)
            gvn = gv.cpu().numpy()
            ng_phe = np.setdiff1d(phe, gi)
            for seed, kind in runs("10a"):
                fit = htt.ssbrm("y ~ 1", data={"id": ids[phe], "y": y}, M=Mg, M_id=ids[gi],
                                pedigree={"id": ids, "sire": sires, "dam": dams},
                                method="BayesCpi", niter=niter, nburn=nburn, thin=5,
                                impute="pcg", chunk_cols=2048, seed=seed, device=dev,
                                nchains=4, verbose=False)
                gebv = dict(zip(fit.g["id"], fit.g["gebv"]))
                pos = {v: i for i, v in enumerate(fit.g["id"])}
                held = np.array([pos[i] for i in ids[np.union1d(gi, phe)]])
                g01 = cs.chain_gebv(fit, 4, n_rec)
                line("10a", seed, kind, rhat_Ve=fit.rhat["Ve"], rhat_Veps=fit.rhat["Veps"],
                     rhat_J=fit.rhat["J"],
                     corr01=float(np.corrcoef(g01[0][held], g01[1][held])[0, 1]),
                     corr01_all=float(np.corrcoef(g01[0], g01[1])[0, 1]),
                     acc=float(np.corrcoef([gebv[i] for i in ids[ng_phe]], gvn[ng_phe])[0, 1]),
                     finite=bool(np.isfinite(fit.MCMCsamples["epsilon"]).all()),
                     Veps=fit.Veps, J=fit.J, imputation_s=fit.setup_seconds["imputation"])
                del fit
    finally:
        for k, fn in sound.items():
            setattr(TB, k, fn)


if __name__ == "__main__":
    if sys.argv[1] == "fault" and len(sys.argv) > 2:
        fault(tuple(sys.argv[2:]))
    else:
        {"rehearse": rehearse, "reference": reference, "ssbrm_reference": ssbrm_reference,
         "windows": windows, "fault": fault}[sys.argv[1]]()
