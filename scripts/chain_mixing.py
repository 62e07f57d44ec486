#!/usr/bin/env python3
"""How fast a chain batch mixes, for the gates of chip_smoke.py's
multi-chain phases.  Four studies:

    python3 scripts/chain_mixing.py rehearse     # CPU, about 15 minutes
    python3 scripts/chain_mixing.py reference    # CPU, needs the JAX package
    python3 scripts/chain_mixing.py windows      # on the card
    python3 scripts/chain_mixing.py fault        # on the card, about 3 minutes

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


def fault(niter=200, nburn=100, at=100):
    import torch

    import chip_smoke as cs
    import hibayes_tpu_torch as htt
    from hibayes_tpu_torch.ops import blockgibbs as TB

    dev = torch.device("cuda")
    print(cs.smi_line(), flush=True)
    gen = torch.Generator(device=dev).manual_seed(2024)
    cs.simulate(torch, 4096, 1024, gen, dev)   # chip_smoke.py's draws before phase 4
    flagship = cs.simulate(torch, 50_000, 65536, gen, dev)
    mc64 = cs.simulate(torch, 4096, 65536, gen, dev)
    sound = TB.sweep_mc

    def planted(kind):
        calls = [0]

        def sweep_mc(spec, *a, **kw):
            if kind == "always" or calls[0] == at:
                a = a[:12] + (a[12].roll(-1, 0),) + a[13:]   # yadj of chain k + 1
            calls[0] += 1
            return sound(spec, *a, **kw)
        sweep_mc.launches = sound.launches   # the wrapper counts through this name
        return sweep_mc

    n_rec = (niter - nburn) // 5
    try:
        for what, (M, data, gv), method, K in (("4c", mc64, "BayesCpi", 64),
                                               ("4b", flagship, "BayesR", 4)):
            gvn = gv.cpu().numpy()
            for seed in (2024, 2025):
                for kind in ("none", "once", "always"):
                    TB.sweep_mc = sound if kind == "none" else planted(kind)
                    fit = htt.ibrm("y ~ x1 + (1|grp)", data=data, M=M, M_id=data["id"],
                                   method=method, niter=niter, nburn=nburn, thin=5,
                                   block=128, seed=seed, device=dev, nchains=K,
                                   verbose=False)
                    g0, g1 = cs.chain_gebv(fit, K, n_rec)[:2]
                    ve = fit.MCMCsamples["Ve"].reshape(K, n_rec).mean(axis=1)
                    print(what, json.dumps({
                        "seed": seed, "fault": kind, "rhat_Ve": fit.rhat["Ve"],
                        "rhat_Vg": fit.rhat["Vg"],
                        "corr01": float(np.corrcoef(g0, g1)[0, 1]),
                        "acc": float(np.corrcoef(fit.g["gebv"], gvn)[0, 1]),
                        "ve_spread": float((ve.max() - ve.min()) / ve.mean()),
                        "finite": bool(np.isfinite(fit.MCMCsamples["g"]).all()),
                        "Ve": fit.Ve, "h2": fit.h2}), flush=True)
                    del fit
    finally:
        TB.sweep_mc = sound


if __name__ == "__main__":
    {"rehearse": rehearse, "reference": reference, "windows": windows,
     "fault": fault}[sys.argv[1]]()
