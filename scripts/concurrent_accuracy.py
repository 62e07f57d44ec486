#!/usr/bin/env python3
"""How far the relaxed concurrent schedule moves a fit, for the GEBV bars
of chip_smoke.py's phase 13a.

    python3 scripts/concurrent_accuracy.py                  # CPU, about 10 minutes
    python3 scripts/concurrent_accuracy.py --n 4096 --device cuda

chip_smoke.py's flagship recipe (ibrm BayesR, B=128, h2=0.5, a covariate
and a 20-level factor; m/n = 65,536/50,000 and the causal SNPs a fixed
share of n, so each causal SNP's marginal z is the flagship's) at a
smaller n, for two cohort seeds: the exact chain ("turn"), then
emulate_shards=4 with merge_rounds 1 and 2 (phase 13a(ii)'s and
(iii)'s), 200 iterations, burn-in 100, thin 5, one chain each; and each
schedule's chain after 50 iterations (burn-in 25, as 13a(iii)).  One JSON
line per run: the GEBV accuracy against the simulated genetic values,
the GEBV correlation with the exact chain, Vg and Ve.  The plain sweep
runs on the CPU (the kernels on the card, with --device cuda).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FLAGSHIP_N, FLAGSHIP_M, FLAGSHIP_CAUSAL = 50_000, 65_536, 500


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=2_000)
    ap.add_argument("--seeds", type=int, nargs="+", default=[2024, 1212])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    import torch

    import chip_smoke
    import hibayes_tpu_torch as ht

    torch.set_num_threads(args.threads)
    n = args.n
    m = round(n * FLAGSHIP_M / FLAGSHIP_N)
    n_causal = max(1, round(FLAGSHIP_CAUSAL * n / FLAGSHIP_N))
    dev = torch.device(args.device)
    for seed in args.seeds:
        gen = torch.Generator(device=dev).manual_seed(seed)
        M, data, gv = chip_smoke.simulate(torch, n, m, gen, dev, n_causal=n_causal)
        gvn = gv.cpu().numpy()
        exact = {}
        for niter in (200, 50):
            for name, kw in (("turn", {}),
                             ("concurrent S=4 Rm=1", dict(shard_schedule="concurrent",
                                                          emulate_shards=4)),
                             ("concurrent S=4 Rm=2", dict(shard_schedule="concurrent",
                                                          emulate_shards=4, merge_rounds=2))):
                t0 = time.perf_counter()
                with warnings.catch_warnings(record=True) as w:
                    warnings.simplefilter("always")
                    fit = ht.ibrm("y ~ x1 + (1|grp)", data=data, M=M, M_id=data["id"],
                                  method="BayesR", niter=niter, nburn=niter // 2, thin=5,
                                  block=128, seed=seed, device=dev, verbose=False, **kw)
                gebv = fit.g["gebv"]
                if name == "turn":
                    exact[niter] = gebv
                print(json.dumps({
                    "seed": seed, "n": n, "m": m, "n_causal": n_causal, "niter": niter,
                    "schedule": name,
                    "gebv_acc": float(np.corrcoef(gebv, gvn)[0, 1]),
                    "corr_with_exact": float(np.corrcoef(gebv, exact[niter])[0, 1]),
                    "Vg": float(fit.Vg), "Ve": float(fit.Ve),
                    "warned_m_above_n": any("block-Jacobi" in str(x.message) for x in w),
                    "seconds": round(time.perf_counter() - t0, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
