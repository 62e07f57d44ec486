#!/usr/bin/env python3
"""Times the fused sweep (``ops/blockgibbs.sweep_mc``) of the
hibayes_tpu_torch package under ``--root`` at chip_smoke.py's shapes, so
that two trees can be held side by side in one call on one card:

    python3 scripts/sweep_routes.py --root DIR --label parent

Cases, each 16 blocks of 128 SNPs of an int8 genotype:

    k1_n50k   K=1, n=50,000, BayesR     (PERF.md kernel table rows 1 and 3)
    k4_n50k   K=4, n=50,000, BayesR     (phase 4b's sweep)
    k64_n4k   K=64, n=4,096, BayesCpi   (row 2)

A tree from before the K-chain rows kernel runs K >= 2 through
``rows_kernel`` on a (row tiles, K) grid, one CTA per tile per chain; a
later one through ``rows_mc_kernel``.  The inputs are made from fixed seeds
with chip_smoke.py's helpers (taken from this script's own checkout), so
both trees sweep the same numbers.  Prints one JSON line: the label, the
card, ms per sweep for each case (CUDA events, the mean of --reps sweeps
after one warm-up) in --rounds rounds, and a SHA-256 of each case's outputs.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = (("k1_n50k", 50_000, 1, "BayesR"), ("k4_n50k", 50_000, 4, "BayesR"),
         ("k64_n4k", 4096, 64, "BayesCpi"))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE, help="checkout whose hibayes_tpu_torch is timed")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--nblocks", type=int, default=16)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("sweep_routes: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from hibayes_tpu_torch.engine import gibbs as TG
    from hibayes_tpu_torch.ops import blockgibbs as TB

    cs = _chip_smoke()
    dev = torch.device("cuda", 0)
    B = 128
    m = args.nblocks * B
    runs, digests = {}, {}
    for key, n, K, model in CASES:
        gen = torch.Generator(device=dev).manual_seed(31)
        M = cs.make_genotype(torch, n, m, gen, dev)
        y = (M[:, :64].float() @ (0.1 * torch.randn(64, generator=gen, device=dev))
             + torch.randn(n, generator=gen, device=dev)).cpu().numpy()
        fold = np.array([0.0, 1e-4, 1e-3, 1e-2]) if model == "BayesR" else None
        data = TG.prepare_gibbs_data(y, M, block=B, fold=fold, geno_dtype="int8", device=dev)
        spec, pr, pi = cs.make_spec(TG, model, data, m, n)
        sargs = cs.sweep_args(torch, TG, spec, data, pr, pi, K, seed=K)
        out = TB.sweep_mc(spec, *sargs)
        torch.cuda.synchronize()
        h = hashlib.sha256()
        for t in out[:5]:
            h.update(t.float().cpu().numpy().tobytes())
        digests[key] = h.hexdigest()[:16]
        runs[key] = (spec, sargs)
    times = {key: [] for key in runs}
    for _ in range(args.rounds):
        for key, (spec, sargs) in runs.items():
            times[key].append(cs.cuda_ms(torch, lambda: TB.sweep_mc(spec, *sargs), args.reps))
    print(json.dumps({"label": args.label, "card": cs.smi_line(), "ms": times,
                      "sha256": digests}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
