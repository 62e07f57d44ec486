#!/usr/bin/env python3
"""Times the BayesR draw chain alone at several fold counts, for the
hibayes_tpu_torch package under ``--root``, so that two trees can be held
side by side in one call on one card:

    python3 scripts/fold_chain.py --root DIR --label before

The chain (``ops/blockgibbs.chain_latency``: one warp, 400 blocks of 128
draws back to back, each block starting where the one before ended, the
Gram block and the packed rows already in shared memory) runs on the first
block of an int8 genotype of n=4,096 made with chip_smoke.py's helpers
(taken from this script's own checkout, so both trees draw the same
numbers), a chain's first iteration, BayesR with 4 and 8 folds (instances
compiled in) and 12, 16, 24 and 40 folds (the run-time fold instance; at
40 a lane evaluates two folds), each without and with the SBayesS
guard's predicate (the guard rows appended, vary the phenotype's variance;
not at 40 folds, whose 472 rows a SNP overflow a block of 128 in shared
memory).
Prints one JSON line: the label, the card, and for each case the clock
cycles a draw and the microseconds a block (CUDA events around one launch,
after a warm-up launch), in each of --rounds rounds.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FOLDS = (4, 8, 12, 16, 24, 40)


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
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("fold_chain: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from hibayes_tpu_torch.engine import gibbs as TG
    from hibayes_tpu_torch.ops import blockgibbs as TB

    from hibayes_tpu_torch.engine.rng import IterNoise

    cs = _chip_smoke()
    dev = torch.device("cuda", 0)
    n, B = 4096, 128
    gen = torch.Generator(device=dev).manual_seed(41)
    M = cs.make_genotype(torch, n, 2 * B, gen, dev)
    y = (M[:, :64].float() @ (0.1 * torch.randn(64, generator=gen, device=dev))
         + torch.randn(n, generator=gen, device=dev)).cpu().numpy()
    cases = {}
    for nf in FOLDS:
        # one chain at its first iteration (effects 0), with only the
        # interfaces both trees share: the packed rows of block 0, X_0' yadj
        pi, fold = cs.fold_prior(nf)
        data = TG.prepare_gibbs_data(y, M, block=B, fold=fold, geno_dtype="int8", device=dev)
        vx = data.vx
        pr = TG.resolve_priors(y, float(vx.sum()), pi[0], nr=0)
        spec = TG.GibbsSpec(
            model="BayesR", n=n, n_real=n, m=2 * B, m_pad=2 * B, block=B, nc=0, nlevels=(),
            n_fold=nf, niter=10, nburn=5, thin=5, nvar0=int((vx == 0).sum()),
            dfvara=pr.dfvara, s2vara=pr.s2vara, dfvare=pr.dfvare, s2vare=pr.s2vare,
            s2varg=pr.s2varg, lambda_rate0=pr.lambda_rate0)
        st = TG.init_state(spec, data, pr, pi)
        pre = TG._pre_sweep(spec, data, IterNoise(5, 0, dev), st)
        consts = {c: v[None] for c, v in pre["consts"].items()}
        z, u, chi, _ = (t[None] for t in pre["rnd"])
        P = TB.pack_rows(spec, consts, data.xpx, vx, pre["vei"][None], st.g[None], z, u, chi,
                         pre["vargL_in"][None], torch.float32)
        P_b = TB.to_block_layout(P, spec.nblocks, B)[0][:, :, 0].contiguous()
        r0 = (pre["yadj"] @ data.X_blocks[0].float()).contiguous()
        W = data.W_blocks
        # the guard's rows: vx, then 8 candidates a nonzero fold
        cand = 0.01 * torch.randn((B, TB.N_RETRY * (nf - 1)), generator=gen, device=dev)
        P_g = torch.cat([P_b, vx[:B, None].float(), cand], dim=1).contiguous()
        cases[f"bayesr_{nf}"] = (spec, W[0], P_b, r0, None)
        if TB.draws_smem(B, P_g.shape[1]) <= TB.SMEM_OPTIN:   # the guard's rows fit
            cases[f"bayesr_{nf}_guard"] = (spec, W[0], P_g, r0, float(np.var(y)))
    del M
    cycles = {k: [] for k in cases}
    us = {k: [] for k in cases}
    for _ in range(args.rounds):
        for key, (spec, Wb, Pb, r0, vary) in cases.items():
            u, c = cs.chain_us(torch, TB, spec, Wb, Pb, r0, vary)
            us[key].append(u)
            cycles[key].append(c / B)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=False).stdout.strip().splitlines()
    print(json.dumps({"label": args.label, "card": card[0] if card else None,
                      "cycles_per_draw": cycles, "us_per_block": us}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
