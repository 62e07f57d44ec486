#!/usr/bin/env python3
"""Where the one-chain sweep's block time goes: ``sweep1_kernel`` of the
hibayes_tpu_torch package under ``--root``, split per block from its timer
stamps by that checkout's own ``chip_smoke.sweep_split``, so that two trees
(whose stamps may mean different stages) are read side by side in one call
on one card:

    python3 scripts/sweep1_split.py --root DIR --label parent --n 50176 200192

For each n: an int8 genotype of n rows and ``--blocks`` blocks of 128 SNPs
made on the card from a fixed seed (chip_smoke.make_genotype), one BayesR
chain's sweep inputs (chip_smoke.sweep_args), then the full sweep's device
ms (CUDA events, the mean of ``--reps`` sweeps after a warm-up), the
per-block split, a check of the first ``--check`` blocks against the plain
version at the kernel bar (chip_smoke.bar), a second launch bit for bit the
first, a SHA-256 of the full sweep's outputs, and with ``--raw R`` the raw
stamps of R records.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys


def _chip_smoke(root):
    spec = importlib.util.spec_from_file_location("chip_smoke_split",
                                                  os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--n", type=int, nargs="+", default=[50_176, 200_192])
    ap.add_argument("--blocks", type=int, default=256)
    ap.add_argument("--check", type=int, default=8)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--raw", type=int, default=0, help="records of raw stamps to print")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("sweep1_split: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from hibayes_tpu_torch.engine import gibbs as TG
    from hibayes_tpu_torch.ops import blockgibbs as TB

    cs = _chip_smoke(root)
    dev = torch.device("cuda", 0)
    B, m = 128, args.blocks * 128
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = {"label": args.label, "card": card.strip().splitlines()[0] if card else None}
    for n in args.n:
        gen = torch.Generator(device=dev).manual_seed(19)
        M = cs.make_genotype(torch, n, m, gen, dev)
        y = (M[:, :64].float() @ (0.1 * torch.randn(64, generator=gen, device=dev))
             + torch.randn(n, generator=gen, device=dev)).cpu().numpy()
        data = TG.prepare_gibbs_data(y, M, block=B, fold=cs.fold_prior(4)[1],
                                     geno_dtype="int8", device=dev)
        del M
        spec, pr, pi = cs.make_spec(TG, "BayesR", data, m, n)
        sargs = cs.sweep_args(torch, TG, spec, data, pr, pi, 1, seed=1)
        consts, X, W, xpx, vx, *per = sargs
        c = slice(0, args.check * B)
        part = (spec, consts, X, W, xpx[c], vx[c], *(a[:, c] for a in per[:7]), per[7], per[8])
        rng = (0, args.check)
        err = cs.bar(TB.sweep_mc_plain(*part, block_range=rng),
                     TB.sweep_mc(*part, block_range=rng), f"sweep_mc at n={n}")
        first, again = (TB.sweep_mc(spec, *sargs) for _ in range(2))
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            raise AssertionError(f"n={n}: two launches differ")
        h = hashlib.sha256()
        for t in first[:5]:
            h.update(t.float().cpu().numpy().tobytes())
        full = (spec, *sargs)
        ms = cs.cuda_ms(torch, lambda: TB.sweep_mc(*full), args.reps)
        split = cs.sweep_split(torch, TB, spec, full, spec.nblocks)
        out[str(n)] = {"sweep_ms": ms, "us_per_block": 1e3 * ms / spec.nblocks,
                       "max_g_err": err, "sha256": h.hexdigest()[:16], "split": split}
        if args.raw:   # records 10 .. 10 + raw, ns from record 10's first stamp
            st = torch.zeros(16 * (spec.nblocks + 1), dtype=torch.int64, device=dev)
            TB.sweep_mc(*full, stamps=st)
            r = st.view(-1, 16)[10:10 + args.raw].cpu().numpy()
            out[str(n)]["raw"] = (r - r[r > 0].min()).tolist()
        del data, sargs, part, full, first, again, X, W
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
