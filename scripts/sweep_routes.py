#!/usr/bin/env python3
"""Times the sweeps of the hibayes_tpu_torch package under ``--root`` at
chip_smoke.py's shapes, so that two trees can be held side by side in one
call on one card:

    python3 scripts/sweep_routes.py --root DIR --label parent

Cases: the fused sweep (``ops/blockgibbs.sweep_mc``) over 16 blocks of 128
SNPs of an int8 genotype, and the tiled summary sweep
(``ops/blockgibbs.sweep_s_tiled``) over the first 256 tile rows of phase
5's band:

    k1_n50k     K=1, n=50,000, BayesR     (PERF.md kernel table rows 1 and 3)
    k4_n50k     K=4, n=50,000, BayesR     (phase 4b's sweep)
    k64_n4k     K=64, n=4,096, BayesCpi   (row 2)
    k1_n50k_128 K=1, n=50,000, BayesR, 128 blocks, and
    k4_n50k_128 K=4: long enough that the device, not the host's enqueue,
                sets the time (a 16-block sweep is mostly the host's
                Python and launches)
    k1_n131k    K=1, n=131,072, BayesR     (row 8)
    draws       block_draws, one block of 128 BayesR draws of k1_n50k (row 7)
    tiled_256   one chain, BayesCpi with the guard, 256 tile rows of 128 in
                a 9-tile band of 0.9^|i-j| (row 9)
    segment_32k the dense segment sweep of phase 6, m=32,768 AR(1) LD, B=64
                (row 6)

and, at K=4 and K=64, ``*_matmul``: torch.matmul of the sweep's two
products per block, (K, n) x (n, B) and (K, B) x (B, n) in float32, the
library yardstick (the same torch code under either root).

The inputs are made from fixed seeds with chip_smoke.py's helpers (taken
from this script's own checkout), so both trees sweep the same numbers.
Prints one JSON line: the label, the card, ms per sweep for each case (CUDA
events, the mean of --reps sweeps after a warm-up) in --rounds rounds, and
a SHA-256 of each case's outputs.
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
CASES = (("k1_n50k", 50_000, 1, "BayesR", 16), ("k4_n50k", 50_000, 4, "BayesR", 16),
         ("k64_n4k", 4096, 64, "BayesCpi", 16), ("k1_n50k_128", 50_000, 1, "BayesR", 128),
         ("k4_n50k_128", 50_000, 4, "BayesR", 128), ("k1_n131k", 131_072, 1, "BayesR", 16))


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
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("sweep_routes: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from hibayes_tpu_torch.data import sparse_ld as TSLD
    from hibayes_tpu_torch.engine import gibbs as TG
    from hibayes_tpu_torch.engine import sgibbs as TSG
    from hibayes_tpu_torch.ops import blockgibbs as TB

    cs = _chip_smoke()
    dev = torch.device("cuda", 0)
    B = 128
    runs, digests = {}, {}
    for key, n, K, model, nblocks in CASES:
        m = nblocks * B
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
        runs[key] = lambda spec=spec, sargs=sargs: TB.sweep_mc(spec, *sargs)
        if key == "k1_n50k":   # one block's draws at the main path's shapes
            consts, X, W, xpx, vx, *per = sargs
            Pk = TB.pack_rows(spec, consts, xpx, vx, per[0], per[1], per[2], per[3],
                              per[4], per[6], torch.float32)
            P_b = TB.to_block_layout(Pk, spec.nblocks, B)[0].contiguous()
            r0 = (per[7] @ X[0].float()).T.contiguous()
            logpi = consts["logpi"][:, :1].T.contiguous()
            dargs = (spec, logpi, P_b, W[0], r0)
            out = TB.block_draws(*dargs)
            h = hashlib.sha256()
            for t in out:
                h.update(t.float().cpu().numpy().tobytes())
            digests["draws"] = h.hexdigest()[:16]
            runs["draws"] = lambda dargs=dargs: TB.block_draws(*dargs)
        if K > 1 and nblocks == 16:
            Xf = data.X_blocks.float()
            dg = 0.01 * torch.randn((K, B), generator=gen, device=dev)

            def products(Xf=Xf, yadj=sargs[12], dg=dg):
                for b in range(Xf.shape[0]):
                    torch.matmul(yadj, Xf[b])
                    torch.matmul(dg, Xf[b].T)

            runs[key + "_matmul"] = products
        del M
    # the tiled sweep: 256 tile rows of phase 5's band
    rows = 256
    gen = torch.Generator(device=dev).manual_seed(37)
    tld = cs.banded_ld(torch, TSLD, rows * B, dev)
    ss, _ = cs.summary_stats(torch, cs.tiled_matvec(torch, tld), rows * B, tld.m_pad, gen, dev)
    sdata, sspec, spr, spi = cs.s_setup(torch, TG, TSG, ss, tld, "BayesCpi", B, dev, True)
    g, r, P = cs.s_sweep_inputs(torch, TSG, sspec, sdata, spr, spi,
                                cs.tiled_matvec(torch, tld), 9)
    full = (sdata.ld_tiles, sdata.ld_cols, sdata.ld_valid, r, P, sspec.n)
    out = TB.sweep_s_tiled(sspec, *full)
    torch.cuda.synchronize()
    h = hashlib.sha256()
    for t in out:
        h.update(t.float().cpu().numpy().tobytes())
    digests["tiled_256"] = h.hexdigest()[:16]
    runs["tiled_256"] = lambda full=full: TB.sweep_s_tiled(sspec, *full)
    del tld, sdata
    # the dense segment sweep of phase 6
    from hibayes_tpu_torch.data.ld import DenseLD

    md = 32_768
    LD = cs.ar1_ld(torch, md, dev)
    ss, _ = cs.summary_stats(torch, lambda v: LD @ v, md, md, gen, dev)
    ddata, dspec, dpr, dpi = cs.s_setup(torch, TG, TSG, ss, DenseLD(values=LD), "BayesCpi",
                                        64, dev, False)
    del LD
    seg = ddata.ld_segs[0]
    g, r, P = cs.s_sweep_inputs(torch, TSG, dspec, ddata, dpr, dpi, lambda v: seg @ v, 9)
    out = TB.sweep_s_segment(dspec, seg, r, P, dspec.n)
    torch.cuda.synchronize()
    h = hashlib.sha256()
    for t in out:
        h.update(t.float().cpu().numpy().tobytes())
    digests["segment_32k"] = h.hexdigest()[:16]
    runs["segment_32k"] = lambda seg=seg, r=r, P=P: TB.sweep_s_segment(dspec, seg, r, P, dspec.n)
    times = {key: [] for key in runs}
    for _ in range(args.rounds):
        for key, fn in runs.items():
            times[key].append(cs.cuda_ms(torch, fn, args.reps))
    print(json.dumps({"label": args.label, "card": cs.smi_line(), "ms": times,
                      "sha256": digests}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
