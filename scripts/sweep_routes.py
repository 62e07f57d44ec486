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
                a 9-tile band of 0.9^|i-j| (row 9), and
    tiled_256_guard_fires  the same at vary lowered 1,000-fold, so the
                guard's retries run (its rejection count is hashed too)
    k1_n50k_r640, tiled_256_r640  BayesR at 640 folds (where the tree runs
                it, ``snp_major_rows``): k1_n50k's sweep, and tiled_256's
                guarded, whose 30 KB of rows a SNP overflow shared memory,
                so its draws read them from global memory; with
                tiled_256_r640_copy, the SNP-major copy of its rows alone
    segment_32k the dense segment sweep of phase 6, m=32,768 AR(1) LD, B=64
                (row 6), and
    segment_32k_k4  the same segment with 4 chains (phase 6b's sweep)
    mme_80k     the epsilon sweep of phase 7 (row 10): the RCM-ordered
                A-inverse(nn) of its 100,000-id pedigree, 80,000 sites in
                1,250 blocks of 64, timed with the L2 cold (a 128 MB buffer
                overwritten before each sweep, chip_smoke.cold_ms)

and, at K=4 and K=64, ``*_matmul``: torch.matmul of the sweep's two
products per block, (K, n) x (n, B) and (K, B) x (B, n) in float32, the
library yardstick (the same torch code under either root); beside the
segment cases ``segment_32k_mv`` and ``segment_32k_k4_mm``, torch.mv and
torch.mm of the update's whole product n LD dg.  The draw chain
alone (``blockgibbs.chain_latency``, one warp, 400 blocks of 128 back to
back) on k1_n50k's first block (BayesR, 4 folds) and tiled_256's first tile
row (BayesCpi, without and with the guard) is reported in clock cycles a
draw, and so is the epsilon chain alone (``blockgibbs.mme_chain_latency``,
400 chains of mme_80k's first block) where the tree has it.

The inputs are made from fixed seeds with chip_smoke.py's helpers (taken
from this script's own checkout), so both trees sweep the same numbers.
Prints one JSON line: the label, the card, ms per sweep for each case (CUDA
events, the mean of --reps sweeps after a warm-up) in --rounds rounds, the
chain's cycles a draw in each round, and a SHA-256 of each case's outputs.
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
    runs, digests, chains = {}, {}, {}
    many = hasattr(TB, "snp_major_rows")
    cases = CASES + ((("k1_n50k_r640", 50_000, 1, "BayesR", 16, 640),) if many else ())
    for key, n, K, model, nblocks, *nf in cases:
        nf = nf[0] if nf else 4
        m = nblocks * B
        gen = torch.Generator(device=dev).manual_seed(31)
        M = cs.make_genotype(torch, n, m, gen, dev)
        y = (M[:, :64].float() @ (0.1 * torch.randn(64, generator=gen, device=dev))
             + torch.randn(n, generator=gen, device=dev)).cpu().numpy()
        fold = cs.fold_prior(nf)[1] if model == "BayesR" else None
        data = TG.prepare_gibbs_data(y, M, block=B, fold=fold, geno_dtype="int8", device=dev)
        spec, pr, pi = cs.make_spec(TG, model, data, m, n, nf=nf)
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
            chains["chain_bayesr"] = (spec, W[0], P_b[:, :, 0].contiguous(),
                                      r0[:, 0].contiguous(), None)
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
    low = sspec.__class__(**{**sspec.__dict__, "vary": sspec.vary * 1e-3})
    out = TB.sweep_s_tiled(low, *full)
    torch.cuda.synchronize()
    if int(out[3]) == 0:
        raise AssertionError("tiled_256_guard_fires: the guard did not fire")
    h = hashlib.sha256()
    for t in out:
        h.update(t.float().cpu().numpy().tobytes())
    digests["tiled_256_guard_fires"] = h.hexdigest()[:16]
    runs["tiled_256_guard_fires"] = lambda full=full: TB.sweep_s_tiled(low, *full)
    if many:
        rdata, rspec, rpr, rpi = cs.s_setup(torch, TG, TSG, ss, tld, "BayesR", B, dev, True,
                                            nf=640)
        _, rr, rP = cs.s_sweep_inputs(torch, TSG, rspec, rdata, rpr, rpi,
                                      cs.tiled_matvec(torch, tld), 9)
        rfull = (rdata.ld_tiles, rdata.ld_cols, rdata.ld_valid, rr, rP, rspec.n)
        out = TB.sweep_s_tiled(rspec, *rfull)
        torch.cuda.synchronize()
        h = hashlib.sha256()
        for t in out:
            h.update(t.float().cpu().numpy().tobytes())
        digests["tiled_256_r640"] = h.hexdigest()[:16]
        runs["tiled_256_r640"] = lambda: TB.sweep_s_tiled(rspec, *rfull)
        rows3 = rP.reshape(-1, *rP.shape[-2:])
        runs["tiled_256_r640_copy"] = lambda: TB.snp_major_rows(rows3.transpose(1, 2))
    Wn = sspec.n * sdata.ld_tiles[0, 0]
    Pg = P[:, :B].T.contiguous()
    chains["chain_bayescpi"] = (sspec, Wn, Pg[:, :TB.n_rows(sspec)].contiguous(), r[:B], None)
    chains["chain_bayescpi_guard"] = (sspec, Wn, Pg, r[:B], sspec.vary)
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
    ins = [cs.s_sweep_inputs(torch, TSG, dspec, ddata, dpr, dpi, lambda v: seg @ v, 20 + k)
           for k in range(4)]
    r4, P4 = (torch.stack(x) for x in list(zip(*ins))[1:])
    out4 = TB.sweep_s_segment(dspec, seg, r4, P4, dspec.n)
    torch.cuda.synchronize()
    h = hashlib.sha256()
    for t in out4:
        h.update(t.float().cpu().numpy().tobytes())
    digests["segment_32k_k4"] = h.hexdigest()[:16]
    runs["segment_32k_k4"] = lambda: TB.sweep_s_segment(dspec, seg, r4, P4, dspec.n)
    dg1, dg4 = out[0], out4[0]
    runs["segment_32k_mv"] = lambda: torch.mv(seg, dg1)
    runs["segment_32k_k4_mm"] = lambda: torch.mm(seg, dg4.T)
    del ddata
    # the epsilon sweep of phase 7, its L2 cold
    n_ids = 100_000
    nfound, n_g, n_ph = n_ids // 20, n_ids // 5, n_ids // 20
    ids, sires, dams, _, _ = cs.make_pedigree(nfound, n_ids - nfound, 2024)
    prng = np.random.default_rng(2024)
    gi = np.sort(prng.choice(n_ids, n_g, replace=False))
    others = np.setdiff1d(np.arange(n_ids), gi)
    phe = np.concatenate([prng.choice(gi, n_ph, replace=False),
                          prng.choice(others, n_ph, replace=False)])
    lay, _, ng_ids = cs.ssbrm_layout(torch, TG, ids, sires, dams, ids[gi], dev)
    nbr, T, _ = lay.diag_blocks.shape
    qp = nbr * T
    codes = np.flatnonzero(np.isin(ng_ids, ids[phe]))
    counts = torch.as_tensor(np.bincount(codes, minlength=qp), dtype=torch.float32, device=dev)
    egen = torch.Generator(device=dev).manual_seed(41)
    f = lambda: torch.randn(qp, generator=egen, device=dev)
    x, b, z = 0.3 * f(), f(), f()
    scale, ve = torch.tensor(0.7, device=dev), torch.tensor(1.3, device=dev)
    res = b - scale * TG._epsl_matvec(lay, x) - counts * x
    margs = (lay, counts, scale, ve, z, x, res)
    out = TB.mme_sweep(*margs)
    torch.cuda.synchronize()
    h = hashlib.sha256()
    for t in out:
        h.update(t.float().cpu().numpy().tobytes())
    digests["mme_80k"] = h.hexdigest()[:16]
    cold = {"mme_80k": lambda: TB.mme_sweep(*margs)}
    if hasattr(TB, "mme_chain_latency"):
        mchain = (lay.diag_blocks[0], counts[:T], z[:T], scale, ve, res[:T])
    times = {key: [] for key in (*runs, *cold)}
    cycles = {key: [] for key in chains}
    if hasattr(TB, "mme_chain_latency"):
        cycles["mme_chain"] = []
    for _ in range(args.rounds):
        for key, fn in runs.items():
            times[key].append(cs.cuda_ms(torch, fn, args.reps))
        for key, fn in cold.items():
            times[key].append(cs.cold_ms(torch, fn, max(2, args.reps // 4)))
        for key, (cspec, W0, P0, r0, vary) in chains.items():
            cycles[key].append(cs.chain_us(torch, TB, cspec, W0, P0, r0, vary)[1] / B)
        if "mme_chain" in cycles:
            TB.mme_chain_latency(*mchain, 10)
            cycles["mme_chain"].append(int(TB.mme_chain_latency(*mchain, 400)) / 400 / T)
    print(json.dumps({"label": args.label, "card": cs.smi_line(), "ms": times,
                      "cycles_per_draw": cycles, "sha256": digests}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
