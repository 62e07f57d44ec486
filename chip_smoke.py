#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (hibayes_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, each printing as it goes:
  1. the device, and nvidia-smi's name and power limit; no CUDA device -> exit 2;
  2. build the CUDA kernels from csrc/ (nvcc), print the build time;
  3. every kernel against its plain PyTorch version on the card: the fused
     sweep for all six models x {int8, f32} x K in {1, 4} at n=4,096,
     m=1,024, B=128, one offset sweep (block_range), and the draw kernel;
     bar: at most 1% mixture draws flip, effects within 5e-5 max|g| where
     the draws agree, residuals within 1e-4 max|yadj| when none flips; a
     second kernel sweep on the same inputs must be bit-identical;
     then two small fits with one seed must agree bit for bit; then each
     kernel held to the bar and timed beside its plain version at the main
     path's shapes (n=50,000, B=128, K=1);
  4. the main path: hibayes_tpu_torch.ibrm("y ~ x1 + (1|grp)", method="BayesR")
     on one chain at n=50,000 x m=65,536 (int8 genotype made on the card,
     h2=0.5 from 500 causal SNPs), niter=200, nburn=100, thin=5; checks that
     the sweep ran through the kernels only (each CUDA kernel's launch count,
     kept by the library where it launches, is what the chain needs, and no
     plain version ran), finite 0 < h2 < 1, and the GEBV accuracy against
     the simulated truth;
  5. a JSON line of kernels, the nvidia-smi line, and the last line
     {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

# Accuracy bar of the main path (corr of posterior-mean GEBV with the true
# genetic value).  A dense prior would reach about the GBLUP accuracy for
# independent markers, sqrt(n h2 / (n h2 + m)) = 0.53 at n=50,000,
# m=65,536, h2=0.5.  With 500 causal SNPs each explains ~1e-3 of the
# variance, a marginal z of ~10 at this n, so a converged sparse BayesR fit
# recovers most of them: it measured 0.978 on an H100 (PERF.md).  The chain
# is deterministic for a seed; 0.9 leaves room for another card's rounding
# and still fails a sweep that draws wrongly.
GEBV_CORR_MIN = 0.9

MODELS = ["BayesRR", "BayesA", "BayesBpi", "BayesCpi", "BayesL", "BayesR"]


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def make_genotype(torch, n, m, gen, dev, chunk=4096):
    """(n, m) int8 allele counts, Binomial(2, p_j), p_j ~ U(0.05, 0.5)."""
    M = torch.empty((n, m), dtype=torch.int8, device=dev)
    p = torch.rand(m, generator=gen, device=dev) * 0.45 + 0.05
    for c0 in range(0, m, chunk):
        pc = p[c0:c0 + chunk]
        a = torch.rand((n, pc.numel()), generator=gen, device=dev) < pc
        b = torch.rand((n, pc.numel()), generator=gen, device=dev) < pc
        M[:, c0:c0 + chunk] = a.to(torch.int8) + b.to(torch.int8)
    return M


def simulate(torch, n, m, gen, dev, n_causal=500):
    """Genotype on the card, and a phenotype y = gv + 0.3 x1 + grp + e with
    h2 = 0.5 from n_causal SNPs, a covariate and a 20-level factor.
    Returns (M, the ibrm data dict, the true genetic values gv)."""
    M = make_genotype(torch, n, m, gen, dev)
    causal = torch.randperm(m, generator=gen, device=dev)[:n_causal]
    gv = M[:, causal].float() @ torch.randn(causal.numel(), generator=gen, device=dev)
    gv = (gv - gv.mean()) / gv.std() * np.sqrt(0.5)
    x1 = torch.randn(n, generator=gen, device=dev)
    grp = torch.randint(0, 20, (n,), generator=gen, device=dev)
    grp_eff = 0.3 * torch.randn(20, generator=gen, device=dev)
    y = gv + 0.3 * x1 + grp_eff[grp] + np.sqrt(0.5) * torch.randn(n, generator=gen, device=dev)
    data = {"id": np.array([f"id{i}" for i in range(n)]), "y": y.cpu().numpy(),
            "x1": x1.cpu().numpy(),
            "grp": np.array([f"g{k}" for k in grp.cpu().numpy()])}
    return M, data, gv


def make_spec(TG, model, data, m, n_real, niter=10, nburn=5):
    nf = 4 if model == "BayesR" else 2
    pi = (np.array([0.95, 0.02, 0.02, 0.01]) if nf == 4
          else np.array([0.0, 1.0]) if model in ("BayesRR", "BayesA", "BayesL")
          else np.array([0.95, 0.05]))
    vx = data.vx.cpu().numpy()
    pr = TG.resolve_priors(data.y[:n_real].cpu().numpy(), float(vx.sum()), pi[0], nr=0)
    spec = TG.GibbsSpec(
        model=model, n=int(data.y.shape[0]), n_real=n_real, m=m,
        m_pad=int(data.xpx.shape[0]), block=int(data.X_blocks.shape[2]),
        nc=0, nlevels=(), n_fold=nf, niter=niter, nburn=nburn, thin=5,
        nvar0=int((vx[:m] == 0).sum()), dfvara=pr.dfvara, s2vara=pr.s2vara,
        dfvare=pr.dfvare, s2vare=pr.s2vare, s2varg=pr.s2varg,
        lambda_rate0=pr.lambda_rate0)
    return spec, pr, pi


def sweep_args(torch, TG, spec, data, pr, pi, K, seed):
    """Batched sweep inputs for K chains: each chain's own pre-sweep noise
    and a sparse random effect vector, as a chain mid-run would hold."""
    from hibayes_tpu_torch.engine.rng import IterNoise

    dev = data.y.device
    state0 = TG.init_state(spec, data, pr, pi)
    cols = {k: [] for k in ("vei", "g", "z", "u", "chi", "z2", "vargL", "yadj", "uvec")}
    consts = []
    for k in range(K):
        gen = torch.Generator(device=dev).manual_seed(seed * 100 + k)
        nz = torch.rand(spec.m_pad, generator=gen, device=dev) < 0.1
        g = torch.where(nz & data.real, 0.02 * torch.randn(
            spec.m_pad, generator=gen, device=dev), 0.0)
        st = state0._replace(g=g, yadj=state0.yadj - TG.genotype_matmul(
            data.X_blocks, g[:, None], torch.float32)[:, 0])
        pre = TG._pre_sweep(spec, data, IterNoise(seed, k, dev), st)
        consts.append(pre["consts"])
        for name, v in zip(cols, (pre["vei"], g, *pre["rnd"], pre["vargL_in"],
                                  pre["yadj"], pre["u"])):
            cols[name].append(v)
    consts_b = {c: torch.stack([cc[c] for cc in consts]) for c in consts[0]}
    return (consts_b, data.X_blocks, data.W_blocks, data.xpx, data.vx,
            *(torch.stack(v) for v in cols.values()))


def bar(ref, out, what):
    """The kernel-vs-plain bar; returns max |g| error where the draws agree."""
    g_r, g_o = ref[0].cpu().numpy(), out[0].cpu().numpy()
    t_r, t_o = ref[1].cpu().numpy(), out[1].cpu().numpy()
    agree = t_r == t_o
    if agree.mean() < 0.99:
        raise AssertionError(f"{what}: {100 * (1 - agree.mean()):.2f}% draws flip")
    err = float(np.abs(g_o - g_r)[agree].max())
    scale = float(np.abs(g_r).max()) + 1e-12
    if not err <= 5e-5 * scale:
        raise AssertionError(f"{what}: max |g| error {err} > 5e-5 * {scale}")
    if agree.all() and len(ref) > 3:
        ya_r, ya_o = ref[3].cpu().numpy(), out[3].cpu().numpy()
        yerr = float(np.abs(ya_o - ya_r).max())
        if not yerr <= 1e-4 * float(np.abs(ya_r).max()) + 1e-6:
            raise AssertionError(f"{what}: max |yadj| error {yerr}")
    return err


def cuda_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def check_kernels(torch, TG, TB, dev, n, m, B):
    errs = {"sweep_mc": 0.0, "block_draws": 0.0}
    gen = torch.Generator(device=dev).manual_seed(7)
    M = make_genotype(torch, n, m, gen, dev)
    y = (M[:, :64].float() @ (0.1 * torch.randn(64, generator=gen, device=dev))
         + torch.randn(n, generator=gen, device=dev)).cpu().numpy()
    for x_int8 in (True, False):
        for model in MODELS:
            fold = np.array([0.0, 1e-4, 1e-3, 1e-2]) if model == "BayesR" else None
            data = TG.prepare_gibbs_data(
                y, M if x_int8 else M.float(), block=B, fold=fold,
                geno_dtype="int8" if x_int8 else None, device=dev)
            spec, pr, pi = make_spec(TG, model, data, m, n)
            for K in (1, 4):
                args = sweep_args(torch, TG, spec, data, pr, pi, K, seed=K)
                out = TB.sweep_mc(spec, *args)
                ref = TB.sweep_mc_plain(spec, *args)
                again = TB.sweep_mc(spec, *args)
                torch.cuda.synchronize()
                what = f"sweep_mc {model} {'int8' if x_int8 else 'f32'} K={K}"
                errs["sweep_mc"] = max(errs["sweep_mc"], bar(ref, out, what))
                if not all(torch.equal(a, b) for a, b in zip(out, again)):
                    raise AssertionError(f"{what}: two runs differ (not deterministic)")
                log(f"  ok {what}")
                if x_int8:
                    b = 3
                    consts, X, W, xpx, vx, vei, g, *_ = args
                    P = TB.pack_rows(spec, consts, xpx, vx, vei, g, args[7],
                                     args[8], args[9], args[11], torch.float32)
                    P_b = TB.to_block_layout(P, spec.nblocks, B)[b].contiguous()
                    r0 = (args[12] @ X[b].float()).T.contiguous()
                    logpi = consts["logpi"][:, :1].T.contiguous()
                    dg_k, tr_k = TB.block_draws(spec, logpi, P_b, W[b], r0)
                    dg_p, tr_p = TB.block_draws_plain(spec, logpi, P_b, W[b], r0)
                    g_old = P_b[:, 1, :]
                    e = bar((g_old - dg_p, tr_p), (g_old - dg_k, tr_k),
                            f"block_draws {model} K={K}")
                    errs["block_draws"] = max(errs["block_draws"], e)
                    log(f"  ok block_draws {model} K={K}")
            if x_int8 and model == "BayesR":
                off, nbg = 2, 3
                args = sweep_args(torch, TG, spec, data, pr, pi, 4, seed=9)
                consts, X, W, xpx, vx, *per = args
                cols = slice(off * B, (off + nbg) * B)
                loc = [a[:, cols] for a in per[:7]]
                out = TB.sweep_mc(spec, consts, X, W, xpx[cols], vx[cols], *loc,
                                  per[7], per[8], block_range=(off, nbg))
                ref = TB.sweep_mc_plain(
                    spec, consts, X[off:off + nbg].contiguous(),
                    W[off:off + nbg].contiguous(), xpx[cols], vx[cols], *loc,
                    per[7], per[8])
                errs["sweep_mc"] = max(errs["sweep_mc"],
                                       bar(ref, out, "sweep_mc offset (2, 3) BayesR K=4"))
                log("  ok sweep_mc block_range=(2, 3) BayesR int8 K=4")
    return errs


def time_kernels(torch, TG, TB, dev, M, y, B, errs, nbg=16):
    """Kernel vs plain at the main path's shapes (n=50,000 rows, B=128,
    K=1, BayesR, int8): the fused sweep over nbg blocks and one block's
    draws, each held to the bar (into ``errs``) and timed beside its plain
    version.  Also the kernel's full sweep."""
    n, m = M.shape
    data = TG.prepare_gibbs_data(y, M, block=B, fold=np.array([0.0, 1e-4, 1e-3, 1e-2]),
                                 geno_dtype="int8", device=dev)
    spec, pr, pi = make_spec(TG, "BayesR", data, m, n)
    args = sweep_args(torch, TG, spec, data, pr, pi, 1, seed=3)
    consts, X, W, xpx, vx, *per = args
    cols = slice(0, nbg * B)
    loc = [a[:, cols] for a in per[:7]]
    part = (spec, consts, X, W, xpx[cols], vx[cols], *loc, per[7], per[8])
    errs["sweep_mc"] = max(errs["sweep_mc"], bar(
        TB.sweep_mc_plain(*part, block_range=(0, nbg)),
        TB.sweep_mc(*part, block_range=(0, nbg)), "sweep_mc at the main path's shapes"))
    t = {}
    t["sweep_mc"] = cuda_ms(torch, lambda: TB.sweep_mc(*part, block_range=(0, nbg)), 10)
    t["sweep_mc_plain"] = cuda_ms(
        torch, lambda: TB.sweep_mc_plain(*part, block_range=(0, nbg)), 2)
    t["sweep_full"] = cuda_ms(torch, lambda: TB.sweep_mc(spec, *args), 3)
    P = TB.pack_rows(spec, consts, xpx, vx, per[0], per[1], per[2], per[3],
                     per[4], per[6], torch.float32)
    P_b = TB.to_block_layout(P, spec.nblocks, B)[0].contiguous()
    r0 = (per[7] @ X[0].float()).T.contiguous()
    logpi = consts["logpi"][:, :1].T.contiguous()
    g_old = P_b[:, 1, :]
    dg_k, tr_k = TB.block_draws(spec, logpi, P_b, W[0], r0)
    dg_p, tr_p = TB.block_draws_plain(spec, logpi, P_b, W[0], r0)
    errs["block_draws"] = max(errs["block_draws"], bar(
        (g_old - dg_p, tr_p), (g_old - dg_k, tr_k), "block_draws at the main path's shapes"))
    t["block_draws"] = cuda_ms(torch, lambda: TB.block_draws(spec, logpi, P_b, W[0], r0), 50)
    t["block_draws_plain"] = cuda_ms(
        torch, lambda: TB.block_draws_plain(spec, logpi, P_b, W[0], r0), 3)
    return t, spec.n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--m", type=int, default=65_536)
    ap.add_argument("--niter", type=int, default=200)
    ap.add_argument("--nburn", type=int, default=100)
    ap.add_argument("--seed", type=int, default=2024)
    args = ap.parse_args(argv)

    import torch

    # ---- 1. device ----
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import hibayes_tpu_torch
    from hibayes_tpu_torch.engine import gibbs as TG
    from hibayes_tpu_torch.ops import blockgibbs as TB
    from hibayes_tpu_torch.ops import build

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(f"[1] device {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"[1] nvidia-smi: {smi}")
    g = torch.Generator(device=dev).manual_seed(1)
    gam = torch._standard_gamma(torch.full((4,), 2.5, device=dev), generator=g)
    dir_ = torch._sample_dirichlet(torch.full((4,), 2.5, device=dev), generator=g)
    log(f"[1] CUDA generator accepted: _standard_gamma {gam.tolist()}, "
        f"_sample_dirichlet sum {float(dir_.sum()):.6f}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    build.build(verbose=True)
    build.library()
    log(f"[2] kernels built in {time.perf_counter() - t0:.2f} s: {build.library_path().name}")

    # ---- 3. kernels vs plain ----
    t0 = time.perf_counter()
    errs = check_kernels(torch, TG, TB, dev, n=4096, m=1024, B=128)
    log(f"[3] kernel checks passed in {time.perf_counter() - t0:.1f} s: {errs}")

    B = 128
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    M, data, _ = simulate(torch, 4096, 1024, gen, dev)
    gebv = [hibayes_tpu_torch.ibrm(
        "y ~ x1 + (1|grp)", data=data, M=M, M_id=data["id"], method="BayesR",
        niter=30, nburn=10, thin=5, block=B, seed=args.seed, device=dev,
        verbose=False).g["gebv"] for _ in range(2)]
    if not np.array_equal(gebv[0], gebv[1]):
        raise AssertionError("two fits with one seed differ: the chain is not reproducible")
    log("[3] two fits with one seed (n=4096, m=1024) are bit-identical")

    t0 = time.perf_counter()
    M, data, gv = simulate(torch, args.n, args.m, gen, dev)
    torch.cuda.synchronize()
    log(f"[4] genotype {tuple(M.shape)} int8 made on the card in "
        f"{time.perf_counter() - t0:.1f} s")

    times, n_rows = time_kernels(torch, TG, TB, dev, M, data["y"], B, errs)
    log(f"[3] kernels match their plain versions at n={args.n} too: {errs}")
    log(f"[3] times (ms) at n={args.n} (padded {n_rows}), B={B}, K=1, BayesR "
        f"int8 on {smi}: {json.dumps(times)}")

    # ---- 4. main path ----
    TB.sweep_mc.launches = TB.block_draws.launches = 0
    TB.sweep_mc_plain.calls = TB.block_draws_plain.calls = 0
    TB.reset_kernel_launches()
    t0 = time.perf_counter()
    fit = hibayes_tpu_torch.ibrm(
        "y ~ x1 + (1|grp)", data=data, M=M, M_id=data["id"], method="BayesR",
        niter=args.niter, nburn=args.nburn, thin=5, block=B, seed=args.seed,
        device=dev, printfreq=50)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"sweep_mc": TB.sweep_mc.launches, **TB.kernel_launches()}
    niter_eff = args.nburn + ((args.niter - args.nburn) // 5) * 5
    nblocks = -(-args.m // B)
    log(f"[4] launches in the main path: {launches}; block_draws wrapper "
        f"{TB.block_draws.launches}; plain calls "
        f"{TB.sweep_mc_plain.calls + TB.block_draws_plain.calls}")
    expect = {"sweep_mc": niter_eff, "rows_kernel": niter_eff * (nblocks + 1),
              "draws_kernel": niter_eff * nblocks}
    if launches != expect:
        raise AssertionError(f"the sweep did not run through the kernels: "
                             f"{launches}, expected {expect}")
    if TB.sweep_mc_plain.calls or TB.block_draws_plain.calls:
        raise AssertionError("the main path reached a plain version")
    for k in ("Vg", "Ve", "h2"):
        if not np.isfinite(getattr(fit, k)):
            raise AssertionError(f"{k} is not finite")
    if not 0.0 < fit.h2 < 1.0:
        raise AssertionError(f"h2 {fit.h2} outside (0, 1)")
    gebv = fit.g["gebv"]
    if gebv.shape != (args.n,) or not np.isfinite(gebv).all():
        raise AssertionError("GEBV of the wrong shape or not finite")
    corr = float(np.corrcoef(gebv, gv.cpu().numpy())[0, 1])
    chain_s = fit.chain_seconds
    ms_iter = 1e3 * chain_s / niter_eff
    log(f"[4] ibrm BayesR n={args.n} m={args.m}: Vg {fit.Vg:.4f} Ve {fit.Ve:.4f} "
        f"h2 {fit.h2:.4f} (truth 0.5 of the genetic + residual part), "
        f"GEBV corr {corr:.4f} (bar {GEBV_CORR_MIN})")
    log(f"[4] wall {wall:.2f} s; chain {chain_s:.2f} s = {ms_iter:.2f} ms/iter, "
        f"{niter_eff * args.m / chain_s:.4g} SNP-updates/s on {smi}")
    if not corr >= GEBV_CORR_MIN:
        raise AssertionError(f"GEBV accuracy {corr} below {GEBV_CORR_MIN}")

    # ---- 5. results ----
    src = "hibayes_tpu_torch/csrc/blockgibbs.cu"
    kernels = [
        {"name": "sweep_mc", "route": "cuda", "source": src,
         "replaces": "hibayes_tpu/ops/blockgibbs.py:642",
         "launches": launches["sweep_mc"], "rows_kernel_launches": launches["rows_kernel"],
         "max_abs_err": errs["sweep_mc"],
         "ms": times["sweep_mc"], "plain_ms": times["sweep_mc_plain"]},
        {"name": "draws_kernel", "route": "cuda", "source": src,
         "replaces": "hibayes_tpu/ops/blockgibbs.py:1264",
         "launches": launches["draws_kernel"], "max_abs_err": errs["block_draws"],
         "ms": times["block_draws"], "plain_ms": times["block_draws_plain"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
