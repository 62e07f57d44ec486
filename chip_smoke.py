#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (hibayes_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, each printing as it goes:
  1. the device, and nvidia-smi's name and power limit; no CUDA device -> exit 2;
  2. build the CUDA kernels from csrc/ (one nvcc per source, all started
     together), print the build time;
  3. every kernel against its plain PyTorch version on the card.  ibrm: the
     fused sweep for all six models x {int8, f32} x K in {1, 4} at n=4,096,
     m=1,024, B=128, one offset sweep (block_range), and the draw kernel.
     sbrm: the dense segment sweep (m=1,000 AR(1) LD, B=64) and the tiled
     sweep (8 tile rows of 128 in a 5-tile band, so with masked slots; the
     guard on for BayesCpi and BayesR) for all six models, and one tiled
     case with a lowered vary where the guard rejects draws (counted).  Bar:
     at most 1% mixture draws flip, effects within 5e-5 max|g| where the
     draws agree, residuals (r_hat) within 1e-4 max|.| when none flips; a
     second kernel sweep on the same inputs must be bit-identical.  Then two
     small ibrm fits with one seed must agree bit for bit; then each kernel
     is held to the bar and timed beside its plain version at its main
     path's shapes;
  4. ibrm main path: hibayes_tpu_torch.ibrm("y ~ x1 + (1|grp)",
     method="BayesR") on one chain at n=50,000 x m=65,536 (int8 genotype made
     on the card, h2=0.5 from 500 causal SNPs), niter=200, nburn=100,
     thin=5; checks that the sweep ran through the kernels only (each CUDA
     kernel's launch count, kept by the library where it launches, is what
     the chain needs, and no plain version ran), finite 0 < h2 < 1, and the
     GEBV accuracy against the simulated truth;
  5. sbrm main path (the configuration of benchmarks/sbrm_tiled_500k.py):
     hibayes_tpu_torch.sbrm(method="BayesCpi") on one chain over a tiled
     LD of m=500,000 SNPs, tile 128, a 9-tile band of 0.9^|i-j| (2.30 GB of
     f32 tiles built on the card), BETA = LD b_true with b_true 1% nonzero
     N(0, 0.05^2), SE = 1/sqrt(50,000), N = 50,000; sparse semantics, so the
     guard is on; niter=200, nburn=100, thin=5.  Checks that the sweep ran
     through sweep_s_tiled only, with the launch counts the chain needs and
     no plain call, finite Vg, Ve and 0 < h2 < 1, and the accuracy of the
     posterior-mean effects against b_true; before the chain, torch.profiler
     over 3 iterations prints device time by kernel (so does phase 6);
  6. sbrm dense path: the same kind of statistics over a dense AR(1) LD
     (0.9^|i-j|, m=32,768, 4.29 GB f32, block 64), BayesCpi through
     sweep_s_segment only, then method="CG" on the same LD against a direct
     solve on the card;
  7. a JSON line of kernels, the nvidia-smi line, and the last line
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

# Accuracy bar of the sbrm paths (corr of posterior-mean effects with
# b_true).  The statistics carry no sampling noise (BETA = LD b_true), and
# each causal effect (sd 0.05) is about ten standard errors (1/sqrt(50,000))
# from zero; at m=2,048 and 65,536 the tiled recipe reached 0.996 and 0.971
# on the CPU.  At m=500,000 the 5,000 causal effects explain more variance
# than the statistics' own phenotypic variance (Vg ~ 8.8 against vary ~ 1),
# so Ve sits at the negative-Ve guard's 0.5 Vg, the effects shrink, and the
# chain keeps about a third of them: 0.787 on an H100 (PERF.md).  The chain
# is deterministic for a seed; 0.7 leaves room for another card's rounding,
# and a sweep that draws against the wrong LD rows falls far below it.
SBAYES_CORR_MIN = 0.7
# A CG solution against the direct solve: CG stops when the residual norm
# is below 1e-6, so its error is at most 1e-6 / lambda_min(LD), 1.9e-5 for
# AR(1) with rho=0.9 (lambda_min = (1 - rho) / (1 + rho)).
CG_ERR_MAX = 2e-5
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (hopper-kernels guide)
F32_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores

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


def bar(ref, out, what, r_index=3):
    """The kernel-vs-plain bar on (g, track, ..., residual at ``r_index``);
    returns max |g| error where the draws agree."""
    g_r, g_o = ref[0].cpu().numpy(), out[0].cpu().numpy()
    t_r, t_o = ref[1].cpu().numpy(), out[1].cpu().numpy()
    agree = t_r == t_o
    if agree.mean() < 0.99:
        raise AssertionError(f"{what}: {100 * (1 - agree.mean()):.2f}% draws flip")
    err = float(np.abs(g_o - g_r)[agree].max())
    scale = float(np.abs(g_r).max()) + 1e-12
    if not err <= 5e-5 * scale:
        raise AssertionError(f"{what}: max |g| error {err} > 5e-5 * {scale}")
    if agree.all() and len(ref) > r_index:
        ya_r, ya_o = ref[r_index].cpu().numpy(), out[r_index].cpu().numpy()
        yerr = float(np.abs(ya_o - ya_r).max())
        if not yerr <= 1e-4 * float(np.abs(ya_r).max()) + 1e-6:
            raise AssertionError(f"{what}: max residual error {yerr}")
    return err


def bound(nbytes, flops):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of the bytes over the memory rate and the float32 operations over the
    float32 rate."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return 1e3 * max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def host_ms(torch, fn):
    """Host time to enqueue one call (no synchronize inside): when it comes
    near the device time of the call, the host bounds the loop."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    t = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    return t


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
    # bounds of the timed calls: each input read once, each output written once
    nb = lambda *ts: sum(x.numel() * x.element_size() for x in ts)
    n_rows, m_loc = X.shape[1], nbg * B
    sweep_bytes = (nb(X[:nbg], W[:nbg], xpx[cols], vx[cols], *loc, per[7], per[8])
                   + 4 * m_loc * 3 + nb(per[7], per[8]))   # g, track, vargL; yadj, u out
    bounds = {"sweep_mc": bound(sweep_bytes, nbg * (4.0 * n_rows * B + 2.0 * B * B)),
              "block_draws": bound(nb(W[0], P_b, r0, logpi) + 2 * r0.numel() * 4,
                                   2.0 * B * B * r0.shape[1])}
    return t, spec.n, bounds


# ---------------------------------------------------------------------------
# summary level (sbrm)
# ---------------------------------------------------------------------------


def banded_ld(torch, TSLD, m, dev, T=128, K=9, rho=0.9):
    """Tiled LD of a band of rho^|i-j|: block row i stores its tiles j with
    |i - j| <= K // 2, the diagonal first, the other slots masked (the layout
    of benchmarks/sbrm_tiled_500k.py).  The tiles are built on the card by
    gathering from the 2 K // 2 + 1 distinct tiles of the band."""
    nbr, half = -(-m // T), K // 2
    a = torch.arange(T, device=dev, dtype=torch.float64)
    motifs = [rho ** (a[:, None] - a[None, :] - d * T).abs() for d in range(half + 1)]
    lib = torch.stack([torch.zeros((T, T), dtype=torch.float64, device=dev)] + motifs
                      + [x.T for x in motifs[1:]]).float()
    i = torch.arange(nbr, device=dev)[:, None]
    offs = torch.tensor([0] + [s * o for o in range(1, half + 1) for s in (-1, 1)],
                        device=dev)
    j = i + offs[None, :]
    ok = (j >= 0) & (j < nbr)
    order = torch.sort((~ok).to(torch.int8), dim=1, stable=True).indices  # valid first
    j, ok = torch.gather(j, 1, order), torch.gather(ok, 1, order)
    d = j - i
    code = torch.where(ok, torch.where(d >= 0, 1 + d, 1 + half - d), 0)
    return TSLD.TiledSparseLD(
        tile=T, m=m, col_idx=torch.where(ok, j, i).to(torch.int32).cpu().numpy(),
        valid=ok.cpu().numpy(), tiles=lib[code], nnz_col=np.full(m, K * T, np.int64))


def ar1_ld(torch, m, dev, rho=0.9, chunk=2048):
    """Dense (m, m) float32 LD rho^|i-j|, made on the card row chunk by row
    chunk."""
    LD = torch.empty((m, m), dtype=torch.float32, device=dev)
    j = torch.arange(m, device=dev, dtype=torch.float64)
    for r0 in range(0, m, chunk):
        LD[r0:r0 + chunk] = torch.exp(
            np.log(rho) * (j[r0:r0 + chunk, None] - j[None, :]).abs()).float()
    return LD


def summary_stats(torch, ld_matvec, m, m_pad, gen, dev, N=50_000):
    """[MAF, BETA, SE, N] with BETA = LD b_true, b_true 1% nonzero N(0, 0.05^2),
    SE = 1/sqrt(N); returns (ss (m, 4) numpy, b_true (m,) numpy)."""
    b = torch.where(torch.rand(m_pad, generator=gen, device=dev) < 0.01,
                    0.05 * torch.randn(m_pad, generator=gen, device=dev), 0.0)
    b[m:] = 0.0
    beta = ld_matvec(b)[:m].double().cpu().numpy()
    ss = np.column_stack([np.full(m, 0.3), beta, np.full(m, 1 / np.sqrt(N)),
                          np.full(m, float(N))])
    return ss, b[:m].cpu().numpy()


def tiled_matvec(torch, ld):
    from hibayes_tpu_torch.data.sparse_ld import _tiled_matvec

    cols = torch.as_tensor(ld.col_idx, device=ld.tiles.device)
    valid = torch.as_tensor(ld.valid, device=ld.tiles.device)
    return lambda v: _tiled_matvec(ld.tiles, cols, valid, v)


def s_setup(torch, TG, TSG, ss, ld, model, block, dev, sparse):
    """Data, spec, priors and pi of one summary chain, as sbrm builds them."""
    fold = np.array([0.0, 1e-4, 1e-3, 1e-2]) if model == "BayesR" else np.array([0.0, 1.0])
    pi = (np.array([0.95, 0.02, 0.02, 0.01]) if model == "BayesR"
          else np.array([0.0, 1.0]) if model in ("BayesRR", "BayesA", "BayesL")
          else np.array([0.95, 0.05]))
    data, n_eff, vary, nvar0, seg_sizes, seg_real = TSG.prepare_sgibbs_data(
        ss, ld, fold=fold, block=block, dtype=torch.float32, device=dev)
    pr = TG.resolve_priors(None, float(ld.diag.sum()), pi[0], nr=0, vary=vary)
    spec = TG.GibbsSpec(
        model=model, n=n_eff, m=ss.shape[0], m_pad=int(sum(seg_sizes)), block=block,
        nc=0, nlevels=(), n_fold=len(pi), niter=10, nburn=5, thin=5, nvar0=nvar0,
        dfvara=pr.dfvara, s2vara=pr.s2vara, dfvare=pr.dfvare, s2vare=pr.s2vare,
        s2varg=pr.s2varg, lambda_rate0=pr.lambda_rate0, vargl_strict_pos=True,
        real_excl_nvar0=True, reject_guard=sparse, vary=vary, seg_sizes=seg_sizes,
        seg_real=seg_real)
    return data, spec, pr, pi


def s_sweep_inputs(torch, TSG, spec, data, pr, pi, matvec, seed):
    """A mid-run state (sparse effects g, r_hat = xy - n LD g) and the packed
    rows of one iteration from the engine's own pre-sweep; returns (g, r_hat, P)."""
    from hibayes_tpu_torch.engine.rng import IterNoise

    dev = data.xy.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.where((torch.rand(spec.m_pad, generator=gen, device=dev) < 0.2) & data.real,
                    0.02 * torch.randn(spec.m_pad, generator=gen, device=dev), 0.0)
    st = TSG.init_s_state(spec, data, pr, pi)
    st = st._replace(g=g, r_hat=data.xy - spec.n * matvec(g), it=3)
    pre = TSG._s_pre_sweep(spec, data, IterNoise(seed, 3, dev), st)
    return g, st.r_hat, pre["P"]


def check_s_kernels(torch, TG, TSG, TSLD, TB, dev, errs):
    """Both summary sweeps against their plain versions, all six models, at
    small sizes; a second launch must be bit-identical.  Returns the number
    of draws the guard rejected in its lowered-vary case."""
    from hibayes_tpu_torch.data.ld import DenseLD

    gen = torch.Generator(device=dev).manual_seed(11)
    m = 1000
    LD = ar1_ld(torch, m, dev)
    tld = banded_ld(torch, TSLD, m, dev, K=5)
    if tld.valid.all():
        raise AssertionError("the tiled check needs masked slots")
    ss_d, _ = summary_stats(torch, lambda v: LD @ v, m, m, gen, dev)
    ss_t, _ = summary_stats(torch, tiled_matvec(torch, tld), m, tld.m_pad, gen, dev)
    nrej_low = 0
    for model in MODELS:
        data, spec, pr, pi = s_setup(torch, TG, TSG, ss_d, DenseLD(values=LD), model,
                                     64, dev, False)
        seg = data.ld_segs[0]
        g, r, P = s_sweep_inputs(torch, TSG, spec, data, pr, pi,
                                 lambda v: seg @ v, seed=5)
        outs = [TB.sweep_s_segment(spec, seg, r, P, spec.n) for _ in range(2)]
        ref = TB.sweep_s_segment_plain(spec, seg, r, P, spec.n)
        torch.cuda.synchronize()
        what = f"sweep_s_segment {model}"
        errs["sweep_s_segment"] = max(errs["sweep_s_segment"], bar(
            (g - ref[0], ref[1], ref[2]), (g - outs[0][0], outs[0][1], outs[0][2]),
            what, r_index=2))
        if not all(torch.equal(a, b) for a, b in zip(*outs)):
            raise AssertionError(f"{what}: two runs differ (not deterministic)")
        log(f"  ok {what} (m={m}, B=64)")
        for vary in ((None, 2e-4) if model == "BayesCpi" else (None,)):
            data, spec, pr, pi = s_setup(torch, TG, TSG, ss_t, tld, model, 128, dev, True)
            if vary is not None:
                spec = spec.__class__(**{**spec.__dict__, "vary": vary})
            args = (data.ld_tiles, data.ld_cols, data.ld_valid)
            g, r, P = s_sweep_inputs(torch, TSG, spec, data, pr, pi,
                                     lambda v: tiled_matvec(torch, tld)(v), seed=6)
            outs = [TB.sweep_s_tiled(spec, *args, r, P, spec.n) for _ in range(2)]
            ref = TB.sweep_s_tiled_plain(spec, *args, r, P, spec.n)
            torch.cuda.synchronize()
            what = f"sweep_s_tiled {model}" + ("" if vary is None else f" vary={vary}")
            errs["sweep_s_tiled"] = max(errs["sweep_s_tiled"], bar(
                (g - ref[0], ref[1], ref[2]), (g - outs[0][0], outs[0][1], outs[0][2]),
                what, r_index=2))
            if not all(torch.equal(a, b) for a, b in zip(*outs)):
                raise AssertionError(f"{what}: two runs differ (not deterministic)")
            rej_k, rej_p = int(outs[0][3]), int(ref[3])
            if rej_k != rej_p:
                raise AssertionError(f"{what}: guard rejected {rej_k} draws, plain {rej_p}")
            if vary is not None:
                if rej_k == 0:
                    raise AssertionError(f"{what}: the guard did not fire")
                nrej_low = rej_k
            log(f"  ok {what} (m={m}, 8 tile rows, guard "
                f"{'on' if TB.guard_on(spec) else 'off'}, {rej_k} first draws rejected)")
    return nrej_low


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def time_tiled(torch, TSG, TB, spec, data, pr, pi, ld, errs, rows=16):
    """The tiled sweep at the main path's shapes: the first ``rows`` tile rows
    (slots past them masked), kernel against plain, held to the bar and
    timed; and the kernel over every tile row.  Returns (times, bounds)."""
    T = spec.block
    g, r, P = s_sweep_inputs(torch, TSG, spec, data, pr, pi, tiled_matvec(torch, ld), 9)
    mp = rows * T
    sub = spec.__class__(**{**spec.__dict__, "m": mp, "m_pad": mp, "seg_sizes": (mp,),
                            "seg_real": (mp,)})
    cols = data.ld_cols[:rows].contiguous()
    args = (data.ld_tiles[:rows], cols, data.ld_valid[:rows] & (cols < rows),
            r[:mp].contiguous(), P[:, :mp].contiguous(), spec.n)
    out, ref = TB.sweep_s_tiled(sub, *args), TB.sweep_s_tiled_plain(sub, *args)
    errs["sweep_s_tiled"] = max(errs["sweep_s_tiled"], bar(
        (g[:mp] - ref[0], ref[1], ref[2]), (g[:mp] - out[0], out[1], out[2]),
        f"sweep_s_tiled at the main path's shapes ({rows} rows)", r_index=2))
    full = (data.ld_tiles, data.ld_cols, data.ld_valid, r, P, spec.n)
    t = {"sweep_s_tiled": cuda_ms(torch, lambda: TB.sweep_s_tiled(sub, *args), 10),
         "sweep_s_tiled_plain": cuda_ms(torch, lambda: TB.sweep_s_tiled_plain(sub, *args), 1),
         "sweep_s_tiled_full": cuda_ms(torch, lambda: TB.sweep_s_tiled(spec, *full), 3),
         "sweep_s_tiled_full_host": host_ms(torch, lambda: TB.sweep_s_tiled(spec, *full))}
    nvalid = int(args[2].sum())
    b = (nvalid * T * T * 4 + nbytes(*args[1:5]) + 4 * mp * 3 + 4 * rows)
    flops = 2.0 * T * T * (nvalid + rows)
    nvalid_all = int(data.ld_valid.sum())
    b_full = (nvalid_all * T * T * 4 + nbytes(*full[1:5]) + 4 * spec.m_pad * 3
              + 4 * data.ld_cols.shape[0])
    return t, {"sweep_s_tiled": bound(b, flops),
               "sweep_s_tiled_full": bound(b_full, 2.0 * T * T * (nvalid_all + data.ld_cols.shape[0]))}


def time_segment(torch, TSG, TB, spec, data, pr, pi, errs):
    """The segment sweep over the dense path's whole segment, kernel against
    plain, held to the bar and timed.  Returns (times, bounds)."""
    seg = data.ld_segs[0]
    g, r, P = s_sweep_inputs(torch, TSG, spec, data, pr, pi, lambda v: seg @ v, 9)
    out, ref = (TB.sweep_s_segment(spec, seg, r, P, spec.n),
                TB.sweep_s_segment_plain(spec, seg, r, P, spec.n))
    errs["sweep_s_segment"] = max(errs["sweep_s_segment"], bar(
        (g - ref[0], ref[1], ref[2]), (g - out[0], out[1], out[2]),
        "sweep_s_segment at the dense path's shapes", r_index=2))
    t = {"sweep_s_segment": cuda_ms(torch, lambda: TB.sweep_s_segment(spec, seg, r, P, spec.n), 3),
         "sweep_s_segment_host": host_ms(
             torch, lambda: TB.sweep_s_segment(spec, seg, r, P, spec.n)),
         "sweep_s_segment_plain": cuda_ms(
             torch, lambda: TB.sweep_s_segment_plain(spec, seg, r, P, spec.n), 1)}
    mc, B = seg.shape[0], spec.block
    b = nbytes(seg, r, P) + 4 * mc * 3
    return t, {"sweep_s_segment": bound(b, 2.0 * mc * mc + 2.0 * B * mc)}


def profile_iterations(torch, step, state, what, iters=3):
    """torch.profiler over ``iters`` iterations (``state = step(state)``)
    after one unprofiled warm-up: device time by kernel, and the device's
    busy share of the profiled wall time.  Returns the final state."""
    from torch.profiler import ProfilerActivity, profile

    state = step(state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            state = step(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0:
            kern[e.key] = (e.self_device_time_total / iters, e.count // iters)
    busy = sum(t for t, _ in kern.values())
    log(f"[profile {what}] {iters} iterations: wall {1e3 * wall / iters:.2f} ms/iter, "
        f"device kernels {busy / 1e3:.2f} ms/iter, busy {busy / 1e3 / (1e3 * wall / iters):.3f}")
    for name, (t, n) in sorted(kern.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"[profile {what}]   {t / 1e3:8.3f} ms/iter  {n:6d} calls  "
            f"{t / max(n, 1):8.2f} us/call  {name[:90]}")
    return state


def reset_counts(TB):
    for f in (TB.sweep_mc, TB.block_draws, TB.sweep_s_segment, TB.sweep_s_tiled):
        f.launches = 0
    for f in (TB.sweep_mc_plain, TB.block_draws_plain, TB.sweep_s_segment_plain,
              TB.sweep_s_tiled_plain):
        f.calls = 0
    TB.reset_kernel_launches()


def read_counts(TB):
    return ({"sweep_mc": TB.sweep_mc.launches, "block_draws": TB.block_draws.launches,
             "sweep_s_segment": TB.sweep_s_segment.launches,
             "sweep_s_tiled": TB.sweep_s_tiled.launches, **TB.kernel_launches()},
            TB.sweep_mc_plain.calls + TB.block_draws_plain.calls
            + TB.sweep_s_segment_plain.calls + TB.sweep_s_tiled_plain.calls)


def expect_counts(got, plain, expect, what):
    want = {k: 0 for k in got}
    want.update(expect)
    log(f"[{what}] launches: {got}; plain calls {plain}")
    if got != want or plain:
        raise AssertionError(f"{what}: the path did not run through its kernels only: "
                             f"{got}, plain calls {plain}; expected {want}, 0 plain calls")


def check_fit(fit, b_true, what):
    for k in ("Vg", "Ve", "h2"):
        if not np.isfinite(getattr(fit, k)):
            raise AssertionError(f"{what}: {k} is not finite")
    if not 0.0 < fit.h2 < 1.0:
        raise AssertionError(f"{what}: h2 {fit.h2} outside (0, 1)")
    if fit.alpha.shape != b_true.shape or not np.isfinite(fit.alpha).all():
        raise AssertionError(f"{what}: effects of the wrong shape or not finite")
    return float(np.corrcoef(fit.alpha, b_true)[0, 1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--m", type=int, default=65_536)
    ap.add_argument("--niter", type=int, default=200)
    ap.add_argument("--nburn", type=int, default=100)
    ap.add_argument("--seed", type=int, default=2024)
    ap.add_argument("--sm", type=int, default=500_000, help="SNPs of the tiled sbrm path")
    ap.add_argument("--dm", type=int, default=32_768, help="SNPs of the dense sbrm path")
    args = ap.parse_args(argv)

    import torch

    # ---- 1. device ----
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import hibayes_tpu_torch
    from hibayes_tpu_torch.data import sparse_ld as TSLD
    from hibayes_tpu_torch.engine import gibbs as TG
    from hibayes_tpu_torch.engine import sgibbs as TSG
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
    libs = build.build(verbose=True)
    for src in build.SOURCES:
        build.library(src)
    log(f"[2] kernels built in {time.perf_counter() - t0:.2f} s: "
        f"{[p.name for p in libs]}")

    # ---- 3. kernels vs plain ----
    t0 = time.perf_counter()
    errs = check_kernels(torch, TG, TB, dev, n=4096, m=1024, B=128)
    errs.update(sweep_s_segment=0.0, sweep_s_tiled=0.0)
    nrej = check_s_kernels(torch, TG, TSG, TSLD, TB, dev, errs)
    log(f"[3] kernel checks passed in {time.perf_counter() - t0:.1f} s: {errs}; "
        f"the guard rejected {nrej} first draws at the lowered vary")

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

    times, n_rows, bounds = time_kernels(torch, TG, TB, dev, M, data["y"], B, errs)
    log(f"[3] kernels match their plain versions at n={args.n} too: {errs}")
    log(f"[3] times (ms) at n={args.n} (padded {n_rows}), B={B}, K=1, BayesR "
        f"int8 on {smi}: {json.dumps(times)}")

    # ---- 4. ibrm main path ----
    thin = 5
    niter_eff = args.nburn + ((args.niter - args.nburn) // thin) * thin
    reset_counts(TB)
    t0 = time.perf_counter()
    fit = hibayes_tpu_torch.ibrm(
        "y ~ x1 + (1|grp)", data=data, M=M, M_id=data["id"], method="BayesR",
        niter=args.niter, nburn=args.nburn, thin=thin, block=B, seed=args.seed,
        device=dev, printfreq=50)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = read_counts(TB)
    nblocks = -(-args.m // B)
    expect_counts(launches, plain, {"sweep_mc": niter_eff,
                                    "rows_kernel": niter_eff * (nblocks + 1),
                                    "draws_kernel": niter_eff * nblocks}, "4")
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
    log(f"[4] ibrm BayesR n={args.n} m={args.m}: Vg {fit.Vg:.4f} Ve {fit.Ve:.4f} "
        f"h2 {fit.h2:.4f} (truth 0.5 of the genetic + residual part), "
        f"GEBV corr {corr:.4f} (bar {GEBV_CORR_MIN})")
    log(f"[4] wall {wall:.2f} s; chain {chain_s:.2f} s = {1e3 * chain_s / niter_eff:.2f} "
        f"ms/iter, {niter_eff * args.m / chain_s:.4g} SNP-updates/s on {smi}")
    if not corr >= GEBV_CORR_MIN:
        raise AssertionError(f"GEBV accuracy {corr} below {GEBV_CORR_MIN}")
    del M, data, gv, fit
    torch.cuda.empty_cache()

    # ---- 5. sbrm main path: tiled LD ----
    t0 = time.perf_counter()
    tld = banded_ld(torch, TSLD, args.sm, dev)
    ss, b_true = summary_stats(torch, tiled_matvec(torch, tld), args.sm, tld.m_pad, gen, dev)
    torch.cuda.synchronize()
    log(f"[5] tiled LD m={args.sm}: {tld.nbr} tile rows x {tld.k_max} slots, "
        f"{tld.n_tiles} tiles, {tld.tiles.numel() * 4 / 1e9:.3f} GB f32, and the "
        f"statistics made on the card in {time.perf_counter() - t0:.1f} s")
    sdata, sspec, spr, spi = s_setup(torch, TG, TSG, ss, tld, "BayesCpi", 128, dev, True)
    t_tiled, b_tiled = time_tiled(torch, TSG, TB, sspec, sdata, spr, spi, tld, errs)
    times.update(t_tiled)
    bounds.update(b_tiled)
    log(f"[5] sweep_s_tiled matches its plain version at the main path's shapes; "
        f"times (ms) on {smi}: {json.dumps(t_tiled)}; bounds {json.dumps(b_tiled)}")
    profile_iterations(torch, lambda st: TSG.one_s_iteration(sspec, sdata, 1, st),
                       TSG.init_s_state(sspec, sdata, spr, spi), "sbrm tiled")
    del sdata
    reset_counts(TB)
    fit = hibayes_tpu_torch.sbrm(ss, tld, method="BayesCpi", fold=np.array([0.0, 1.0]),
                                 niter=args.niter, nburn=args.nburn, thin=thin,
                                 seed=args.seed, device=dev, printfreq=50)
    torch.cuda.synchronize()
    s_launches, plain = read_counts(TB)
    expect_counts(s_launches, plain, {"sweep_s_tiled": niter_eff,
                                      "tiled_draws": niter_eff * tld.nbr,
                                      "tiled_scatter": niter_eff * tld.nbr}, "5")
    corr_t = check_fit(fit, b_true, "sbrm tiled")
    log(f"[5] sbrm BayesCpi tiled m={args.sm}: Vg {fit.Vg:.4f} Ve {fit.Ve:.4f} "
        f"h2 {fit.h2:.4f}, corr(alpha, b_true) {corr_t:.4f} (bar {SBAYES_CORR_MIN}); "
        f"chain {fit.chain_seconds:.2f} s = {1e3 * fit.chain_seconds / niter_eff:.2f} "
        f"ms/iter, {niter_eff * args.sm / fit.chain_seconds:.4g} SNP-updates/s on {smi}")
    if not corr_t >= SBAYES_CORR_MIN:
        raise AssertionError(f"sbrm tiled accuracy {corr_t} below {SBAYES_CORR_MIN}")
    del tld, fit
    torch.cuda.empty_cache()

    # ---- 6. sbrm dense path, then CG ----
    t0 = time.perf_counter()
    LD = ar1_ld(torch, args.dm, dev)
    ss, b_true = summary_stats(torch, lambda v: LD @ v, args.dm, args.dm, gen, dev)
    torch.cuda.synchronize()
    log(f"[6] dense AR(1) LD m={args.dm} ({LD.numel() * 4 / 1e9:.3f} GB f32) and the "
        f"statistics made on the card in {time.perf_counter() - t0:.1f} s")
    from hibayes_tpu_torch.data.ld import DenseLD

    ddata, dspec, dpr, dpi = s_setup(torch, TG, TSG, ss, DenseLD(values=LD), "BayesCpi",
                                     64, dev, False)
    t_seg, b_seg = time_segment(torch, TSG, TB, dspec, ddata, dpr, dpi, errs)
    times.update(t_seg)
    bounds.update(b_seg)
    log(f"[6] sweep_s_segment matches its plain version at the dense path's shapes; "
        f"times (ms) on {smi}: {json.dumps(t_seg)}; bounds {json.dumps(b_seg)}")
    profile_iterations(torch, lambda st: TSG.one_s_iteration(dspec, ddata, 1, st),
                       TSG.init_s_state(dspec, ddata, dpr, dpi), "sbrm dense")
    del ddata
    reset_counts(TB)
    fit = hibayes_tpu_torch.sbrm(ss, LD, method="BayesCpi", niter=args.niter,
                                 nburn=args.nburn, thin=thin, seed=args.seed,
                                 device=dev, printfreq=50)
    torch.cuda.synchronize()
    d_launches, plain = read_counts(TB)
    nb_d = -(-args.dm // 64)
    expect_counts(d_launches, plain, {"sweep_s_segment": niter_eff,
                                      "segment_draws": niter_eff * nb_d,
                                      "segment_update": niter_eff * nb_d}, "6")
    corr_d = check_fit(fit, b_true, "sbrm dense")
    log(f"[6] sbrm BayesCpi dense m={args.dm}: Vg {fit.Vg:.4f} Ve {fit.Ve:.4f} "
        f"h2 {fit.h2:.4f}, corr(alpha, b_true) {corr_d:.4f} (bar {SBAYES_CORR_MIN}); "
        f"chain {fit.chain_seconds:.2f} s = {1e3 * fit.chain_seconds / niter_eff:.2f} "
        f"ms/iter, {niter_eff * args.dm / fit.chain_seconds:.4g} SNP-updates/s on {smi}")
    if not corr_d >= SBAYES_CORR_MIN:
        raise AssertionError(f"sbrm dense accuracy {corr_d} below {SBAYES_CORR_MIN}")
    del fit
    t0 = time.perf_counter()
    cg = hibayes_tpu_torch.sbrm(ss, LD, method="CG", device=dev, verbose=False)
    t_cg = time.perf_counter() - t0
    LD64 = LD.double()
    del LD
    xy = torch.as_tensor(ss[:, 1], dtype=torch.float64, device=dev) * torch.diagonal(LD64)
    direct = torch.linalg.solve(LD64, xy).cpu().numpy()
    cg_err = float(np.abs(cg.alpha - direct).max())
    log(f"[6] sbrm CG dense m={args.dm} in {t_cg:.2f} s: max |alpha - direct solve| "
        f"{cg_err:.3g} (bar {CG_ERR_MAX}); Vg {cg.Vg:.4f} h2 {cg.h2:.4f}")
    if not cg_err <= CG_ERR_MAX:
        raise AssertionError(f"CG solution off the direct solve by {cg_err}")
    del LD64

    # ---- 7. results ----
    src = "hibayes_tpu_torch/csrc/blockgibbs.cu"
    ssrc = "hibayes_tpu_torch/csrc/sgibbs.cu"

    def entry(name, source, replaces, n_launch, err, key, **extra):
        b_ms, b_by = bounds[key]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n_launch, "max_abs_err": err, "ms": times[key],
                "plain_ms": times[key + "_plain"], "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None, **extra}

    kernels = [
        entry("sweep_mc", src, "hibayes_tpu/ops/blockgibbs.py:642", launches["sweep_mc"],
              errs["sweep_mc"], "sweep_mc", rows_kernel_launches=launches["rows_kernel"]),
        entry("draws_kernel", src, "hibayes_tpu/ops/blockgibbs.py:1264",
              launches["draws_kernel"], errs["block_draws"], "block_draws"),
        entry("sweep_s_segment", ssrc, "hibayes_tpu/ops/blockgibbs.py:1141",
              d_launches["sweep_s_segment"], errs["sweep_s_segment"], "sweep_s_segment",
              segment_draws_launches=d_launches["segment_draws"],
              segment_update_launches=d_launches["segment_update"]),
        entry("sweep_s_tiled", ssrc, "hibayes_tpu/ops/blockgibbs.py:1635",
              s_launches["sweep_s_tiled"], errs["sweep_s_tiled"], "sweep_s_tiled",
              tiled_draws_launches=s_launches["tiled_draws"],
              tiled_scatter_launches=s_launches["tiled_scatter"],
              full_sweep_ms=times["sweep_s_tiled_full"],
              full_sweep_bound_ms=bounds["sweep_s_tiled_full"][0]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
