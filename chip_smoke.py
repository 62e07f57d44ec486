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
     case with a lowered vary where the guard rejects draws (counted).
     Chain batches: the K-chain rows kernel (sweep_mc at K >= 2, TPU kernel
     2) at K in {2, 8, 64} x {int8, f32} x {BayesCpi, BayesR} and at
     block_range=(2, 3), chains 0-7 of K=64 bit for bit the K=8 launch; the
     K-chain segment sweep at K=4, each chain bit for bit its K=1 launch.
     Bar: at most 1% mixture draws flip, effects within 5e-5 max|g| where
     the draws agree, residuals (r_hat) within 1e-4 max|.| when none flips;
     a second kernel sweep on the same inputs must be bit-identical.  Then
     two small ibrm fits with one seed must agree bit for bit; then each
     kernel is held to the bar and timed beside its plain version at its
     main path's shapes, and sweep_mc at TPU kernels 8's and 2's own shapes
     (K=1 at n=131,072; K=64 at n=4,096, with torch.matmul of its two
     products as the library yardstick, and so at phase 4b's K=4); the
     K-chain sweep's time split per block from its kernels' timer stamps
     (rows launch, W and row loads, wait, reduction of the partials, draw
     chain); the draw chain alone per block of 128 (BayesR with 4 folds
     here, BayesCpi with and without the guard in phase 5), the floor of
     both redesigned kernels;
  4. ibrm main path: hibayes_tpu_torch.ibrm("y ~ x1 + (1|grp)",
     method="BayesR") on one chain at n=50,000 x m=65,536 (int8 genotype made
     on the card, h2=0.5 from 500 causal SNPs), niter=200, nburn=100,
     thin=5; checks that the sweep ran through the kernels only (each CUDA
     kernel's launch count, kept by the library where it launches, is what
     the chain needs, and no plain version ran), finite 0 < h2 < 1, and the
     GEBV accuracy against the simulated truth;
  4b. the same fit with nchains=4 (after a torch.profiler split of the
     batch's iteration): launches through the K-chain rows kernel only,
     every chain finite, R-hat(Ve), GEBV agreement of chains 0 and 1 and
     pooled accuracy, each against its bar;
  4c. ibrm("y ~ x1 + (1|grp)", method="BayesCpi", nchains=64) at n=4,096 x
     m=65,536 (the JAX package's multi-chain configuration), with the same
     checks, the profiler split and the host time of the 64 chains' noise;
  5. sbrm main path (the configuration of benchmarks/sbrm_tiled_500k.py):
     hibayes_tpu_torch.sbrm(method="BayesCpi") on one chain over a tiled
     LD of m=500,000 SNPs, tile 128, a 9-tile band of 0.9^|i-j| (2.30 GB of
     f32 tiles built on the card), BETA = LD b_true with b_true 1% nonzero
     N(0, 0.05^2), SE = 1/sqrt(50,000), N = 50,000; sparse semantics, so the
     guard is on; niter=200, nburn=100, thin=5.  Checks that the sweep ran
     through sweep_s_tiled only, one tiled_sweep launch per sweep and no
     plain call (the full sweep's time split per tile row from the drawer's
     clock stamps is printed with the kernel times), finite Vg, Ve and 0 < h2 < 1, and the accuracy of the
     posterior-mean effects against b_true; before the chain, torch.profiler
     over 3 iterations prints device time by kernel (so does phase 6);
  6. sbrm dense path: the same kind of statistics over a dense AR(1) LD
     (0.9^|i-j|, m=32,768, 4.29 GB f32, block 64), BayesCpi through
     sweep_s_segment only, then (6b) the same fit with nchains=4 through the
     K-chain segment sweep, then method="CG" on the same LD against a direct
     solve on the card;
  7. ssbrm main path (the configuration of benchmarks/ssbrm_100k_pedigree.py
     with m=100,000 SNPs): a 100,000-id pedigree (5,000 founders, parents
     of each offspring drawn among all earlier ids), 20,000 genotyped,
     5,000 genotyped and 5,000 non-genotyped phenotyped; genotypes dropped
     down the pedigree on the card, h2=0.5 from 500 causal SNPs.  Checks
     the epsilon sweep kernel against its plain version on the main path's
     layout (qe=80,000 sites, blocks of 64; its first 16 blocks and the
     whole sweep, a bit-identical second launch; torch.linalg.solve_triangular
     on one block as the library yardstick) and sweep_mc at f32, B=64,
     n=10,000; a torch.profiler split of an iteration at the main path's
     shapes; two small ssbrm fits with one seed bit-identical and a small
     direct-path fit; then hibayes_tpu_torch.ssbrm(impute="pcg",
     method="BayesCpi"), niter=200, nburn=100, thin=5, through sweep_mc and
     mme_sweep only, with its set-up split, finite GEBV of all 100,000 ids,
     Veps and J, 0 < h2 < 1, and the GEBV accuracy of the non-genotyped
     phenotyped ids against the truth;
  8. a JSON line of kernels, the nvidia-smi line, and the last line
     {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import gc
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
# Accuracy bar of the ssbrm path: corr of the posterior-mean GEBV of the
# 5,000 non-genotyped phenotyped ids with their simulated genetic values.
# Each has its own record (h2 = 0.5: the record alone predicts at up to
# sqrt(0.5) = 0.71) and genotypes imputed from genotyped relatives; it
# measured 0.720 on an H100 (0.789 for the genotyped ids; PERF.md).  The
# chain is deterministic for a seed; 0.6 leaves room for another card's
# rounding, and a sweep that draws epsilon or the effects against the
# wrong system loses most of the record's share.
SSBRM_CORR_MIN = 0.6
# Multi-chain gates (phases 4b and 4c).  Split R-hat of Ve over the chains'
# 20 kept records each cannot certify convergence here, so it bounds
# divergence instead.  Ve's posterior is narrow (n = 4,096 or 50,000
# residuals: a relative sd of 2.2% or 0.6%), and at m >> n the chains sit
# a few percent apart in Ve for thousands of iterations, as the JAX
# package's own chains do (scripts/chain_mixing.py reference: R-hat(Ve)
# 1.41 for JAX, 1.22 for the port, 4 chains at n=512, m=8,192; rehearse:
# 1.85 for this phase's recipe on the CPU; PERF.md).  Its windows
# study on an H100 put R-hat(Ve) at 1.35-1.90 over 1,500 iterations of
# phase 4c and 0.99-1.25 over 800 of phase 4b.  Its fault study (these
# phases, chain seeds 2024 and 2025, sound and with each chain sweeping
# against chain k+1's residual once or in every sweep; H100) does not let
# R-hat(Ve) carry the check: sound 1.98-2.14 (4c) and 1.05-1.06 (4b);
# once 2.59-2.70 and 1.06-1.13; always 1.01-1.02 and 1.92-1.96.  The bars
# sit above every sound reading and catch a diverging batch; the GEBV
# agreement of chains 0 and 1 below separates every planted fault.
RHAT_VE_MAX_FLAGSHIP = 1.5
RHAT_VE_MAX_MC64 = 2.5
# The flagship's 4 chains: each is the phase-4 chain's recipe (GEBV
# accuracy 0.977 on an H100), so the pooled accuracy keeps GEBV_CORR_MIN;
# two chains' posterior-mean GEBV, each over 20 records, differ by Monte-
# Carlo error only, and both sit within 0.977 of the truth: 0.95.  In the
# fault study: sound 0.995; planted faults 0.31-0.88.
FLAGSHIP_CHAINS_CORR_MIN = 0.95
# 64 chains at n=4,096, m=65,536 (BayesCpi, 500 causal SNPs, h2=0.5): each
# causal SNP explains ~1e-3 of the variance, a marginal z of ~2 at this n,
# so a chain finds few of them and the accuracy is moderate.  A CPU
# rehearsal of this recipe (scripts/chain_mixing.py rehearse: 2 chains,
# 200 iterations, the plain sweep) measured GEBV accuracy 0.811 and 0.808
# (pooled 0.817) and corr(chain 0, chain 1) 0.962.  The card draws another genotype from the
# same recipe; 0.7 and 0.9 leave room for that and for Monte-Carlo error.
# In the fault study: sound 0.958-0.959 and accuracy 0.778-0.779; planted
# faults 0.0006-0.56 and 0.67-0.75, so the agreement bar catches them all.
MC64_ACC_MIN = 0.7
MC64_CHAINS_CORR_MIN = 0.9
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
    """Device ms per call of ``fn`` (CUDA events over ``reps`` calls), after
    warm-up calls for at least 0.1 s: the card lowers its clocks while the
    host runs a plain version, and a short timed loop right after one would
    meet them low.  Python's cyclic garbage collector is held off during
    the timed calls: this process holds many objects, and a collection in
    the loop would time the collector (on the host), not the calls."""
    t_end = time.perf_counter() + 0.1
    fn()
    torch.cuda.synchronize()
    while time.perf_counter() < t_end:
        fn()
        torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    gc.collect()
    gc.disable()
    try:
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
    finally:
        gc.enable()
    return t0.elapsed_time(t1) / reps


def chain_us(torch, TB, spec, W, Pb, r0, vary=None, reps=400):
    """The draw chain's own latency per block of B draws (one warp, W and
    the packed rows already in shared memory, each block depending on the
    one before): CUDA events around one launch of ``reps`` blocks, after a
    warm-up launch.  Returns (us per block, clock cycles per block)."""
    TB.chain_latency(spec, W, Pb, r0, 10, vary)
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    cycles = TB.chain_latency(spec, W, Pb, r0, reps, vary)
    t1.record()
    torch.cuda.synchronize()
    return 1e3 * t0.elapsed_time(t1) / reps, int(cycles) / reps


def sweep_split(torch, TB, spec, part, nbg):
    """Where a K-chain sweep's time goes, per block (us, means over the
    blocks), from the timer stamps of the first CTA of each launch
    (sweep_mc(stamps=...)): the rows launch from its start to its wait
    (its first X chunks in flight, then the draws before it) and on to its
    end; the draws launch's W and packed-row load, its wait for the rows
    launch (the other rows CTAs and the hand-off), the reduction of the
    partials, the draw chain; the block's period; and, at K >= 2, the rows
    CTA's first chunk: its wait for the chunk and the barrier, the next
    chunk's copies issued, the residual update, the second barrier, the
    partials."""
    st = torch.zeros(16 * (nbg + 1), dtype=torch.int64, device=part[2].device)
    TB.sweep_mc(*part, block_range=(0, nbg), stamps=st)
    torch.cuda.synchronize()
    s = st.view(nbg + 1, 16).cpu().numpy().astype(np.float64)
    b, nxt = s[:nbg] / 1e3, s[1:] / 1e3
    mean = lambda x: round(float(np.mean(x)), 3)
    out = {"rows_start_to_wait_us": mean(b[:, 1] - b[:, 0]),
           "rows_cta0_work_us": mean(b[:, 2] - b[:, 1]),
           "draws_load_us": mean(b[:, 4] - b[:, 3]),
           "draws_wait_us": mean(b[:, 5] - b[:, 4]),
           "draws_reduce_us": mean(b[:, 6] - b[:, 5]),
           "draws_chain_us": mean(b[:, 7] - b[:, 6]),
           "draws_end_to_next_rows_us": mean(nxt[:, 1] - b[:, 7]),
           "block_period_us": mean(nxt[:, 1] - b[:, 1])}
    c = s[1:nbg, 8:15]   # blocks with both X blocks (a residual update)
    if c[:, -1].all():
        ns = (s[1:nbg, 2] - s[1:nbg, 1]) / (c[:, 6] - c[:, 0])
        d = np.diff(c, axis=1) * ns[:, None] / 1e3
        for k, name in enumerate(("chunk0_wait_us", "chunk0_issue_us", "chunk0_residual_us",
                                  "chunk0_barrier_us", "chunk0_partials_us",
                                  "later_chunks_us")):
            out[name] = mean(d[:, k])
    return out


def tiled_split(torch, TB, spec, args):
    """Where the one-launch tiled sweep's time goes, per tile row (us, means
    over the rows), from the drawer's clock64 stamps (sweep_s_tiled(stamps=
    ...)), converted with its own %globaltimer: the draw chain with its
    guard, the wait for the next row's staging that the chain did not hide,
    and the drawer's own contribution to block i + 1."""
    nbr = args[0].shape[0]
    st = torch.zeros(4 * nbr + 4, dtype=torch.int64, device=args[0].device)
    TB.sweep_s_tiled(spec, *args, stamps=st)
    torch.cuda.synchronize()
    s = st.cpu().numpy().astype(np.float64)
    ns_per_cycle = (s[4 * nbr + 1] - s[4 * nbr]) / (s[4 * nbr + 3] - s[4 * nbr + 2])
    rows = s[:4 * nbr].reshape(nbr, 4) * ns_per_cycle / 1e3
    mean = lambda x: round(float(np.mean(x)), 3)
    return {"chain_us": mean(rows[:, 1] - rows[:, 0]),
            "staging_wait_us": mean(rows[:, 2] - rows[:, 1]),
            "own_contribution_us": mean(rows[:, 3] - rows[:, 2]),
            "row_us": mean(np.diff(rows[:, 0])),
            "sweep_ms": round((s[4 * nbr + 1] - s[4 * nbr]) / 1e6, 4),
            "sm_clock_ghz": round(1.0 / ns_per_cycle, 3)}


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
    # the K-chain rows kernel at phase 4b's shapes, where a tile spans several
    # chunks (the smaller checks fit a tile in one)
    args4 = sweep_args(torch, TG, spec, data, pr, pi, 4, seed=4)
    per4 = args4[5:]
    part4 = (spec, args4[0], X, W, xpx[cols], vx[cols], *(a[:, cols] for a in per4[:7]),
             per4[7], per4[8])
    out4, again4 = (TB.sweep_mc(*part4, block_range=(0, nbg)) for _ in range(2))
    tile = TB.rows_per_tile(X.shape[1], X.device, 4)
    _, tr, rb, _ = TB.rows_mc_shape(4, tile)
    what = (f"sweep_mc K=4 at the main path's shapes ({tile}-row tiles, "
            f"chunks of {32 * tr * rb} rows)")
    errs["sweep_mc_k"] = max(errs["sweep_mc_k"], bar(
        TB.sweep_mc_plain(*part4, block_range=(0, nbg)), out4, what))
    if not all(torch.equal(a, b) for a, b in zip(out4, again4)):
        raise AssertionError(f"{what}: two runs differ (not deterministic)")
    log(f"  ok {what}")
    t = {}
    t["sweep_mc_k4"] = cuda_ms(torch, lambda: TB.sweep_mc(*part4, block_range=(0, nbg)), 10)
    t["sweep_mc_k4_split"] = sweep_split(torch, TB, spec, part4, nbg)
    # torch.matmul of the K=4 sweep's two products per block, (4, n) x (n, B)
    # and (4, B) x (B, n) in float32: the library yardstick at this K
    Xf = X[:nbg].float()
    dg4 = 0.01 * torch.randn((4, B), device=X.device)
    y4 = per4[7]

    def products():
        for b in range(nbg):
            torch.matmul(y4, Xf[b])
            torch.matmul(dg4, Xf[b].T)

    t["sweep_mc_k4_library"] = cuda_ms(torch, products, 10)
    del Xf
    t["sweep_mc"] = cuda_ms(torch, lambda: TB.sweep_mc(*part, block_range=(0, nbg)), 10)
    t["sweep_mc_split"] = sweep_split(torch, TB, spec, part, nbg)
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
    # the BayesR (4 folds) draw chain alone, on this block's W and rows
    t["chain_bayesr_us"], t["chain_bayesr_cycles"] = chain_us(
        torch, TB, spec, W[0], P_b[:, :, 0].contiguous(), r0[:, 0].contiguous())
    # bounds of the timed calls: each input read once, each output written once
    nb = lambda *ts: sum(x.numel() * x.element_size() for x in ts)
    n_rows, m_loc = X.shape[1], nbg * B
    sweep_bytes = (nb(X[:nbg], W[:nbg], xpx[cols], vx[cols], *loc, per[7], per[8])
                   + 4 * m_loc * 3 + nb(per[7], per[8]))   # g, track, vargL; yadj, u out
    bounds = {"sweep_mc": bound(sweep_bytes, nbg * (4.0 * n_rows * B + 2.0 * B * B)),
              "block_draws": bound(nb(W[0], P_b, r0, logpi) + 2 * r0.numel() * 4,
                                   2.0 * B * B * r0.shape[1]),
              "sweep_mc_k4": bound(nb(X[:nbg], W[:nbg], *part4[4:]) + 4 * 4 * m_loc * 3
                                   + nb(per4[7], per4[8]),
                                   nbg * 4 * (4.0 * n_rows * B + 2.0 * B * B))}
    return t, spec.n, bounds


def chains(args, k0, k1):
    """The sweep arguments (sweep_args) of chains k0 .. k1 - 1 of a batch."""
    consts, X, W, xpx, vx, *per = args
    return ({c: v[k0:k1] for c, v in consts.items()}, X, W, xpx, vx,
            *(a[k0:k1] for a in per))


def sweep_bound(args, B):
    """(bound_ms, bound_by) of a K-chain sweep over all of X's blocks: X, W
    and the per-SNP inputs read once, yadj and u (K, n) read and written,
    g, track and vargL written; or 4 K n B float32 operations per block for
    the two products and 2 K B^2 for the draws' corrections."""
    consts, X, W, xpx, vx, *per = args
    nbg, n = X.shape[0], X.shape[1]
    K = per[7].shape[0]
    by = nbytes(X, W, xpx, vx, *per) + 4 * K * nbg * B * 3 + nbytes(per[7], per[8])
    return bound(by, nbg * K * (4.0 * n * B + 2.0 * B * B))


def check_kernels_mc(torch, TG, TB, dev, errs, n=4096, m=1024, B=128):
    """The K-chain rows kernel (sweep_mc at K >= 2, the port of TPU kernel
    2) against its plain version: K in {2, 8, 64} x {int8, f32} x {BayesCpi,
    BayesR}, each at the bar and bit-identical on a second launch; chains
    0-7 of the K=64 launch and 0-1 of the K=8 launch bit for bit those of
    the smaller launches on the same inputs (the kernel's sums do not depend
    on K; the per-chain sums of phase C are torch reductions and are left
    out); and block_range=(2, 3) at K=8."""
    gen = torch.Generator(device=dev).manual_seed(17)
    M = make_genotype(torch, n, m, gen, dev)
    y = (M[:, :64].float() @ (0.1 * torch.randn(64, generator=gen, device=dev))
         + torch.randn(n, generator=gen, device=dev)).cpu().numpy()
    for x_int8 in (True, False):
        for model in ("BayesCpi", "BayesR"):
            fold = np.array([0.0, 1e-4, 1e-3, 1e-2]) if model == "BayesR" else None
            data = TG.prepare_gibbs_data(
                y, M if x_int8 else M.float(), block=B, fold=fold,
                geno_dtype="int8" if x_int8 else None, device=dev)
            spec, pr, pi = make_spec(TG, model, data, m, n)
            all64 = sweep_args(torch, TG, spec, data, pr, pi, 64, seed=64)
            outs = {}
            for K in (2, 8, 64):
                args = chains(all64, 0, K)
                out = TB.sweep_mc(spec, *args)
                ref = TB.sweep_mc_plain(spec, *args)
                again = TB.sweep_mc(spec, *args)
                torch.cuda.synchronize()
                what = f"sweep_mc {model} {'int8' if x_int8 else 'f32'} K={K}"
                errs["sweep_mc_k"] = max(errs["sweep_mc_k"], bar(ref, out, what))
                if not all(torch.equal(a, b) for a, b in zip(out, again)):
                    raise AssertionError(f"{what}: two runs differ (not deterministic)")
                outs[K] = out
                log(f"  ok {what}")
            for small, big in ((8, 64), (2, 8)):
                if not all(torch.equal(a[:small], b)
                           for a, b in zip(outs[big][:5], outs[small][:5])):
                    raise AssertionError(f"sweep_mc {model}: chains 0-{small - 1} of K={big} "
                                         f"differ from the K={small} launch")
            log(f"  ok sweep_mc {model}: chains 0-7 of K=64 and 0-1 of K=8 bit for bit "
                f"the K=8 and K=2 launches")
            if x_int8 and model == "BayesR":
                off, nbg = 2, 3
                consts, X, W, xpx, vx, *per = chains(all64, 0, 8)
                cols = slice(off * B, (off + nbg) * B)
                loc = [a[:, cols] for a in per[:7]]
                out = TB.sweep_mc(spec, consts, X, W, xpx[cols], vx[cols], *loc,
                                  per[7], per[8], block_range=(off, nbg))
                ref = TB.sweep_mc_plain(
                    spec, consts, X[off:off + nbg].contiguous(),
                    W[off:off + nbg].contiguous(), xpx[cols], vx[cols], *loc,
                    per[7], per[8])
                errs["sweep_mc_k"] = max(errs["sweep_mc_k"],
                                         bar(ref, out, "sweep_mc offset (2, 3) BayesR K=8"))
                log("  ok sweep_mc block_range=(2, 3) BayesR int8 K=8")


def time_k5(torch, TG, TB, dev, errs, B=128, nbg=16):
    """Rows 2 and 8 of PERF.md's kernel table, each at its TPU kernel's own
    shapes over nbg blocks, held to the bar and timed with CUDA events
    beside its plain version.  Row 8 (sweep_chunked, X streamed in 2,048-row
    chunks beyond kernel 1's VMEM reach): sweep_mc at K=1, n=131,072 =
    64 x 2,048, int8, BayesR.  Row 2 (sweep_mc, K chains sharing X_b):
    sweep_mc at K=64, n=4,096, int8, BayesCpi, with torch.matmul of its two
    products per block, (K, n) x (n, B) and (K, B) x (B, n) in float32, as
    the library yardstick (no PyTorch call computes the draws).  Row 1
    (sweep, the X block VMEM-resident) is sweep_mc at K=1 at the main
    path's n=50,176, which time_kernels times for row 3.  Returns (times,
    bounds)."""
    t, bounds = {}, {}
    gen = torch.Generator(device=dev).manual_seed(23)
    for key, n, K, model in (("k8", 131_072, 1, "BayesR"), ("k2", 4096, 64, "BayesCpi")):
        m = nbg * B
        M = make_genotype(torch, n, m, gen, dev)
        y = (M[:, :64].float() @ (0.1 * torch.randn(64, generator=gen, device=dev))
             + torch.randn(n, generator=gen, device=dev)).cpu().numpy()
        fold = np.array([0.0, 1e-4, 1e-3, 1e-2]) if model == "BayesR" else None
        data = TG.prepare_gibbs_data(y, M, block=B, fold=fold, geno_dtype="int8", device=dev)
        del M
        spec, pr, pi = make_spec(TG, model, data, m, n)
        args = sweep_args(torch, TG, spec, data, pr, pi, K, seed=K)
        what = f"sweep_mc K={K} at n={n}, B={B}, int8, {model}, {nbg} blocks"
        errs["sweep_mc_" + key] = bar(TB.sweep_mc_plain(spec, *args),
                                      TB.sweep_mc(spec, *args), what)
        log(f"  ok {what}")
        t["sweep_mc_" + key] = cuda_ms(torch, lambda: TB.sweep_mc(spec, *args), 10)
        if K > 1:
            t["sweep_mc_" + key + "_split"] = sweep_split(torch, TB, spec, (spec, *args), nbg)
        t["sweep_mc_" + key + "_plain"] = cuda_ms(torch, lambda: TB.sweep_mc_plain(spec, *args), 1)
        bounds["sweep_mc_" + key] = sweep_bound(args, B)
        if K > 1:
            Xf = data.X_blocks.float()
            yadj = args[12]
            dg = 0.01 * torch.randn((K, B), generator=gen, device=dev)

            def products():
                for b in range(nbg):
                    torch.matmul(yadj, Xf[b])
                    torch.matmul(dg, Xf[b].T)

            t["sweep_mc_k2_library"] = cuda_ms(torch, products, 10)
            # host time to enqueue each: where it nears the device time, the
            # host bounds the 16-block loop
            t["sweep_mc_k2_host"] = host_ms(torch, lambda: TB.sweep_mc(spec, *args))
            t["sweep_mc_k2_library_host"] = host_ms(torch, products)
            del Xf
        del data, args
        torch.cuda.empty_cache()
    return t, bounds


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


def check_segment_mc(torch, TG, TSG, TB, dev, errs, K=4, m=1000):
    """The K-chain segment sweep (sweep_s_segment over K chains, whose
    draws are TPU kernel 7's) at K=4 against its plain version on a dense
    AR(1) LD, BayesCpi and BayesR: the bar, a bit-identical second launch,
    and each chain bit for bit a K=1 launch (the single-chain sweep) on
    that chain's inputs."""
    from hibayes_tpu_torch.data.ld import DenseLD

    gen = torch.Generator(device=dev).manual_seed(13)
    LD = ar1_ld(torch, m, dev)
    ss, _ = summary_stats(torch, lambda v: LD @ v, m, m, gen, dev)
    for model in ("BayesCpi", "BayesR"):
        data, spec, pr, pi = s_setup(torch, TG, TSG, ss, DenseLD(values=LD), model, 64,
                                     dev, False)
        seg = data.ld_segs[0]
        ins = [s_sweep_inputs(torch, TSG, spec, data, pr, pi, lambda v: seg @ v, seed=5 + k)
               for k in range(K)]
        g, r, P = (torch.stack(x) for x in zip(*ins))
        outs = [TB.sweep_s_segment(spec, seg, r, P, spec.n) for _ in range(2)]
        ref = TB.sweep_s_segment_plain(spec, seg, r, P, spec.n)
        ones = [TB.sweep_s_segment(spec, seg, r[k], P[k], spec.n) for k in range(K)]
        torch.cuda.synchronize()
        what = f"sweep_s_segment {model} K={K}"
        errs["sweep_s_segment_k"] = max(errs["sweep_s_segment_k"], bar(
            (g - ref[0], ref[1], ref[2]), (g - outs[0][0], outs[0][1], outs[0][2]),
            what, r_index=2))
        if not all(torch.equal(a, b) for a, b in zip(*outs)):
            raise AssertionError(f"{what}: two runs differ (not deterministic)")
        for k, one in enumerate(ones):
            if not all(torch.equal(a[k], b) for a, b in zip(outs[0], one)):
                raise AssertionError(f"{what}: chain {k} differs from its K=1 launch")
        log(f"  ok {what} (m={m}, B=64); each chain bit for bit its K=1 launch")


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
    # the BayesCpi draw chain alone, with and without the guard, on the
    # first tile row's Gram block and rows
    B = T
    Wn = spec.n * data.ld_tiles[0, 0]
    Pg = P[:, :B].T.contiguous()
    chain = {"chain_bayescpi_guard": chain_us(torch, TB, spec, Wn, Pg, r[:B], spec.vary),
             "chain_bayescpi": chain_us(torch, TB, spec, Wn,
                                        Pg[:, :TB.n_rows(spec)].contiguous(), r[:B])}
    t = {"sweep_s_tiled": cuda_ms(torch, lambda: TB.sweep_s_tiled(sub, *args), 10),
         "sweep_s_tiled_plain": cuda_ms(torch, lambda: TB.sweep_s_tiled_plain(sub, *args), 1),
         "sweep_s_tiled_full": cuda_ms(torch, lambda: TB.sweep_s_tiled(spec, *full), 3),
         "sweep_s_tiled_full_host": host_ms(torch, lambda: TB.sweep_s_tiled(spec, *full)),
         "sweep_s_tiled_split": tiled_split(torch, TB, spec, full)}
    for key, (us, cyc) in chain.items():
        t[key + "_us"], t[key + "_cycles"] = us, cyc
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
    # the K-chain segment sweep on the same segment: the bar, a bit-identical
    # second launch, each chain bit for bit its K=1 launch
    ins = [s_sweep_inputs(torch, TSG, spec, data, pr, pi, lambda v: seg @ v, 20 + k)
           for k in range(4)]
    g4, r4, P4 = (torch.stack(x) for x in zip(*ins))
    outs = [TB.sweep_s_segment(spec, seg, r4, P4, spec.n) for _ in range(2)]
    ref = TB.sweep_s_segment_plain(spec, seg, r4, P4, spec.n)
    what = f"sweep_s_segment K=4 at the dense path's shapes (m={seg.shape[0]})"
    errs["sweep_s_segment_k"] = max(errs["sweep_s_segment_k"], bar(
        (g4 - ref[0], ref[1], ref[2]), (g4 - outs[0][0], outs[0][1], outs[0][2]),
        what, r_index=2))
    if not all(torch.equal(a, b) for a, b in zip(*outs)):
        raise AssertionError(f"{what}: two runs differ (not deterministic)")
    for k in range(4):
        one = TB.sweep_s_segment(spec, seg, r4[k], P4[k], spec.n)
        if not all(torch.equal(a[k], b) for a, b in zip(outs[0], one)):
            raise AssertionError(f"{what}: chain {k} differs from its K=1 launch")
    log(f"  ok {what}; each chain bit for bit its K=1 launch")
    t = {"sweep_s_segment_k4": cuda_ms(
             torch, lambda: TB.sweep_s_segment(spec, seg, r4, P4, spec.n), 3),
         "sweep_s_segment": cuda_ms(torch, lambda: TB.sweep_s_segment(spec, seg, r, P, spec.n), 3),
         "sweep_s_segment_host": host_ms(
             torch, lambda: TB.sweep_s_segment(spec, seg, r, P, spec.n)),
         "sweep_s_segment_plain": cuda_ms(
             torch, lambda: TB.sweep_s_segment_plain(spec, seg, r, P, spec.n), 1)}
    mc, B = seg.shape[0], spec.block
    b = nbytes(seg, r, P) + 4 * mc * 3
    return t, {"sweep_s_segment": bound(b, 2.0 * mc * mc + 2.0 * B * mc)}


def profile_iterations(torch, step, state, what, iters=3, split=None):
    """torch.profiler over ``iters`` iterations (``state = step(state)``)
    after one unprofiled warm-up: device time by kernel, and the device's
    busy share of the profiled wall time.  With ``split`` (a dict), fills
    in the ms per iteration of the SNP sweep's kernels (sweep_mc: rows and
    draws), the epsilon sweep (mme_sweep) and the rest (torch), and the
    wall.  Returns the final state."""
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
    if split is not None:
        part = lambda *keys: sum(t for k, (t, _) in kern.items()
                                 if any(x in k for x in keys)) / 1e3
        split["rows"] = part("rows_kernel", "rows_mc_kernel")
        split["draws"] = part("draws_kernel")
        split["sweep_mc"] = split["rows"] + split["draws"]
        split["mme_sweep"] = part("mme_sweep_kernel")
        split["torch"] = busy / 1e3 - split["sweep_mc"] - split["mme_sweep"]
        split["wall"] = 1e3 * wall / iters
    return state


def chain_gebv(fit, nchains, n_records):
    """Posterior-mean GEBV of each chain of a pooled fit (chain-major records)."""
    g = fit.MCMCsamples["g"]
    return [g[:, k * n_records:(k + 1) * n_records].mean(axis=1) for k in range(nchains)]


def ibrm_chains(torch, hibayes_tpu_torch, TB, M, data, gv, method, nchains, niter, nburn,
                seed, smi, what, acc_min, corr_min, rhat_max, B=128):
    """hibayes_tpu_torch.ibrm("y ~ x1 + (1|grp)", nchains=...) on the card:
    the sweep through sweep_mc with the K-chain rows kernel only (launch
    counts), every chain finite, R-hat(Ve) below ``rhat_max``, GEBV of
    chains 0 and 1 correlated at ``corr_min`` or more, and the pooled GEBV's
    accuracy against the truth at ``acc_min`` or more.  Prints ms/iter,
    aggregate and per-chain SNP-updates/s, R-hat and the spread of the
    chains' mean Ve.  Returns the fit's numbers."""
    thin = 5
    n_rec = (niter - nburn) // thin
    niter_eff = nburn + n_rec * thin
    m = M.shape[1]
    reset_counts(TB)
    t0 = time.perf_counter()
    fit = hibayes_tpu_torch.ibrm(
        "y ~ x1 + (1|grp)", data=data, M=M, M_id=data["id"], method=method,
        niter=niter, nburn=nburn, thin=thin, block=B, seed=seed,
        device=M.device, nchains=nchains, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = read_counts(TB)
    nblocks = -(-m // B)
    expect_counts(launches, plain, {"sweep_mc": niter_eff,
                                    "rows_mc_kernel": niter_eff * (nblocks + 1),
                                    "draws_kernel": niter_eff * nblocks}, what)
    smp = fit.MCMCsamples
    for k in ("mu", "Vg", "Ve", "h2", "alpha"):
        per = smp[k].reshape((nchains, n_rec) + smp[k].shape[1:])
        bad = [c for c in range(nchains) if not np.isfinite(per[c]).all()]
        if bad:
            raise AssertionError(f"{what}: chains {bad} have non-finite {k}")
    gebv = chain_gebv(fit, nchains, n_rec)
    gv_np = gv.cpu().numpy()
    ve = smp["Ve"].reshape(nchains, n_rec).mean(axis=1)
    corr01 = float(np.corrcoef(gebv[0], gebv[1])[0, 1])
    acc = float(np.corrcoef(fit.g["gebv"], gv_np)[0, 1])
    acc0 = float(np.corrcoef(gebv[0], gv_np)[0, 1])
    sec = fit.chain_seconds
    out = {"ms_per_iter": 1e3 * sec / niter_eff,
           "snp_updates_per_s": nchains * m * niter_eff / sec,
           "per_chain_snp_updates_per_s": m * niter_eff / sec,
           "rhat_Vg": fit.rhat["Vg"], "rhat_Ve": fit.rhat["Ve"], "corr01": corr01,
           "acc": acc, "acc0": acc0, "wall_s": wall, "launches": launches,
           "ve_spread": float((ve.max() - ve.min()) / ve.mean())}
    log(f"[{what}] ibrm {method} nchains={nchains} n={M.shape[0]} m={m}: Vg {fit.Vg:.4f} "
        f"Ve {fit.Ve:.4f} h2 {fit.h2:.4f}; R-hat Vg {out['rhat_Vg']:.4f} Ve "
        f"{out['rhat_Ve']:.4f} (bar {rhat_max}), chains' mean Ve within "
        f"{100 * out['ve_spread']:.2f}% of each other; corr(GEBV chain 0, chain 1) "
        f"{corr01:.4f} (bar {corr_min}); GEBV accuracy pooled {acc:.4f} (bar {acc_min}), "
        f"chain 0 {acc0:.4f}")
    log(f"[{what}] wall {wall:.2f} s; chain {sec:.2f} s = {out['ms_per_iter']:.2f} ms/iter, "
        f"{out['snp_updates_per_s']:.4g} SNP-updates/s over {nchains} chains, "
        f"{out['per_chain_snp_updates_per_s']:.4g} per chain on {smi}")
    if not out["rhat_Ve"] < rhat_max:
        raise AssertionError(f"{what}: R-hat(Ve) {out['rhat_Ve']} not below {rhat_max}")
    if not corr01 >= corr_min:
        raise AssertionError(f"{what}: chains 0 and 1 GEBV corr {corr01} below {corr_min}")
    if not acc >= acc_min:
        raise AssertionError(f"{what}: GEBV accuracy {acc} below {acc_min}")
    return out


def profile_chains(torch, TG, TB, M, y, nchains, model, smi, B=128):
    """torch.profiler over iterations of a K-chain batch at a phase's
    shapes (int8, no covariates): device time of the K-chain rows kernel,
    the draws and the torch ops per iteration; and the host time to enqueue
    a whole iteration, its pre-sweep (with the per-chain draws: the one
    loop over chains), sweep and post-sweep, and the sweep's per-chain
    random numbers alone."""
    dev = M.device
    n, m = M.shape
    fold = np.array([0.0, 1e-4, 1e-3, 1e-2]) if model == "BayesR" else None
    data = TG.prepare_gibbs_data(y, M, block=B, fold=fold, geno_dtype="int8", device=dev)
    spec, pr, pi = make_spec(TG, model, data, m, n)
    states = TG.stack_state(TG.init_state(spec, data, pr, pi), nchains)
    split = {}
    states = profile_iterations(torch, lambda ss: TG.one_iteration_batch(spec, data, 1, ss),
                                states, f"ibrm {model} n={n} K={nchains}", split=split)
    noise = TG.chain_noise(1, states.it, nchains, dev, torch.float32)
    split["host_noise"] = host_ms(
        torch, lambda: TG._sweep_noise(spec, noise, (nchains,), torch.float32, dev))
    split["host_iteration"] = host_ms(
        torch, lambda: TG.one_iteration_batch(spec, data, 1, states))
    pre = {}
    split["host_pre_sweep"] = host_ms(
        torch, lambda: pre.update(TG._pre_sweep(spec, data, noise, states)))
    sweep = lambda: TB.sweep_mc(spec, pre["consts"], data.X_blocks, data.W_blocks, data.xpx,
                                data.vx, pre["vei"], states.g, *pre["rnd"], pre["vargL_in"],
                                pre["yadj"], pre["u"])
    split["host_sweep"] = host_ms(torch, sweep)
    out = sweep()
    split["host_post_sweep"] = host_ms(
        torch, lambda: TG._post_sweep(spec, data, noise, states, pre, out))
    log(f"[profile ibrm {model} n={n} K={nchains}] split per iteration on {smi}: rows_mc_kernel "
        f"{split['rows']:.3f} ms, draws_kernel {split['draws']:.3f} ms, torch ops "
        f"{split['torch']:.3f} ms (device); host enqueue of a whole iteration "
        f"{split['host_iteration']:.3f} ms = pre-sweep {split['host_pre_sweep']:.3f} ms (of "
        f"it the sweep's per-chain noise {split['host_noise']:.3f} ms) + sweep "
        f"{split['host_sweep']:.3f} ms + post-sweep {split['host_post_sweep']:.3f} ms; "
        f"wall {split['wall']:.3f} ms")
    return split


KERNELS = ("sweep_mc", "block_draws", "sweep_s_segment", "sweep_s_tiled", "mme_sweep")
PLAINS = ("sweep_mc_plain", "block_draws_plain", "sweep_s_segment_plain",
          "sweep_s_tiled_plain", "mme_sweep_plain", "mme_block_draws_plain")


def reset_counts(TB):
    for k in KERNELS:
        getattr(TB, k).launches = 0
    for k in PLAINS:
        getattr(TB, k).calls = 0
    TB.reset_kernel_launches()


def read_counts(TB):
    return ({**{k: getattr(TB, k).launches for k in KERNELS}, **TB.kernel_launches()},
            sum(getattr(TB, k).calls for k in PLAINS))


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


# ---------------------------------------------------------------------------
# single step (ssbrm)
# ---------------------------------------------------------------------------


def make_pedigree(nfound, nkid, seed):
    """Founders, then offspring whose sire and dam are drawn among all
    earlier ids (the rule of benchmarks/ssbrm_100k_pedigree.py).  Returns
    ids, sires, dams (strings) and the parents' indices of the offspring."""
    rng = np.random.default_rng(seed)
    ids = np.array([f"F{i}" for i in range(nfound)] + [f"K{k}" for k in range(nkid)])
    hi = nfound + np.arange(nkid)
    s_par, d_par = rng.integers(0, hi), rng.integers(0, hi)
    sires = np.concatenate([np.full(nfound, "0"), ids[s_par]])
    dams = np.concatenate([np.full(nfound, "0"), ids[d_par]])
    return ids, sires, dams, s_par, d_par


def drop_genes(torch, nfound, s_par, d_par, m, rows, gen, dev, n_causal=500,
               chunk=4096):
    """Genotypes dropped down the pedigree on the card, column chunk by
    column chunk and generation by generation: founders Binomial(2, p_j),
    p_j ~ U(0.05, 0.5); each parent passes one allele, 1 with probability
    (its genotype) / 2.  Returns the int8 genotype of ``rows`` (len(rows),
    m) and the genetic values of every id from n_causal SNPs with N(0, 1)
    effects, scaled to variance 0.5."""
    nkid = len(s_par)
    n = nfound + nkid
    depth = np.zeros(n, np.int64)
    for k in range(nkid):
        depth[nfound + k] = 1 + max(depth[s_par[k]], depth[d_par[k]])
    to_dev = lambda a: torch.as_tensor(a, device=dev)
    waves = []
    for g in range(1, int(depth.max()) + 1):
        kids = np.flatnonzero(depth == g)
        waves.append((to_dev(kids), to_dev(s_par[kids - nfound]), to_dev(d_par[kids - nfound])))
    rows_t = to_dev(np.asarray(rows))
    M = torch.empty((len(rows), m), dtype=torch.int8, device=dev)
    causal = torch.randperm(m, generator=gen, device=dev)[:n_causal]
    effect = torch.zeros(m, device=dev)
    effect[causal] = torch.randn(n_causal, generator=gen, device=dev)
    gv = torch.zeros(n, device=dev)
    for c0 in range(0, m, chunk):
        c = min(m, c0 + chunk) - c0
        G = torch.empty((n, c), dtype=torch.int8, device=dev)
        p = torch.rand(c, generator=gen, device=dev) * 0.45 + 0.05
        G[:nfound] = ((torch.rand((nfound, c), generator=gen, device=dev) < p).to(torch.int8)
                      + (torch.rand((nfound, c), generator=gen, device=dev) < p).to(torch.int8))
        for kids, sp, dp in waves:
            a = torch.rand((kids.numel(), c), generator=gen, device=dev) < G[sp] * 0.5
            b = torch.rand((kids.numel(), c), generator=gen, device=dev) < G[dp] * 0.5
            G[kids] = a.to(torch.int8) + b.to(torch.int8)
        M[:, c0:c0 + c] = G[rows_t]
        gv += G.float() @ effect[c0:c0 + c]
    gv = (gv - gv.mean()) / gv.std() * np.sqrt(0.5)
    return M, gv, int(depth.max())


def ssbrm_layout(torch, TG, ids, sires, dams, geno, dev, T=64):
    """The epsilon system of the ssbrm main path, built as ssbrm builds it:
    A-inverse of the pedigree, its non-genotyped block in RCM order, packed
    in blocks of T on the card.  Returns (layout, Ai_nn, ng_ids)."""
    from hibayes_tpu_torch.data.pedigree import make_ainv, make_ped, rcm_permutation

    ped_ids, s_idx, d_idx = make_ped(ids, sires, dams)
    Ai = make_ainv(s_idx, d_idx).tocsr()
    ng = np.flatnonzero(~np.isin(ped_ids, geno))
    ng = ng[rcm_permutation(Ai[ng].tocsc()[:, ng])]
    Ai_nn = Ai[ng].tocsc()[:, ng]
    return TG._build_epsl_sparse(Ai_nn, T, torch.float32, dev)[0], Ai_nn, ped_ids[ng]


def check_mme(torch, TG, TB, lay, counts, gen, dev, errs, nb=16):
    """The epsilon sweep at the main path's layout: its first ``nb`` blocks
    (the layout and vectors cut to them) and the whole sweep against the
    plain version (the effects at the kernel bar, the residual where the
    sweep leaves it), a bit-identical second launch, times, bounds, and
    torch.linalg.solve_triangular on block 0 (the one library call that
    computes a block's draws).  Returns (times, bounds)."""
    nbr, T, _ = lay.diag_blocks.shape
    qp = nbr * T
    f = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    x, b, z = 0.3 * f(qp), f(qp), f(qp)
    scale, ve = torch.tensor(0.7, device=dev), torch.tensor(1.3, device=dev)
    res = b - scale * TG._epsl_matvec(lay, x) - counts * x
    part = lay._replace(diag_blocks=lay.diag_blocks[:nb], blk_ptr=lay.blk_ptr[:nb + 1])
    cut = lambda v: v[:nb * T]
    runs = {nb: (part, cut(counts), scale, ve, cut(z), cut(x), res),
            nbr: (lay, counts, scale, ve, z, x, res)}
    worst = 0.0
    for k, args in runs.items():
        outs = [TB.mme_sweep(*args) for _ in range(2)]
        ref = TB.mme_sweep_plain(*args)
        torch.cuda.synchronize()
        what = f"mme_sweep over {k} of {nbr} blocks of {T}"
        xo, xr = outs[0][0].cpu().numpy(), ref[0].cpu().numpy()
        err = float(np.abs(xo - xr).max())
        if not err <= 5e-5 * float(np.abs(xr).max()):
            raise AssertionError(f"{what}: max |x| error {err}")
        ro, rr = outs[0][1].cpu().numpy(), ref[1].cpu().numpy()
        rerr = float(np.abs(ro - rr).max())
        if not rerr <= 1e-4 * float(np.abs(rr).max()) + 1e-6:
            raise AssertionError(f"{what}: max residual error {rerr}")
        if not all(torch.equal(a, c) for a, c in zip(*outs)):
            raise AssertionError(f"{what}: two runs differ (not deterministic)")
        worst = max(worst, err)
        log(f"  ok {what}: max |x| error {err:.3g}, residual {rerr:.3g}")
    errs["mme_sweep"] = worst
    t = {"mme_sweep": cuda_ms(torch, lambda: TB.mme_sweep(*runs[nb]), 20),
         "mme_sweep_plain": cuda_ms(torch, lambda: TB.mme_sweep_plain(*runs[nb]), 2),
         "mme_sweep_full": cuda_ms(torch, lambda: TB.mme_sweep(*runs[nbr]), 5)}
    # library yardstick: block 0's draws as one triangular solve,
    # tril(Wb) dx = r + diag(Wb) noise, unit diagonal on padded sites
    Wb, invd, noise = TB._block_constants(lay.diag_blocks[0].clone(), counts[:T], scale, ve,
                                          z[:T])
    ok = invd > 0
    L = torch.tril(Wb) + torch.diag((~ok).float())
    rhs = torch.where(ok, res[:T] + torch.diagonal(Wb) * noise, 0.0)[:, None]
    dx_lib = torch.linalg.solve_triangular(L, rhs, upper=False)[:, 0]
    dx_plain = TB.mme_block_draws_plain(Wb, res[:T], invd, noise)
    lib_err = float((dx_lib - dx_plain).abs().max())
    if not lib_err <= 1e-4 * float(dx_plain.abs().max()):
        raise AssertionError(f"solve_triangular off the block draws by {lib_err}")
    t["mme_library"] = cuda_ms(
        torch, lambda: torch.linalg.solve_triangular(L, rhs, upper=False), 200)
    log(f"  ok solve_triangular on block 0 (T={T}) matches the block draws to {lib_err:.3g}")

    # bounds: each input read once, each output written once.  The kernel
    # takes dense (T, T) diagonal blocks, as TPU kernel 10 does; the sweep's
    # own work is their nonzeros.  bound_ms counts the nonzeros, 8 bytes
    # each (value and in-block column, as for the triplets); the dense
    # layout's bound is printed beside it.
    def sweep_bound(k, dense):
        u1 = int(lay.blk_ptr[k])
        e1 = int(lay.row_ptr[u1])
        rows = int(torch.unique(lay.urow[:u1]).numel())
        D = lay.diag_blocks[:k]
        nz = int((D != 0).sum())                     # diagonal-block nonzeros
        nz_low = int((torch.tril(D, diagonal=-1) != 0).sum())
        by = ((k * T * T * 4 if dense else 8 * nz) + 4 * 4 * k * T  # blocks; counts, z, x, res
              + 4 * (k + 1) + 4 * 2 * u1 + 8 * e1       # blk_ptr, urow + row_ptr, entries
              + 4 * 2 * rows + 4 * k * T)               # forward rows read and written; x out
        # Wb and the site constants (the diagonal, 6 per site), 2 per
        # strictly lower entry of a block, per triplet and per draw
        low = k * T * (T - 1.0) / 2 if dense else nz_low
        flops = (k * T * T if dense else nz) + k * 8.0 * T + 2.0 * low + 2.0 * e1
        return bound(by, flops)

    bounds = {key: sweep_bound(k, False) for key, k in (("mme_sweep", nb),
                                                          ("mme_sweep_full", nbr))}
    bounds["mme_sweep_full_dense_layout"] = sweep_bound(nbr, True)
    log(f"  mme_sweep bounds over {nbr} blocks: nonzeros "
        f"{bounds['mme_sweep_full'][0]:.6g} ms, dense (T, T) layout "
        f"{bounds['mme_sweep_full_dense_layout'][0]:.6g} ms")
    return t, bounds


def check_sweep_ssbrm_shapes(torch, TG, TB, dev, gen, errs, n=10_000, B=64, nbg=16):
    """sweep_mc at the ssbrm path's shapes: float32 dosages (the imputed
    rows), B=64, n=10,000 rows (not padded), K=1, BayesCpi; held to the
    bar and timed beside its plain version.  Returns (times, bounds)."""
    X = 2.0 * torch.rand((n, nbg * B), generator=gen, device=dev)
    y = (X[:, :32] @ (0.1 * torch.randn(32, generator=gen, device=dev))
         + torch.randn(n, generator=gen, device=dev)).cpu().numpy()
    # the ssbrm path's rows are never padded (the epsilon term refuses pad_n)
    data = TG.prepare_gibbs_data(y, X, block=B, pad_n=False, device=dev)
    spec, pr, pi = make_spec(TG, "BayesCpi", data, nbg * B, n)
    args = sweep_args(torch, TG, spec, data, pr, pi, 1, seed=5)
    errs["sweep_mc"] = max(errs["sweep_mc"], bar(
        TB.sweep_mc_plain(spec, *args), TB.sweep_mc(spec, *args),
        "sweep_mc at the ssbrm shapes (f32, B=64, n=10,000)"))
    t = {"sweep_mc_ssbrm": cuda_ms(torch, lambda: TB.sweep_mc(spec, *args), 10),
         "sweep_mc_ssbrm_plain": cuda_ms(torch, lambda: TB.sweep_mc_plain(spec, *args), 1)}
    consts, X_b, W, xpx, vx, *per = args
    by = nbytes(X_b, W, xpx, vx, *per) + 4 * nbg * B * 3 + nbytes(per[7], per[8])
    return t, {"sweep_mc_ssbrm": bound(by, nbg * (4.0 * n * B + 2.0 * B * B))}


def profile_ssbrm(torch, TG, lay, Ai_nn, ng_ids, y_ids, n_g, m, gen, dev):
    """torch.profiler over iterations at the main path's shapes: n_g + ne
    rows of float32 dosages (random here), m SNPs in blocks of 64, the
    epsilon system of the main path.  Prints the split of an iteration's
    device time between sweep_mc, the epsilon sweep and the torch ops."""
    codes = np.flatnonzero(np.isin(ng_ids, y_ids))
    ne = len(codes)
    n = n_g + ne
    X = 2.0 * torch.rand((n, m), generator=gen, device=dev)
    y = torch.randn(n, generator=gen, device=dev).cpu().numpy()
    yJ = np.concatenate([-np.ones(n_g), -np.random.default_rng(1).random(ne)])
    data = TG.prepare_gibbs_data(y, X, epsl_yJ=yJ, epsl_A=Ai_nn, epsl_codes=codes,
                                 qe=Ai_nn.shape[0], block=64, device=dev)
    del X
    spec, pr, pi = make_spec(TG, "BayesCpi", data, m, n)
    spec = spec.__class__(**{**spec.__dict__, "ne": ne, "qe": Ai_nn.shape[0],
                             "qe_pad": int(data.epsl_counts.shape[0])})
    split = {}
    profile_iterations(torch, lambda st: TG.one_iteration(spec, data, 1, st),
                       TG.init_state(spec, data, pr, pi), "ssbrm", split=split)
    log(f"[profile ssbrm] split per iteration: sweep_mc {split['sweep_mc']:.3f} ms, "
        f"epsilon sweep {split['mme_sweep']:.3f} ms, torch ops {split['torch']:.3f} ms")
    return split


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--m", type=int, default=65_536)
    ap.add_argument("--niter", type=int, default=200)
    ap.add_argument("--nburn", type=int, default=100)
    ap.add_argument("--seed", type=int, default=2024)
    ap.add_argument("--sm", type=int, default=500_000, help="SNPs of the tiled sbrm path")
    ap.add_argument("--dm", type=int, default=32_768, help="SNPs of the dense sbrm path")
    ap.add_argument("--ss-ids", type=int, default=100_000,
                    help="pedigree ids of the ssbrm path (5%% founders, 20%% genotyped, "
                         "5%% + 5%% phenotyped)")
    ap.add_argument("--ss-m", type=int, default=100_000, help="SNPs of the ssbrm path")
    ap.add_argument("--mc-m", type=int, default=65_536,
                    help="SNPs of the multi-chain path (n=4,096)")
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
    errs.update(sweep_s_segment=0.0, sweep_s_tiled=0.0, sweep_mc_k=0.0,
                sweep_s_segment_k=0.0)
    nrej = check_s_kernels(torch, TG, TSG, TSLD, TB, dev, errs)
    check_kernels_mc(torch, TG, TB, dev, errs)
    check_segment_mc(torch, TG, TSG, TB, dev, errs)
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
    t_k5, b_k5 = time_k5(torch, TG, TB, dev, errs)
    times.update(t_k5)
    bounds.update(b_k5)
    log(f"[3] TPU kernels 8 and 2 at their own shapes (sweep_mc K=1 at n=131,072; K=64 "
        f"at n=4,096; 16 blocks of 128, int8): times (ms) on {smi}: {json.dumps(t_k5)}; "
        f"bounds {json.dumps(b_k5)}; kernel 1 is sweep_mc at K=1 at n={n_rows} "
        f"({times['sweep_mc']:.4f} ms, above)")

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
    del fit

    # ---- 4b. the flagship with 4 chains, to read R-hat ----
    split4 = profile_chains(torch, TG, TB, M, data["y"], 4, "BayesR", smi, B)
    flag = ibrm_chains(torch, hibayes_tpu_torch, TB, M, data, gv, "BayesR", 4, args.niter,
                       args.nburn, args.seed, smi, "4b", GEBV_CORR_MIN,
                       FLAGSHIP_CHAINS_CORR_MIN, RHAT_VE_MAX_FLAGSHIP, B)
    del M, data, gv
    torch.cuda.empty_cache()

    # ---- 4c. 64 chains at the TPU's multi-chain configuration ----
    t0 = time.perf_counter()
    M, data, gv = simulate(torch, 4096, args.mc_m, gen, dev)
    torch.cuda.synchronize()
    log(f"[4c] genotype {tuple(M.shape)} int8 made on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    split64 = profile_chains(torch, TG, TB, M, data["y"], 64, "BayesCpi", smi, B)
    mc64 = ibrm_chains(torch, hibayes_tpu_torch, TB, M, data, gv, "BayesCpi", 64, args.niter,
                       args.nburn, args.seed, smi, "4c", MC64_ACC_MIN, MC64_CHAINS_CORR_MIN,
                       RHAT_VE_MAX_MC64, B)
    del M, data, gv
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
    log(f"[5] draw chain alone, per block of {B} draws in one warp, on {smi}: BayesR "
        f"(4 folds) {times['chain_bayesr_us']:.3f} us ({times['chain_bayesr_cycles']:.0f} "
        f"cycles), BayesCpi {times['chain_bayescpi_us']:.3f} us "
        f"({times['chain_bayescpi_cycles']:.0f}), BayesCpi with the guard "
        f"{times['chain_bayescpi_guard_us']:.3f} us ({times['chain_bayescpi_guard_cycles']:.0f})")
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
                                      "tiled_sweep": niter_eff}, "5")
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

    # ---- 6b. the dense chain with 4 chains ----
    reset_counts(TB)
    fit = hibayes_tpu_torch.sbrm(ss, LD, method="BayesCpi", niter=args.niter,
                                 nburn=args.nburn, thin=thin, seed=args.seed,
                                 device=dev, nchains=4, verbose=False)
    torch.cuda.synchronize()
    d4_launches, plain = read_counts(TB)
    expect_counts(d4_launches, plain, {"sweep_s_segment": niter_eff,
                                       "segment_draws": niter_eff * nb_d,
                                       "segment_update": niter_eff * nb_d}, "6b")
    corr_d4 = check_fit(fit, b_true, "sbrm dense, 4 chains")
    if not np.isfinite(fit.MCMCsamples["alpha"]).all():
        raise AssertionError("sbrm dense, 4 chains: non-finite effects")
    log(f"[6b] sbrm BayesCpi dense m={args.dm}, 4 chains: Vg {fit.Vg:.4f} Ve {fit.Ve:.4f} "
        f"h2 {fit.h2:.4f}; R-hat Vg {fit.rhat['Vg']:.4f} Ve {fit.rhat['Ve']:.4f}; "
        f"corr(alpha, b_true) {corr_d4:.4f} (bar {SBAYES_CORR_MIN}); chain "
        f"{fit.chain_seconds:.2f} s = {1e3 * fit.chain_seconds / niter_eff:.2f} ms/iter, "
        f"{4 * niter_eff * args.dm / fit.chain_seconds:.4g} SNP-updates/s over 4 chains "
        f"on {smi}")
    if not corr_d4 >= SBAYES_CORR_MIN:
        raise AssertionError(f"sbrm dense 4-chain accuracy {corr_d4} below {SBAYES_CORR_MIN}")
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
    torch.cuda.empty_cache()

    # ---- 7. ssbrm: pedigree, imputation, epsilon Gibbs ----
    n_ids, ss_m = args.ss_ids, args.ss_m
    nfound, n_g, n_ph = n_ids // 20, n_ids // 5, n_ids // 20
    t0 = time.perf_counter()
    ids, sires, dams, s_par, d_par = make_pedigree(nfound, n_ids - nfound, args.seed)
    rng = np.random.default_rng(args.seed)
    gi = np.sort(rng.choice(n_ids, n_g, replace=False))
    others = np.setdiff1d(np.arange(n_ids), gi)
    phe = np.concatenate([rng.choice(gi, n_ph, replace=False),
                          rng.choice(others, n_ph, replace=False)])
    Mg, gv, depth = drop_genes(torch, nfound, s_par, d_par, ss_m, gi, gen, dev)
    y = (gv[torch.as_tensor(phe, device=dev)]
         + np.sqrt(0.5) * torch.randn(len(phe), generator=gen, device=dev)).cpu().numpy()
    torch.cuda.synchronize()
    log(f"[7] pedigree of {n_ids} ids ({nfound} founders, {depth} generations), genotype "
        f"{tuple(Mg.shape)} int8 dropped down it on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lay, Ai_nn, ng_ids = ssbrm_layout(torch, TG, ids, sires, dams, ids[gi], dev)
    qp = lay.diag_blocks.shape[0] * lay.diag_blocks.shape[1]
    codes = np.flatnonzero(np.isin(ng_ids, ids[phe]))
    counts = torch.as_tensor(np.bincount(codes, minlength=qp), dtype=torch.float32,
                             device=dev)
    log(f"[7] epsilon system: qe={Ai_nn.shape[0]} sites, A-inverse(nn) nnz {Ai_nn.nnz}, "
        f"{lay.diag_blocks.shape[0]} blocks of {lay.diag_blocks.shape[1]}, "
        f"{lay.ent_val.numel()} forward triplets on {lay.urow.numel()} rows "
        f"(host {time.perf_counter() - t0:.1f} s)")
    errs["mme_sweep"] = 0.0
    t_mme, b_mme = check_mme(torch, TG, TB, lay, counts, gen, dev, errs)
    t_sw, b_sw = check_sweep_ssbrm_shapes(torch, TG, TB, dev, gen, errs)
    times.update(t_mme, **t_sw)
    bounds.update(b_mme, **b_sw)
    log(f"[7] times (ms) on {smi}: {json.dumps({**t_mme, **t_sw})}; bounds "
        f"{json.dumps({**b_mme, **b_sw})}")
    profile_ssbrm(torch, TG, lay, Ai_nn, ng_ids, ids[phe], n_g, ss_m, gen, dev)
    del lay
    torch.cuda.empty_cache()

    # two small fits with one seed, then the direct path
    sids, ssir, sdam, _, _ = make_pedigree(150, 2850, args.seed + 1)
    srng = np.random.default_rng(args.seed + 1)
    sg = sids[np.sort(srng.choice(3000, 600, replace=False))]
    sM = torch.randint(0, 3, (600, 2048), generator=gen, device=dev, dtype=torch.int8)
    sphe = sids[srng.choice(3000, 900, replace=False)]
    skw = dict(data={"id": sphe, "y": srng.normal(size=900)}, M=sM, M_id=sg,
               pedigree={"id": sids, "sire": ssir, "dam": sdam}, niter=30, nburn=10,
               seed=args.seed, device=dev, verbose=False)
    small = [hibayes_tpu_torch.ssbrm("y ~ 1", impute="pcg", chunk_cols=512, **skw)
             for _ in range(2)]
    if not (np.array_equal(small[0].g["gebv"], small[1].g["gebv"])
            and small[0].Veps == small[1].Veps):
        raise AssertionError("two ssbrm fits with one seed differ: not reproducible")
    direct = hibayes_tpu_torch.ssbrm("y ~ 1", impute="direct", **skw)
    if not (np.isfinite(direct.g["gebv"]).all() and np.isfinite(direct.Veps)):
        raise AssertionError("the direct-path ssbrm fit is not finite")
    log(f"[7] two small ssbrm fits (3,000 ids, m=2048, pcg) with one seed are "
        f"bit-identical; the direct path runs (Veps {direct.Veps:.4f})")

    reset_counts(TB)
    t0 = time.perf_counter()
    fit = hibayes_tpu_torch.ssbrm(
        "y ~ 1", data={"id": ids[phe], "y": y}, M=Mg, M_id=ids[gi],
        pedigree={"id": ids, "sire": sires, "dam": dams}, method="BayesCpi",
        niter=args.niter, nburn=args.nburn, thin=thin, impute="pcg", chunk_cols=2048,
        seed=args.seed, device=dev, printfreq=50)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    e_launches, plain = read_counts(TB)
    nb_e = -(-ss_m // 64)
    expect_counts(e_launches, plain, {"sweep_mc": niter_eff, "mme_sweep": niter_eff,
                                      "mme_sweep_kernel": niter_eff,
                                      "rows_kernel": niter_eff * (nb_e + 1),
                                      "draws_kernel": niter_eff * nb_e}, "7")
    gebv = dict(zip(fit.g["id"], fit.g["gebv"]))
    if len(gebv) != n_ids or not np.isfinite(fit.g["gebv"]).all():
        raise AssertionError("GEBV of the wrong count or not finite")
    for k in ("Veps", "J", "Vg", "Ve", "h2"):
        if not np.isfinite(getattr(fit, k)):
            raise AssertionError(f"ssbrm: {k} is not finite")
    if not 0.0 < fit.h2 < 1.0:
        raise AssertionError(f"ssbrm: h2 {fit.h2} outside (0, 1)")
    ng_phe = np.setdiff1d(phe, gi)
    gv_np = gv.cpu().numpy()
    corr_s = float(np.corrcoef([gebv[i] for i in ids[ng_phe]], gv_np[ng_phe])[0, 1])
    corr_g = float(np.corrcoef([gebv[i] for i in ids[gi]], gv_np[gi])[0, 1])
    setup = fit.setup_seconds
    log(f"[7] ssbrm BayesCpi {n_ids} ids x m={ss_m}: Vg {fit.Vg:.4f} Ve {fit.Ve:.4f} "
        f"Veps {fit.Veps:.4f} J {fit.J:.4f} h2 {fit.h2:.4f}; GEBV corr with the truth "
        f"{corr_s:.4f} on the {len(ng_phe)} non-genotyped phenotyped (bar "
        f"{SSBRM_CORR_MIN}), {corr_g:.4f} on the {n_g} genotyped")
    log(f"[7] wall {wall:.2f} s; set-up (s) pedigree {setup['pedigree']:.2f}, imputation "
        f"{setup['imputation']:.2f}, prepare {setup['prepare']:.2f}; chain "
        f"{fit.chain_seconds:.2f} s = {1e3 * fit.chain_seconds / niter_eff:.2f} ms/iter, "
        f"{niter_eff * ss_m / fit.chain_seconds:.4g} SNP-updates/s on {smi}")
    if not corr_s >= SSBRM_CORR_MIN:
        raise AssertionError(f"ssbrm accuracy {corr_s} below {SSBRM_CORR_MIN}")
    del Mg, fit

    # ---- 8. results ----
    src = "hibayes_tpu_torch/csrc/blockgibbs.cu"
    ssrc = "hibayes_tpu_torch/csrc/sgibbs.cu"

    def entry(name, source, replaces, n_launch, err, key, library_ms=None, **extra):
        b_ms, b_by = bounds[key]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n_launch, "max_abs_err": err, "ms": times[key],
                "plain_ms": times[key + "_plain"], "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": library_ms, **extra}

    l64 = mc64["launches"]
    kernels = [
        entry("rows_mc_kernel", src, "hibayes_tpu/ops/blockgibbs.py:318",
              l64["rows_mc_kernel"], errs["sweep_mc_k"], "sweep_mc_k2",
              library_ms=times["sweep_mc_k2_library"], sweep_mc_launches=l64["sweep_mc"],
              draws_kernel_launches=l64["draws_kernel"], timed="sweep_mc at K=64, n=4,096",
              flagship_4_chains_rows_mc_launches=flag["launches"]["rows_mc_kernel"],
              flagship_4_chains_ms=times["sweep_mc_k4"],
              flagship_4_chains_bound_ms=bounds["sweep_mc_k4"][0],
              k64_split_ms=split64, flagship_4_chains_split_ms=split4,
              flagship_4_chains_library_ms=times["sweep_mc_k4_library"],
              k64_block_split_us=times["sweep_mc_k2_split"],
              flagship_4_chains_block_split_us=times["sweep_mc_k4_split"],
              chain_us_per_block={"BayesR_4_folds": times["chain_bayesr_us"],
                                  "BayesCpi": times["chain_bayescpi_us"]}),
        entry("sweep_mc_k1_for_kernel1", src, "hibayes_tpu/ops/blockgibbs.py:138",
              launches["sweep_mc"], errs["sweep_mc"], "sweep_mc",
              timed=f"sweep_mc at K=1, n={n_rows} (as row 3)"),
        entry("sweep_mc_k1_for_kernel8", src, "hibayes_tpu/ops/blockgibbs.py:1371",
              launches["sweep_mc"], errs["sweep_mc_k8"], "sweep_mc_k8",
              timed="sweep_mc at K=1, n=131,072"),
        entry("sweep_mc", src, "hibayes_tpu/ops/blockgibbs.py:642", launches["sweep_mc"],
              errs["sweep_mc"], "sweep_mc", rows_kernel_launches=launches["rows_kernel"],
              ssbrm_launches=e_launches["sweep_mc"], ssbrm_ms=times["sweep_mc_ssbrm"],
              ssbrm_plain_ms=times["sweep_mc_ssbrm_plain"],
              ssbrm_bound_ms=bounds["sweep_mc_ssbrm"][0]),
        entry("draws_kernel", src, "hibayes_tpu/ops/blockgibbs.py:1264",
              launches["draws_kernel"], errs["block_draws"], "block_draws",
              segment_4_chains_draws_launches=d4_launches["segment_draws"]),
        entry("sweep_s_segment", ssrc, "hibayes_tpu/ops/blockgibbs.py:1141",
              d_launches["sweep_s_segment"], errs["sweep_s_segment"], "sweep_s_segment",
              segment_draws_launches=d_launches["segment_draws"],
              segment_update_launches=d_launches["segment_update"],
              k4_launches=d4_launches["sweep_s_segment"],
              k4_max_abs_err=errs["sweep_s_segment_k"], k4_ms=times["sweep_s_segment_k4"]),
        entry("sweep_s_tiled", ssrc, "hibayes_tpu/ops/blockgibbs.py:1635",
              s_launches["sweep_s_tiled"], errs["sweep_s_tiled"], "sweep_s_tiled",
              tiled_sweep_launches=s_launches["tiled_sweep"],
              full_sweep_ms=times["sweep_s_tiled_full"],
              full_sweep_bound_ms=bounds["sweep_s_tiled_full"][0],
              full_sweep_split=times["sweep_s_tiled_split"],
              chain_us_per_block={"BayesCpi": times["chain_bayescpi_us"],
                                  "BayesCpi_guard": times["chain_bayescpi_guard_us"]}),
        entry("mme_sweep", "hibayes_tpu_torch/csrc/mme.cu", "hibayes_tpu/ops/blockgibbs.py:1805",
              e_launches["mme_sweep"], errs["mme_sweep"], "mme_sweep",
              library_ms=times["mme_library"], full_sweep_ms=times["mme_sweep_full"],
              full_sweep_bound_ms=bounds["mme_sweep_full"][0],
              full_sweep_dense_layout_bound_ms=bounds["mme_sweep_full_dense_layout"][0]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
