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
     The SBayesS guard on the segment sweep (BayesCpi and BayesR, K=1 and
     K=4, on a pruned m=1,000 LD, at the chain's vary and at a lowered
     vary where it rejects; its counts equal the plain version's) and the
     tiled sweep at tile 64 for all six models (and BayesCpi at a lowered
     vary).  The K-chain tiled sweep at K=4 (a drawer CTA a chain, each
     tile read once for all chains) for all six models at tiles of 128 and
     64, the guard on, and BayesCpi and BayesR at a lowered vary where it
     rejects (each chain's counts equal the plain version's); the K-chain
     epsilon sweep at K=4 (a CTA a chain) on a 3,000-id pedigree's layout;
     each chain of both bit for bit its K=1 launch.  The shapes the kernels
     do not take as they are: sweep_mc and block_draws at blocks of 30,
     192, 250 and 256 (run as sub-blocks of at most 128, pad slots at 30
     and 250) and at 12 and 16 BayesR folds (the draw chain's run-time
     fold instance), the dense segment sweep at those blocks, the guarded
     segment and tiled sweeps at 12 and 16 folds, and the tiled sweep on
     stores of tiles of 10 and 256 (re-tiled to 12 and 128), one chain
     and four.  The concurrent schedule's one-card emulation at
     emulate_shards=4, merge_rounds=2 (8 sweep_mc launches a sweep at their
     block ranges) against the same emulation through the plain sweep, K in
     {1, 4} x {int8, f32} x {BayesCpi, BayesR}.
     Bar: at most 1% mixture draws flip, effects within 5e-5 max|g| where
     the draws agree, residuals (r_hat) within 1e-4 max|.| when none flips;
     a second kernel sweep on the same inputs must be bit-identical.  Then
     two small ibrm fits with one seed must agree bit for bit; then each
     kernel is held to the bar and timed beside its plain version at its
     main path's shapes, and sweep_mc at TPU kernels 8's and 2's own shapes
     (K=1 at n=131,072; K=64 at n=4,096, with torch.matmul of its two
     products as the library yardstick, and so at phase 4b's K=4); each
     sweep's time split per block from its timer stamps (K >= 2: rows
     launch, W and row loads, wait, reduction of the partials, draw chain;
     one chain, the persistent sweep1 launch: the drawer's wait for the
     partials and for W, the chain, the hand-offs and the rows CTAs' work);
     the draw chain alone per block of 128, in us and cycles a draw (BayesR
     with 4 folds here, BayesCpi with and without the guard in phase 5),
     the floor of every sweep; the K=4 tiled and epsilon sweeps at their
     main paths' shapes (phases 5 and 7), timed beside K=1;
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
     sweep_s_segment only (one persistent segment_sweep launch a sweep;
     timed at one and 4 chains beside torch.mv / torch.mm of the update's
     whole product, its time split per block from its stamps), then (6b)
     the same fit with nchains=4 through the K-chain segment sweep, then
     method="CG" on the same LD against a direct solve on the card;
  7. ssbrm main path (the configuration of benchmarks/ssbrm_100k_pedigree.py
     with m=100,000 SNPs): a 100,000-id pedigree (5,000 founders, parents
     of each offspring drawn among all earlier ids), 20,000 genotyped,
     5,000 genotyped and 5,000 non-genotyped phenotyped; genotypes dropped
     down the pedigree on the card, h2=0.5 from 500 causal SNPs.  Checks
     the epsilon sweep kernel against its plain version on the main path's
     layout (qe=80,000 sites, blocks of 64; its first 16 blocks and the
     whole sweep, a bit-identical second launch; torch.linalg.solve_triangular
     on one block as the library yardstick; timed with the L2 warm and
     cold, split per block from its stamps, the layout's rows by target
     block, and the epsilon chain alone in cycles a draw) and sweep_mc at f32, B=64,
     n=10,000; a torch.profiler split of an iteration at the main path's
     shapes; two small ssbrm fits with one seed bit-identical and a small
     direct-path fit; then hibayes_tpu_torch.ssbrm(impute="pcg",
     method="BayesCpi"), niter=200, nburn=100, thin=5, through sweep_mc and
     mme_sweep only, with its set-up split, finite GEBV of all 100,000 ids,
     Veps and J, 0 < h2 < 1, and the GEBV accuracy of the non-genotyped
     phenotyped ids against the truth;
  8. the README quick start from PLINK files: a cohort of n=50,000 x
     m=65,536 (16 chromosomes of 4,096 SNPs, LD decaying along each: every
     haplotype a Markov chain; h2=0.5 from 500 causal SNPs, a covariate and
     a 20-level factor) made on the card and written with encode_bed_bytes
     (.bed 0.82 GB, .bim, .fam, .phe) into a directory under build/ that is
     removed at the end; read_plink (the decode path, seconds and GB/s
     printed; bit for bit the written genotype) and read_pheno; ibrm("y ~
     x1 + (1|grp)", method="BayesCpi", map=, windsize=1e6) through sweep1
     only, its GEBV accuracy against its bar; the cohort's marginal
     regressions (y adjusted for the covariate and the factor) written as a
     COJO .ma and read back with read_sumstat; ldmat on the card as a
     BlockDiagLD (ldchr=False), a TiledSparseLD (chisq 30, tiled, tile 64,
     per chromosome, the device path) and a SparseLD of chromosome 1 (chisq
     30; its dense float64 store is m^2, 34 GB at the whole m), each with
     its seconds, and the exact int8 Gram of one chromosome timed against
     the int8 peak; the guarded segment sweep (one and 4 chains) and the
     tile-64 tiled sweep against their plain versions at these shapes and
     timed; sbrm BayesCpi on each layout through the kernels only (one
     segment_sweep a chromosome and iteration, one tiled_sweep an
     iteration), finite Vg/Ve, 0 < h2 < 1, the accuracy of X alpha against
     the simulated genetic values (chromosome 1's part for the SparseLD),
     and the guard's counts (first draws rejected, all 8 candidates failed);
  9. checkpoints, the command line and BSLMM.  (9a) on the first 4
     chromosomes of phase 8's fileset (written again on their own),
     ``python -m hibayes_tpu_torch ibrm`` (the quick start's call, 400
     iterations, --checkpoint, --quiet) in a subprocess, killed with SIGKILL
     once its checkpoint is past burn-in and run again: its TSVs byte for
     byte those of an uninterrupted ibrm in this process (through sweep1
     only), each process's read_plink seconds and the resumed chain's
     ms/iter printed; a kill that races the end of the chain fails.  (9b)
     ibrm("y ~ x1 + (1|grp)", method="BSLMM") at n=20,000 x m=65,536 (int8,
     rows not padded), one chain: sweep1 against its plain version at
     these shapes first; the GRM's exact int8 product (TOP/s against the
     int8 peak), make_grm and its eigh, and the polygenic block's three
     n x n products timed on their own; the fit through sweep1 only, Va and
     Vb, and its GEBV accuracy against its bar.  (9c) a resume on each
     engine at small sizes (an ibrm batch of 4, sbrm on a tiled LD, sbrm on
     a BlockDiagLD batch of 4 with the guard firing, ssbrm): killed after a
     checkpoint past burn-in and run again, bit for bit the uninterrupted
     run, each iteration's kernels launched once over the two runs;
 10. chain batches of ssbrm and of sbrm on tiled LD, each run beside the
     phase whose data it reuses.  (10b, after phase 5) sbrm(method=
     "BayesCpi", nchains=4) on phase 5's m=500,000 tiled LD: one K-chain
     tiled_sweep launch an iteration and no plain call, each chain's guard
     counts, each chain's and the pooled accuracy against b_true, R-hat(Vg),
     ms/iter beside phase 5's.  (10a, after phase 7) ssbrm(impute="pcg",
     method="BayesCpi", chunk_cols=2048, nchains=4) on phase 7's cohort
     (its imputation redone): through sweep_mc's K-chain rows and draws
     kernels and one K-chain mme_sweep_kernel launch an iteration only,
     every chain finite, R-hat(Ve), the GEBV agreement of chains 0 and 1,
     the pooled accuracy, the pooled Veps against phase 7's one chain,
     ms/iter and the set-up split.  (10c, in 9c) an
     ssbrm batch of 4 and a tiled-LD batch of 4 killed and resumed bit for
     bit;
 11. every block, fold count, tile and chain count.  (11a, after phase 4)
     ibrm BayesR on phase 4's cohort at blocks of 256 and (11b) with 12
     folds for 50 iterations, each through sweep1 only, its sweep timed
     beside its plain version first, GEBV accuracy against its bar and
     ms/iter beside phase 4's; (11c, after 10b) sbrm BayesCpi on phase 5's
     statistics with the LD stored in tiles of 256 and re-tiled, through
     one tiled_sweep launch an iteration, accuracy against phase 5's bar;
     (11d) 160 chains of that fit, 20 iterations, in groups of chains (a
     launch each), each group's first chain bit for bit its K=1 launch;
     (11e, in phase 7) where 10a's K=4 iteration spends its time by CUDA
     time (hibayes_tpu_torch.utils.device_trace and annotate), and (in 9c)
     each resume's checkpoint saves timed by PhaseTimer;
 12. multi-GPU (hibayes_tpu_torch.parallel).  (In phase 5) the tiled sweep
     at a row_base: every shard of 2 and of 4 of a 64-row store against
     the plain version at the bar, bit-identical twice, timed, and shard 1
     of 2 of phase 5's store timed.  (12a, after 9c) the flagship with 4
     chains and the ring pipeline emulated on 4 shards: one sweep (16
     sweep1 launches) whose group 0 is held to the one-device K=1 sweep,
     then ibrm(nchains=4, shard_schedule="pipeline", emulate_shards=4) for
     50 iterations, each chain's GEBV accuracy against phase 4's bar.
     (12b) two ranks spawned here (NCCL with a card each where there are
     two, else gloo with both on cuda:0, time-slicing it), each running
     rank12: (vi) its rows of 9a's fileset by load_plink_host_sharded,
     bit for bit the whole read's; (i) the flagship on (1, 2), turn: one
     iteration at the bar against one device, then phase 4's recipe
     through ibrm(mesh=) with its GEBV bar; (ii) on (2, 1), the ind hybrid:
     one iteration at the bar, ms/iter; (iii) 4 chains on (1, 2), the ring
     pipeline: one iteration bit for bit 12a's emulation at 2 shards,
     ms/iter; (iv) phase 5's LD recipe (m rounded up to even tile rows) on
     (1, 2) through the tiled sweep at each rank's row_base: one sweep at
     the bar with equal guard counts, then sbrm(mesh=) with phase 5's
     accuracy bar; (v) a small ssbrm (the epsilon term on) on both meshes,
     3 iterations, finite Ve.  Each run prints ms/iter and its share in
     collectives; each kernel of each run must launch; a failed rank
     fails the run.
 13. the relaxed concurrent shard schedule.  (13b, in 12b's spawn) (vii)
     the flagship on (1, 2), concurrent, one merge round: one iteration
     bit for bit the one-card emulation at 2 shards (made before the
     spawn), 10 iterations timed; (viii) a 64-row store of phase 5's recipe
     swept on (1, 2) in 2 merge rounds (kernel 9 at each rank's row_base
     + r nl/2), at the bar against the same rounds through the plain
     sweep, guard counts equal, bit-identical twice; then sbrm(mesh=,
     shard_schedule="concurrent", merge_rounds=2) on (iv)'s m=500,224 LD
     with phase 5's accuracy bar.  (13a, after 12b) on the flagship cohort
     of phase 12: (i) one sweep emulated on 4 shards (four sweep1 launches
     of 128 blocks): group 0 bit for bit the one-device sweep's first
     16,384 SNPs, group 1 at the bar against its plain version, the merged
     yadj against the recomputed residual, bit-identical twice; (ii)
     ibrm(shard_schedule="concurrent", emulate_shards=4) with phase 4's
     recipe: the m > n warning caught, sweep1 4 times an iteration,
     ms/iter, the GEBV's correlation with 12b(i)'s exact chain and its
     accuracy against its bar; (iii) the same with 4 chains and 2 merge
     rounds for 50 iterations, each chain's accuracy.  Each phase-13 run's
     kernels must launch as the schedule says.  Then a JSON line of
     kernels, each phase's seconds and the whole run's (phase 13's
     printed apart), the nvidia-smi line, and the last line {"ok": true,
     "device": {...}}.

Any failed check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
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
# Phase 10a, ssbrm with 4 chains on phase 7's cohort: each chain is phase
# 7's recipe (accuracy 0.708 on the non-genotyped phenotyped on an H100),
# so the pooled accuracy keeps SSBRM_CORR_MIN.  As in phase 4c, m = 100,000
# SNPs against n = 10,000 records lets the chains sit apart in Ve over 20
# records each, so R-hat(Ve) bounds divergence at 4c's bar.  Two chains'
# posterior-mean GEBV, each over 20 records, differ by Monte-Carlo error;
# the gate reads the 25,000 ids with a genotype or a record (an id with
# neither has an epsilon drawn from the pedigree's prior alone, whose
# 20-record mean is mostly noise; printed beside it).  0.9 sits below two
# sound chains and above a chain that sweeps against the wrong system.
RHAT_VE_MAX_SSBRM_CHAINS = 2.5
SSBRM_CHAINS_CORR_MIN = 0.9
# Phase 10a's pooled Veps against phase 7's one chain on the same cohort.
# Split R-hat cannot gate J or Veps here: over 20 records a chain the JAX
# package's own ssbrm(nchains=4) reads R-hat of J 2.96-3.40 and of Veps
# 2.53-3.77 on a small cohort of this shape (scripts/chain_mixing.py
# ssbrm_reference; the port 2.79-5.07 and 2.60-4.90), and this phase 2.70
# and 2.04.  The fault study (chain_mixing.py fault 10a: each chain's
# epsilon swept once against another chain's residual) leaves R-hat(Ve)
# and the chains' agreement above their bars (1.25-1.31, 0.905-0.929) but
# doubles the pooled Veps (0.531-0.533 against 0.233 sound, two seeds);
# a sound batch read 0.98 of phase 7's one chain.  0.25 sits between.
SSBRM_CHAINS_VEPS_REL_MAX = 0.25
# Phase 10b, sbrm with 4 chains on phase 5's tiled LD: each chain is phase
# 5's recipe (accuracy 0.787 on an H100), so each chain's and the pooled
# accuracy keep SBAYES_CORR_MIN.  Its Ve sits at the negative-Ve guard's
# 0.5 Vg (SBAYES_CORR_MIN's note), so R-hat(Vg), over 20 records a chain,
# bounds divergence at the bar of phase 4c.
RHAT_MAX_TILED_CHAINS = 2.5
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (hopper-kernels guide)
F32_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores

MODELS = ["BayesRR", "BayesA", "BayesBpi", "BayesCpi", "BayesL", "BayesR"]


# Phase 8, the README quick start.  The cohort's haplotypes copy the
# previous SNP's allele with probability QS_RHO, so r decays as about
# 0.9^d along a chromosome; at n = 50,000 the chi-square rule r^2 n > 30
# (the JAX package's LD benchmark's, benchmarks/ldmat_tiled_200k.py) keeps
# SNPs up to about 35 apart and lets a null pair through with probability
# 4e-8 (under one a chromosome of 4,096 SNPs).
QS_RHO = 0.9
QS_CHISQ = 30.0

# Accuracy bars of the quick start: ibrm's GEBV accuracy measured 0.982 on
# an H100 (500 causal SNPs at n = 50,000, as phase 4, here with LD and
# blocks of 64); sbrm's accuracy of X alpha against the simulated genetic
# values 0.972 on the BlockDiagLD and 0.969 on the tile-64 TiledSparseLD
# (the statistics are the cohort's own marginal regressions, the LD its
# own, so the summary fit is nearly the individual one), 0.966 for
# chromosome 1's SparseLD against chromosome 1's part of g (about 31 causal
# SNPs: fewer effects, a noisier correlation; 0.949 on another cohort of
# the same recipe).  The chains are
# deterministic for a seed; 0.9, 0.9 and 0.85 leave room for another
# card's rounding, and a sweep that draws against the wrong LD rows or
# guard rows falls far below.
QS_GEBV_CORR_MIN = 0.9
QS_SBRM_CORR_MIN = {"blockdiag": 0.9, "sparse": 0.85, "tiled": 0.9}


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
    return (M, *phenotype(torch, M, gen, dev, n_causal)[:2])


def phenotype(torch, M, gen, dev, n_causal=500):
    """y = gv + 0.3 x1 + grp + e for a genotype M on the card, h2 = 0.5 from
    n_causal SNPs.  Returns (the ibrm data dict, gv, the causal SNPs and
    their effects b: gv = M[:, causal] b - mean)."""
    n, m = M.shape
    causal = torch.randperm(m, generator=gen, device=dev)[:n_causal]
    b = torch.randn(causal.numel(), generator=gen, device=dev)
    gv = M[:, causal].float() @ b
    sd = gv.std()
    gv = (gv - gv.mean()) / sd * np.sqrt(0.5)
    x1 = torch.randn(n, generator=gen, device=dev)
    grp = torch.randint(0, 20, (n,), generator=gen, device=dev)
    grp_eff = 0.3 * torch.randn(20, generator=gen, device=dev)
    y = gv + 0.3 * x1 + grp_eff[grp] + np.sqrt(0.5) * torch.randn(n, generator=gen, device=dev)
    data = {"id": np.array([f"id{i}" for i in range(n)]), "y": y.cpu().numpy(),
            "x1": x1.cpu().numpy(),
            "grp": np.array([f"g{k}" for k in grp.cpu().numpy()])}
    return data, gv, causal, b / sd * np.sqrt(0.5)


def make_spec(TG, model, data, m, n_real, niter=10, nburn=5, nf=4):
    """The spec, priors and pi of one chain (BayesR with nf folds, whose
    variances are the data's)."""
    if model == "BayesR":
        pi = fold_prior(nf)[0]
    else:
        nf = 2
        pi = (np.array([0.0, 1.0]) if model in ("BayesRR", "BayesA", "BayesL")
              else np.array([0.95, 0.05]))
    vx = data.vx.cpu().numpy()
    pr = TG.resolve_priors(data.y[:n_real].cpu().numpy(), float(vx.sum()), pi[0], nr=0)
    spec = TG.GibbsSpec(
        model=model, n=int(data.y.shape[0]), n_real=n_real, m=m,
        m_pad=int(data.xpx.shape[0]), block=data.block,
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
            data.X_blocks, g[:, None], torch.float32, data.block)[:, 0])
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


def cold_ms(torch, fn, reps, flush_bytes=128 << 20):
    """Device ms per call of ``fn`` with a cold L2, as the chain finds it
    after another kernel has streamed its data: before each call a buffer
    larger than the card's 50 MB L2 is overwritten, then the device sleeps
    while the host enqueues the call, and CUDA events time the call alone;
    the mean over ``reps`` calls."""
    buf = torch.empty(flush_bytes // 4, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    ev = []
    for _ in range(reps):
        buf.fill_(1.0)
        torch.cuda._sleep(2_000_000)
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        ev.append((t0, t1))
    torch.cuda.synchronize()
    return float(np.mean([a.elapsed_time(b) for a, b in ev]))


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
    """Where a sweep's time goes, per block (us, means over the blocks),
    from its timer stamps (sweep_mc(stamps=...)).  One chain (the persistent
    sweep1 launch, its right-hand side one block ahead): the chain side, the
    draw chain and dg_b's publication, the drawer's wait after it for block
    b+1's summed partials (and C_{b+1}), the matvec C_{b+1} dg_b that
    completes rhs_{b+1},
    its own row work, the start of chain b+1 (W_{b+1} and rhs_{b+1} read);
    the drawer's summing warps' wait for block b+1's flags and their sum;
    the first rows CTA's start after dg_b is published (the hand-off), its
    row work (the correction yadj += X_b dg_b, then the partials of
    X_{b+2}), the hand-off of its partials to the drawer's sum; the row side
    (dg_b published to block b+2's partials summed) against the block's
    period (dg_b to dg_{b+1}).
    K >= 2 chains: the rows launch from its start to its wait (its first X
    chunks in flight, then the draws before it) and on to its end; the
    draws launch's W and packed-row load, its wait for the rows launch (the
    other rows CTAs and the hand-off), the reduction of the partials, the
    draw chain; the block's period; and the rows CTA's first chunk: its
    wait for the chunk and the barrier, the next chunk's copies issued, the
    residual update, the second barrier, the partials."""
    st = torch.zeros(16 * (nbg + 1), dtype=torch.int64, device=part[2].device)
    TB.sweep_mc(*part, block_range=(0, nbg), stamps=st)
    torch.cuda.synchronize()
    s = st.view(nbg + 1, 16).cpu().numpy().astype(np.float64)
    b, nxt = s[:nbg] / 1e3, s[1:] / 1e3
    mean = lambda x: round(float(np.mean(x)), 3)
    if part[-2].shape[0] == 1:
        a, c = b[:-1], b[1:]        # blocks with a next block: b and b + 1
        r = s[1:nbg - 1] / 1e3      # row steps that form partials (of block b + 1)
        return {"chain_us": mean(b[:, 3] - b[:, 2]),
                "chain_draws_us": mean(b[:, 6] - b[:, 2]),
                "publish_us": mean(b[:, 3] - b[:, 6]),
                "drawer_wait_after_chain_us": mean(a[:, 15] - a[:, 3]),
                "rhs_matvec_us": mean(a[:, 7] - a[:, 15]),
                "drawer_own_rows_us": mean(b[:, 4] - b[:, 7]),
                "next_chain_start_us": mean(c[:, 2] - a[:, 4]),
                "sums_flags_wait_us": mean(a[:, 5] - a[:, 0]),
                "sums_us": mean(a[:, 14] - a[:, 5]),
                "dg_to_rows_start_us": mean(nxt[:, 9] - b[:, 3]),
                "rows_work_us": mean(nxt[:, 10] - nxt[:, 9]),
                "rows_correction_us": mean(nxt[:, 11] - nxt[:, 9]),
                "rows_partials_us": mean(nxt[:, 10] - nxt[:, 11]),
                "rows_partials_formed_us": mean(r[:, 12] - r[:, 11]),
                "rows_partials_summed_us": mean(r[:, 13] - r[:, 12]),
                "rows_publish_us": mean(r[:, 10] - r[:, 13]),
                "rows_to_partials_summed_us": mean(r[:, 14] - r[:, 10]),
                "row_side_us": mean(b[1:-1, 14] - b[:-2, 3]),
                "block_period_us": mean(np.diff(b[:, 3]))}
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


def mme_split(torch, TB, args):
    """Where the one-CTA epsilon sweep's time goes, per block (us, means
    over the blocks), from its clock64 stamps (mme_sweep(stamps=...)),
    converted with its own %globaltimer: the drawer's chain, its sums of
    the block's terms to the next block's rows, its wait at the phase's
    barrier (for the other warps) until the next chain starts; when the
    scatter of a block's other terms, warp 3's residual load and the
    loader's staging end, after the chain of their phase starts (negative:
    before; the scatter of block b runs in phase b + 1); the period."""
    nbr = args[0].diag_blocks.shape[0]
    st = torch.zeros(6 * (nbr + 1) + 4, dtype=torch.int64, device=args[-1].device)
    TB.mme_sweep(*args, stamps=st)
    torch.cuda.synchronize()
    s = st.cpu().numpy().astype(np.float64)
    e = 6 * (nbr + 1)
    ns_per_cycle = (s[e + 1] - s[e]) / (s[e + 3] - s[e + 2])
    b = s[:6 * nbr].reshape(nbr, 6) * ns_per_cycle / 1e3
    mean = lambda x: round(float(np.mean(x)), 4)
    return {"chain_us": mean(b[:, 1] - b[:, 0]),
            "near_terms_us": mean(b[:, 2] - b[:, 1]),
            "drawer_wait_us": mean(b[1:, 0] - b[:-1, 2]),
            "scatter_end_after_chain_start_us": mean(b[:-1, 3] - b[1:, 0]),
            "residual_load_end_after_chain_start_us": mean(b[:, 4] - b[:, 0]),
            "staging_end_after_chain_start_us": mean(b[:, 5] - b[:, 0]),
            "block_us": mean(np.diff(b[:, 0])),
            "sweep_ms": round((s[e + 1] - s[e]) / 1e6, 4),
            "sm_clock_ghz": round(1.0 / ns_per_cycle, 3)}


def segment_split(torch, TB, spec, seg, r, P):
    """Where the persistent segment sweep's time goes, per block (us, means
    over the blocks), from its clock64 stamps (sweep_s_segment(stamps=...)):
    the first drawer CTA's chain up to the barrier after it (dg published,
    the next block staged; of it the first warp's draws, its dg stores and
    flag, the wait for the others and the staging), the issue of the next
    block's copies, its own contribution to the next block (the
    Gram block's scaling and the sums), its wait for the next block's row
    owners, the snapshot's load; the first row-owner CTA's pass over the
    block once dg is seen (of it: dg into shared memory, its first warp's
    wait for its tile and that tile's sums) and its wait for the next
    block's dg; the period."""
    nb = seg.shape[0] // spec.block
    st = torch.zeros(12 * nb + 4, dtype=torch.int64, device=seg.device)
    TB.sweep_s_segment(spec, seg, r, P, spec.n, stamps=st)
    torch.cuda.synchronize()
    s = st.cpu().numpy().astype(np.float64)
    e = 12 * nb
    ns_per_cycle = (s[e + 1] - s[e]) / (s[e + 3] - s[e + 2])
    b = s[:e].reshape(nb, 12) * ns_per_cycle / 1e3
    mean = lambda x: round(float(np.mean(x)), 4)
    return {"chain_us": mean(b[:, 1] - b[:, 0]),
            "draws_us": mean(b[:, 10] - b[:, 0]),
            "draws_to_published_us": mean(b[:, 11] - b[:, 10]),
            "published_to_barrier_us": mean(b[:, 1] - b[:, 11]),
            "next_block_issue_us": mean(b[1:, 0] - b[:-1, 4]),
            "own_contribution_us": mean(b[:-1, 2] - b[:-1, 1]),
            "owners_wait_us": mean(b[:-1, 3] - b[:-1, 2]),
            "snapshot_us": mean(b[:-1, 4] - b[:-1, 3]),
            "owner_pass_us": mean(b[:, 6] - b[:, 5]),
            "owner_dg_load_us": mean(b[:, 7] - b[:, 5]),
            "owner_tile_wait_us": mean(b[:, 8] - b[:, 7]),
            "owner_tile_sums_us": mean(b[:, 9] - b[:, 8]),
            "owner_dg_wait_us": mean(b[1:, 5] - b[:-1, 6]),
            "block_us": mean(np.diff(b[:, 0])),
            "sweep_ms": round((s[e + 1] - s[e]) / 1e6, 4),
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
    # and at K=1 (rows 1, 3, 4, 5 of PERF.md's table): torch.mv of X_b' r
    # and X_b dg per block on a float32 copy of the int8 blocks
    t["sweep_mc_library"] = cuda_ms(torch, mv_products(torch, Xf, per[7][0], B), 10)
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


def mv_products(torch, Xf, r, B):
    """The one-chain sweep's two products per block as torch.mv calls,
    X_b' r (n -> B) and X_b dg (B -> n), on float32 blocks Xf (nbg, n, B):
    the library yardstick of the fused one-chain sweep (no PyTorch call
    computes its draws)."""
    dg = 0.01 * torch.ones(B, device=Xf.device)

    def products():
        for b in range(Xf.shape[0]):
            torch.mv(Xf[b].T, r)
            torch.mv(Xf[b], dg)

    return products


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


class plain_route:
    """Within it ``TB.<name>`` is its plain version, so a schedule built on
    the wrapper (an emulation, a mesh's rounds) runs its plain counterpart
    on the same tensors: only to hold a kernel path against it."""

    def __init__(self, TB, name):
        self.TB, self.name = TB, name

    def __enter__(self):
        self.real = getattr(self.TB, self.name)
        setattr(self.TB, self.name, getattr(self.TB, self.name + "_plain"))

    def __exit__(self, *exc):
        setattr(self.TB, self.name, self.real)


def check_concurrent_emulation(torch, TG, TB, dev, errs, n=4096, m=1024, B=128, S=4, Rm=2):
    """The concurrent schedule's one-card emulation at emulate_shards=4,
    merge_rounds=2 (8 groups of one block, each a sweep_mc launch at its
    block_range from the round-start residual, the deltas merged) against
    the same emulation through the plain sweep: K in {1, 4} x {int8, f32}
    x {BayesCpi, BayesR}, each at the bar, bit-identical on a second run,
    S Rm sweep_mc launches a sweep (sweep1 at K=1)."""
    gen = torch.Generator(device=dev).manual_seed(27)
    M = make_genotype(torch, n, m, gen, dev)
    y = (M[:, :64].float() @ (0.1 * torch.randn(64, generator=gen, device=dev))
         + torch.randn(n, generator=gen, device=dev)).cpu().numpy()
    errs["concurrent_emulation"] = 0.0
    for x_int8 in (True, False):
        for model in ("BayesCpi", "BayesR"):
            fold = np.array([0.0, 1e-4, 1e-3, 1e-2]) if model == "BayesR" else None
            data = TG.prepare_gibbs_data(
                y, M if x_int8 else M.float(), block=B, fold=fold,
                geno_dtype="int8" if x_int8 else None, device=dev)
            spec, pr, pi = make_spec(TG, model, data, m, n)
            spec = spec.__class__(**{**spec.__dict__, "shard_schedule": "concurrent",
                                     "emulate_shards": S, "merge_rounds": Rm})
            for K in (1, 4):
                args = sweep_args(torch, TG, spec, data, pr, pi, K, seed=30 + K)
                reset_counts(TB)
                out = TG._sweep_concurrent_emu_mc(spec, *args)
                torch.cuda.synchronize()
                launches = read_counts(TB)[0]
                again = TG._sweep_concurrent_emu_mc(spec, *args)
                with plain_route(TB, "sweep_mc"):
                    ref = TG._sweep_concurrent_emu_mc(spec, *args)
                torch.cuda.synchronize()
                what = (f"concurrent emulation S={S} Rm={Rm} {model} "
                        f"{'int8' if x_int8 else 'f32'} K={K}")
                errs["concurrent_emulation"] = max(errs["concurrent_emulation"],
                                                   bar(ref, out, what))
                if not all(torch.equal(a, b) for a, b in zip(out, again)):
                    raise AssertionError(f"{what}: two runs differ (not deterministic)")
                want = {"sweep_mc": S * Rm, **({"sweep1": S * Rm} if K == 1 else {})}
                if any(launches[k] != v for k, v in want.items()):
                    raise AssertionError(f"{what}: launches {launches}, expected {want}")
                log(f"  ok {what}")


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
        t["sweep_mc_" + key + "_split"] = sweep_split(torch, TB, spec, (spec, *args), nbg)
        t["sweep_mc_" + key + "_plain"] = cuda_ms(torch, lambda: TB.sweep_mc_plain(spec, *args), 1)
        bounds["sweep_mc_" + key] = sweep_bound(args, B)
        if K == 1:
            Xf = data.X_blocks.float()
            t["sweep_mc_k8_library"] = cuda_ms(torch, mv_products(torch, Xf, args[12][0], B), 10)
            del Xf
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


def s_setup(torch, TG, TSG, ss, ld, model, block, dev, sparse, nf=4):
    """Data, spec, priors and pi of one summary chain, as sbrm builds them
    (BayesR with nf folds)."""
    if model == "BayesR":
        pi, fold = fold_prior(nf)
    else:
        fold = np.array([0.0, 1.0])
        pi = (np.array([0.0, 1.0]) if model in ("BayesRR", "BayesA", "BayesL")
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


def pruned_ld(torch, TLD, m, dev, rho=0.9, width=24):
    """SparseLD of rho^|i-j| with the entries farther than ``width`` from
    the diagonal zeroed (its nonzeros per column), values on the card."""
    LD = ar1_ld(torch, m, dev, rho)
    i = torch.arange(m, device=dev)
    far = (i[:, None] - i[None, :]).abs() > width
    LD[far] = 0.0
    return TLD.SparseLD(values=LD, nnz_col=(~far).sum(0).cpu().numpy())


def guarded_case(torch, TSG, TB, spec, seg, g, r, P, what, errs, key, expect_fire):
    """One guarded segment sweep (one chain, or K with a leading axis)
    against its plain version: the bar, a bit-identical second launch, the
    guard's counts (first draws rejected, candidates exhausted) equal to
    the plain version's, and for K chains each chain bit for bit its K=1
    launch.  Returns the counts."""
    lead = tuple(r.shape[:-1])
    tal = [torch.zeros(lead + (2,), dtype=torch.int64, device=r.device) for _ in range(3)]
    outs = [TB.sweep_s_segment(spec, seg, r, P, spec.n, tally=tal[i]) for i in range(2)]
    ref = TB.sweep_s_segment_plain(spec, seg, r, P, spec.n, tally=tal[2])
    torch.cuda.synchronize()
    errs[key] = max(errs[key], bar((g - ref[0], ref[1], ref[2]),
                                   (g - outs[0][0], outs[0][1], outs[0][2]), what, r_index=2))
    if not all(torch.equal(a, b) for a, b in zip(*outs)):
        raise AssertionError(f"{what}: two runs differ (not deterministic)")
    if not (torch.equal(tal[0], tal[1]) and torch.equal(tal[0], tal[2])):
        raise AssertionError(f"{what}: guard counts {tal[0].tolist()}, again "
                             f"{tal[1].tolist()}, plain {tal[2].tolist()}")
    counts = tal[0].reshape(-1, 2).sum(0).tolist()
    if expect_fire and counts[0] == 0:
        raise AssertionError(f"{what}: the guard did not fire")
    for k in range(lead[0] if lead else 0):
        one = TB.sweep_s_segment(spec, seg, r[k], P[k], spec.n)
        if not all(torch.equal(a[k], b) for a, b in zip(outs[0], one)):
            raise AssertionError(f"{what}: chain {k} differs from its K=1 launch")
    log(f"  ok {what}: guard counts per chain {tal[0].reshape(-1, 2).tolist()} "
        f"(first draws rejected, all 8 candidates failed)")
    return counts


def check_guard_kernels(torch, TG, TSG, TLD, TSLD, TB, dev, errs, m=1000, K=4):
    """The new instances of this port's summary sweeps against their plain
    versions: the guarded segment sweep (SBayesS semantics on a pruned
    LD, B=64) for BayesCpi and BayesR at K=1 and K=4, at the chain's vary
    and at a lowered vary where the guard rejects (counted), each chain of
    K=4 bit for bit its K=1 launch; and the tiled sweep at tile 64 (16
    tile rows of a 5-tile band, masked slots) for all six models, the guard
    on for BayesCpi and BayesR, and at a lowered vary for BayesCpi.
    Returns the guard counts of the lowered-vary cases."""
    gen = torch.Generator(device=dev).manual_seed(19)
    sld = pruned_ld(torch, TLD, m, dev)
    ss, _ = summary_stats(torch, lambda v: sld.values @ v, m, m, gen, dev)
    fired = {}
    for model in ("BayesCpi", "BayesR"):
        data, spec0, pr, pi = s_setup(torch, TG, TSG, ss, sld, model, 64, dev, True)
        seg = data.ld_segs[0]
        ins = [s_sweep_inputs(torch, TSG, spec0, data, pr, pi, lambda v: seg @ v, seed=30 + k)
               for k in range(K)]
        for vary in (None, 2e-4):
            spec = spec0 if vary is None else spec0.__class__(**{**spec0.__dict__, "vary": vary})
            for kc in (1, K):
                g, r, P = ins[0] if kc == 1 else (torch.stack(x) for x in zip(*ins))
                what = (f"sweep_s_segment guarded {model} K={kc}"
                        + ("" if vary is None else f" vary={vary}"))
                c = guarded_case(torch, TSG, TB, spec, seg, g, r, P, what, errs,
                                 "sweep_s_segment_guard", vary is not None)
                if vary is not None:
                    fired[what] = c
    tld = banded_ld(torch, TSLD, m, dev, T=64, K=5)
    ss_t, _ = summary_stats(torch, tiled_matvec(torch, tld), m, tld.m_pad, gen, dev)
    for model in MODELS:
        for vary in ((None, 2e-4) if model == "BayesCpi" else (None,)):
            data, spec, pr, pi = s_setup(torch, TG, TSG, ss_t, tld, model, 64, dev, True)
            if vary is not None:
                spec = spec.__class__(**{**spec.__dict__, "vary": vary})
            args = (data.ld_tiles, data.ld_cols, data.ld_valid)
            g, r, P = s_sweep_inputs(torch, TSG, spec, data, pr, pi, tiled_matvec(torch, tld),
                                     seed=7)
            tal = [torch.zeros(2, dtype=torch.int64, device=dev) for _ in range(3)]
            outs = [TB.sweep_s_tiled(spec, *args, r, P, spec.n, tally=tal[i]) for i in range(2)]
            ref = TB.sweep_s_tiled_plain(spec, *args, r, P, spec.n, tally=tal[2])
            torch.cuda.synchronize()
            what = f"sweep_s_tiled tile 64 {model}" + ("" if vary is None else f" vary={vary}")
            errs["sweep_s_tiled64"] = max(errs["sweep_s_tiled64"], bar(
                (g - ref[0], ref[1], ref[2]), (g - outs[0][0], outs[0][1], outs[0][2]),
                what, r_index=2))
            if not all(torch.equal(a, b) for a, b in zip(*outs)):
                raise AssertionError(f"{what}: two runs differ (not deterministic)")
            if not (torch.equal(tal[0], tal[1]) and torch.equal(tal[0], tal[2])):
                raise AssertionError(f"{what}: guard counts {tal[0].tolist()}, plain "
                                     f"{tal[2].tolist()}")
            if vary is not None:
                if int(tal[0][0]) == 0:
                    raise AssertionError(f"{what}: the guard did not fire")
                fired[what] = tal[0].tolist()
            log(f"  ok {what} ({tld.nbr} tile rows, guard "
                f"{'on' if TB.guard_on(spec) else 'off'}, counts {tal[0].tolist()})")
    return fired


def check_tiled_mc(torch, TG, TSG, TSLD, TB, dev, errs, K=4, m=1000):
    """The K-chain tiled sweep (one launch: a drawer CTA a chain, each tile
    read once for all chains) at K=4 against its plain version, all six
    models at tiles of 128 and 64 (8 and 16 tile rows of a 5-tile band,
    masked slots), the guard on for BayesCpi and BayesR, and BayesCpi and
    BayesR at a lowered vary where it rejects: each chain at the bar, its
    guard counts equal to the plain version's, each chain bit for bit its
    K=1 launch, a second launch bit-identical.  Returns the lowered-vary
    cases' counts per chain."""
    gen = torch.Generator(device=dev).manual_seed(23)
    fired = {}
    for T in (128, 64):
        tld = banded_ld(torch, TSLD, m, dev, T=T, K=5)
        mv = tiled_matvec(torch, tld)
        ss_t, _ = summary_stats(torch, mv, m, tld.m_pad, gen, dev)
        for model in MODELS:
            data, spec0, pr, pi = s_setup(torch, TG, TSG, ss_t, tld, model, T, dev, True)
            ins = [s_sweep_inputs(torch, TSG, spec0, data, pr, pi, mv, seed=40 + k)
                   for k in range(K)]
            g, r, P = (torch.stack(x) for x in zip(*ins))
            lay = (data.ld_tiles, data.ld_cols, data.ld_valid)
            low = (None, 2e-4) if model in ("BayesCpi", "BayesR") else (None,)
            for vary in low:
                spec = (spec0 if vary is None
                        else spec0.__class__(**{**spec0.__dict__, "vary": vary}))
                what = (f"sweep_s_tiled K={K} tile {T} {model}"
                        + ("" if vary is None else f" vary={vary}"))
                tal = [torch.zeros((K, 2), dtype=torch.int64, device=dev) for _ in range(3)]
                outs = [TB.sweep_s_tiled(spec, *lay, r, P, spec.n, tally=tal[i])
                        for i in range(2)]
                ref = TB.sweep_s_tiled_plain(spec, *lay, r, P, spec.n, tally=tal[2])
                torch.cuda.synchronize()
                errs["sweep_s_tiled_k"] = max(errs["sweep_s_tiled_k"], bar(
                    (g - ref[0], ref[1], ref[2]), (g - outs[0][0], outs[0][1], outs[0][2]),
                    what, r_index=2))
                if not all(torch.equal(a, b) for a, b in zip(*outs)):
                    raise AssertionError(f"{what}: two runs differ (not deterministic)")
                if not (torch.equal(tal[0], tal[1]) and torch.equal(tal[0], tal[2])):
                    raise AssertionError(f"{what}: guard counts {tal[0].tolist()}, plain "
                                         f"{tal[2].tolist()}")
                for k in range(K):
                    one = TB.sweep_s_tiled(spec, *lay, r[k], P[k], spec.n)
                    if not all(torch.equal(a[k], b) for a, b in zip(outs[0], one)):
                        raise AssertionError(f"{what}: chain {k} differs from its K=1 launch")
                if vary is not None:
                    if int(tal[0][:, 0].sum()) == 0:
                        raise AssertionError(f"{what}: the guard did not fire")
                    fired[what] = tal[0].tolist()
                log(f"  ok {what} ({tld.nbr} tile rows; each chain bit for bit its K=1 "
                    f"launch; guard {'on' if TB.guard_on(spec) else 'off'}, counts per "
                    f"chain {tal[0].tolist()})")
    return fired


def mme_chains_inputs(torch, TG, lay, counts, gen, dev, K):
    """K chains' inputs of an epsilon sweep over layout ``lay``: each its own
    x, right-hand side, normals, scale and ve, and the residual
    b - (scale A + diag(counts)) x.  Returns (scale, ve, z, x, res)."""
    qp = lay.diag_blocks.shape[0] * lay.diag_blocks.shape[1]
    f = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    x, b, z = 0.3 * f(K, qp), f(K, qp), f(K, qp)
    kf = torch.arange(K, device=dev, dtype=torch.float32)
    scale, ve = 0.7 * (1 + 0.2 * kf), 1.3 * (1 + 0.3 * kf)
    res = b - scale[:, None] * TG._epsl_matvec(lay, x) - counts * x
    return scale, ve, z, x, res.contiguous()


def check_mme_case(torch, TB, args, what, errs, key):
    """One K-chain epsilon sweep against its plain version: the effects of
    every chain at the kernel bar (5e-5 of max |x|), the residual at 1e-4;
    a second launch bit-identical; each chain bit for bit its K=1 launch."""
    lay, counts, scale, ve, z, x, res = args
    outs = [TB.mme_sweep(*args) for _ in range(2)]
    ref = TB.mme_sweep_plain(*args)
    torch.cuda.synchronize()
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
    for k in range(x.shape[0]):
        one = TB.mme_sweep(lay, counts, scale[k], ve[k], z[k], x[k], res[k])
        if not (torch.equal(outs[0][0][k], one[0]) and torch.equal(outs[0][1][k], one[1])):
            raise AssertionError(f"{what}: chain {k} differs from its K=1 launch")
    errs[key] = max(errs[key], err)
    log(f"  ok {what}: max |x| error {err:.3g}, residual {rerr:.3g}; each chain bit for "
        f"bit its K=1 launch")


def check_mme_mc(torch, TG, TB, dev, errs, K=4):
    """The K-chain epsilon sweep (one launch, a CTA a chain) at K=4 on a
    small pedigree layout (3,000 ids, 600 genotyped: 2,400 sites in blocks
    of 64, RCM order) against its plain version (check_mme_case)."""
    gen = torch.Generator(device=dev).manual_seed(29)
    ids, sires, dams, _, _ = make_pedigree(150, 2850, 29)
    geno = ids[np.sort(np.random.default_rng(29).choice(3000, 600, replace=False))]
    lay, Ai_nn, _ = ssbrm_layout(torch, TG, ids, sires, dams, geno, dev)
    nbr, T, _ = lay.diag_blocks.shape
    q = Ai_nn.shape[0]
    codes = np.random.default_rng(30).choice(q, 900)
    counts = torch.as_tensor(np.bincount(codes, minlength=nbr * T), dtype=torch.float32,
                             device=dev)
    args = (lay, counts) + mme_chains_inputs(torch, TG, lay, counts, gen, dev, K)
    check_mme_case(torch, TB, args, f"mme_sweep K={K} over {nbr} blocks of {T} "
                   f"({q} sites)", errs, "mme_sweep_k")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def time_tiled(torch, TSG, TB, spec, data, pr, pi, ld, errs, rows=16, key="sweep_s_tiled",
               K=None):
    """The tiled sweep at the main path's shapes: the first ``rows`` tile rows
    (slots past them masked), kernel against plain, held to the bar (into
    ``errs[key]``) and timed; and the kernel over every tile row.  With
    ``K``, the same at K chains (phase 10b's batch; each chain bit for bit
    its K=1 launch; into ``errs[key + "_k"]``), timed beside K=1.  Returns
    (times, bounds)."""
    T = spec.block
    g, r, P = s_sweep_inputs(torch, TSG, spec, data, pr, pi, tiled_matvec(torch, ld), 9)
    mp = rows * T
    sub = spec.__class__(**{**spec.__dict__, "m": mp, "m_pad": mp, "seg_sizes": (mp,),
                            "seg_real": (mp,)})
    cols = data.ld_cols[:rows].contiguous()
    args = (data.ld_tiles[:rows], cols, data.ld_valid[:rows] & (cols < rows),
            r[:mp].contiguous(), P[:, :mp].contiguous(), spec.n)
    out, ref = TB.sweep_s_tiled(sub, *args), TB.sweep_s_tiled_plain(sub, *args)
    errs[key] = max(errs[key], bar(
        (g[:mp] - ref[0], ref[1], ref[2]), (g[:mp] - out[0], out[1], out[2]),
        f"sweep_s_tiled at the main path's shapes ({rows} rows of {T})", r_index=2))
    full = (data.ld_tiles, data.ld_cols, data.ld_valid, r, P, spec.n)
    # the BayesCpi draw chain alone, with and without the guard, on the
    # first tile row's Gram block and rows
    B = T
    Wn = spec.n * data.ld_tiles[0, 0]
    Pg = P[:, :B].T.contiguous()
    chain = {"chain_bayescpi_guard": chain_us(torch, TB, spec, Wn, Pg, r[:B], spec.vary),
             "chain_bayescpi": chain_us(torch, TB, spec, Wn,
                                        Pg[:, :TB.n_rows(spec)].contiguous(), r[:B])}
    # the library yardstick: every slot's product tiles[i, k]^T dg_i of these
    # rows as one torch.bmm (the sweep's products without its sequence)
    Kt = args[0].shape[1]
    tl = args[0].reshape(rows * Kt, T, T)
    dgv = out[0].reshape(rows, 1, 1, T).expand(rows, Kt, 1, T).reshape(rows * Kt, 1, T)
    t = {"sweep_s_tiled": cuda_ms(torch, lambda: TB.sweep_s_tiled(sub, *args), 10),
         "sweep_s_tiled_library": cuda_ms(torch, lambda: torch.bmm(dgv, tl), 10),
         "sweep_s_tiled_plain": cuda_ms(torch, lambda: TB.sweep_s_tiled_plain(sub, *args), 1),
         "sweep_s_tiled_full": cuda_ms(torch, lambda: TB.sweep_s_tiled(spec, *full), 3),
         "sweep_s_tiled_full_host": host_ms(torch, lambda: TB.sweep_s_tiled(spec, *full)),
         "sweep_s_tiled_split": tiled_split(torch, TB, spec, full)}
    for k, (us, cyc) in chain.items():
        t[k + "_us"], t[k + "_cycles"] = us, cyc

    def bounds_at(kc, a):
        # the tiles once; each chain's r_hat and packed rows read, its
        # r_hat, dg and track written, its guard counts; each chain's
        # products (the tiles' and the diagonal tiles' draws)
        n_rows, nv, mpad = a[0].shape[0], int(a[2].sum()), a[3].shape[-1]
        b = nv * T * T * 4 + nbytes(*a[1:5]) + kc * (4 * mpad * 3 + 4 * n_rows)
        return bound(b, kc * 2.0 * T * T * (nv + n_rows))

    bnd = {"sweep_s_tiled": bounds_at(1, args), "sweep_s_tiled_full": bounds_at(1, full)}
    if K:
        ins = [s_sweep_inputs(torch, TSG, spec, data, pr, pi, tiled_matvec(torch, ld), 9 + k)
               for k in range(K)]
        gK, rK, PK = (torch.stack(x) for x in zip(*ins))
        kargs = args[:3] + (rK[:, :mp].contiguous(), PK[:, :, :mp].contiguous(), spec.n)
        kfull = full[:3] + (rK, PK, spec.n)
        out, ref = TB.sweep_s_tiled(sub, *kargs), TB.sweep_s_tiled_plain(sub, *kargs)
        errs[key + "_k"] = max(errs[key + "_k"], bar(
            (gK[:, :mp] - ref[0], ref[1], ref[2]), (gK[:, :mp] - out[0], out[1], out[2]),
            f"sweep_s_tiled K={K} at the main path's shapes ({rows} rows of {T})",
            r_index=2))
        for k in range(K):
            one = TB.sweep_s_tiled(sub, *kargs[:3], kargs[3][k], kargs[4][k], spec.n)
            if not all(torch.equal(a[k], b) for a, b in zip(out, one)):
                raise AssertionError(f"sweep_s_tiled K={K}: chain {k} differs from its K=1 "
                                     f"launch at the main path's shapes")
        kk = f"sweep_s_tiled_k{K}"
        dgK = out[0].reshape(K, rows, 1, T).permute(1, 2, 0, 3).expand(rows, Kt, K, T)
        dgK = dgK.reshape(rows * Kt, K, T)
        t.update({kk: cuda_ms(torch, lambda: TB.sweep_s_tiled(sub, *kargs), 10),
                  kk + "_library": cuda_ms(torch, lambda: torch.bmm(dgK, tl), 10),
                  kk + "_plain": cuda_ms(torch, lambda: TB.sweep_s_tiled_plain(sub, *kargs), 1),
                  kk + "_full": cuda_ms(torch, lambda: TB.sweep_s_tiled(spec, *kfull), 3),
                  kk + "_full_host": host_ms(torch, lambda: TB.sweep_s_tiled(spec, *kfull)),
                  kk + "_split": tiled_split(torch, TB, spec, kfull)})
        bnd[kk] = bounds_at(K, kargs)
        bnd[kk + "_full"] = bounds_at(K, kfull)
        log(f"  ok sweep_s_tiled K={K} at the main path's shapes: each chain bit for bit its "
            f"K=1 launch; full sweep K={K} {t[kk + '_full']:.4f} ms against K=1 "
            f"{t['sweep_s_tiled_full']:.4f} ms")
    return t, bnd


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
    # library yardstick: the update's whole product as one call, n LD dg
    # (torch.mv; torch.mm for the 4 chains), on the sweep's own dg
    dg1, dg4 = out[0], outs[0][0]
    lib = (torch.mv(seg, dg1), torch.mm(seg, dg4.T))
    torch.cuda.synchronize()
    if not (torch.isfinite(lib[0]).all() and torch.isfinite(lib[1]).all()):
        raise AssertionError("torch.mv of the segment is not finite")
    t = {"sweep_s_segment_k4": cuda_ms(
             torch, lambda: TB.sweep_s_segment(spec, seg, r4, P4, spec.n), 3),
         "sweep_s_segment": cuda_ms(torch, lambda: TB.sweep_s_segment(spec, seg, r, P, spec.n), 3),
         "sweep_s_segment_host": host_ms(
             torch, lambda: TB.sweep_s_segment(spec, seg, r, P, spec.n)),
         "sweep_s_segment_plain": cuda_ms(
             torch, lambda: TB.sweep_s_segment_plain(spec, seg, r, P, spec.n), 1),
         "sweep_s_segment_library": cuda_ms(torch, lambda: torch.mv(seg, dg1), 5),
         "sweep_s_segment_k4_library": cuda_ms(torch, lambda: torch.mm(seg, dg4.T), 5),
         "sweep_s_segment_split": segment_split(torch, TB, spec, seg, r, P),
         "sweep_s_segment_k4_split": segment_split(torch, TB, spec, seg, r4, P4)}
    mc, B = seg.shape[0], spec.block
    b = nbytes(seg, r, P) + 4 * mc * 3
    b4 = nbytes(seg, r4, P4) + 4 * 4 * mc * 3
    return t, {"sweep_s_segment": bound(b, 2.0 * mc * mc + 2.0 * B * mc),
               "sweep_s_segment_k4": bound(b4, 4 * (2.0 * mc * mc + 2.0 * B * mc))}


# ---------------------------------------------------------------------------
# the README quick start (phase 8)
# ---------------------------------------------------------------------------


def ld_genotype(torch, n, m, nchr, gen, dev, rho=QS_RHO):
    """(n, m) int8 genotypes with LD that decays along each of nchr equal
    chromosomes: each of an individual's two haplotypes is a Markov chain
    along its chromosome, SNP j keeping SNP j - 1's allele with
    probability rho and else drawing a fresh one, A1 with probability
    p_j ~ U(0.05, 0.5) (so r between SNPs d apart is about rho^d).  Made on
    the card, all chromosomes and both haplotypes a step at a time."""
    mc = m // nchr
    p = (torch.rand(m, generator=gen, device=dev) * 0.45 + 0.05).view(nchr, mc)
    M = torch.empty((n, nchr, mc), dtype=torch.int8, device=dev)
    h = torch.rand((2, n, nchr), generator=gen, device=dev) < p[:, 0]
    M[:, :, 0] = h.sum(0)
    for j in range(1, mc):
        keep = torch.rand((2, n, nchr), generator=gen, device=dev) < rho
        fresh = torch.rand((2, n, nchr), generator=gen, device=dev) < p[:, j]
        h = torch.where(keep, h, fresh)
        M[:, :, j] = h.sum(0)
    return M.view(n, m)


def write_fileset(Mh, data, nchr, stem, encode_bed_bytes, threads=8, chunk=2048):
    """<stem>.bed/.bim/.fam of the genotype Mh (numpy int8, n x m; the
    .bed encoded by encode_bed_bytes in column chunks on ``threads``
    threads: each SNP's bytes stand alone) and <stem>.phe (id y x1 grp)."""
    from concurrent.futures import ThreadPoolExecutor

    n, m = Mh.shape
    mc = m // nchr
    with ThreadPoolExecutor(threads) as ex, open(stem + ".bed", "wb") as f:
        f.write(b"\x6c\x1b\x01")
        for part in ex.map(lambda c: encode_bed_bytes(Mh[:, c:c + chunk])[3:],
                           range(0, m, chunk)):
            f.write(part)
    with open(stem + ".bim", "w") as f:
        f.write("".join(f"{1 + j // mc}\trs{j}\t0\t{1000 * (1 + j % mc)}\tA\tG\n"
                        for j in range(m)))
    with open(stem + ".fam", "w") as f:
        f.write("".join(f"{i}\t{i}\t0\t0\t1\t-9\n" for i in data["id"]))
    with open(stem + ".phe", "w") as f:
        f.write("id y x1 grp\n")
        f.write("".join(f"{i} {float(y)!r} {float(x)!r} {g}\n"
                        for i, y, x, g in zip(data["id"], data["y"], data["x1"], data["grp"])))


def marginal_stats(torch, M, y, snps, chunk=4096):
    """The cohort's marginal regressions of y on each SNP (float64 on the
    card): the COJO columns SNP A1 A2 MAF BETA SE P NMISS as a dict."""
    n, m = M.shape
    yc = torch.as_tensor(y - y.mean(), dtype=torch.float64, device=M.device)
    yy = float(yc @ yc)
    beta, se, maf = (torch.empty(m, dtype=torch.float64, device=M.device) for _ in range(3))
    for c0 in range(0, m, chunk):
        X = M[:, c0:c0 + chunk].double()
        s = X.sum(0)
        sxx = (X * X).sum(0) - s * s / n
        sxy = X.T @ yc
        beta[c0:c0 + chunk] = sxy / sxx
        se[c0:c0 + chunk] = torch.sqrt((yy - sxy * sxy / sxx) / (n - 2) / sxx)
        f = s / (2 * n)
        maf[c0:c0 + chunk] = torch.minimum(f, 1 - f)
    p = torch.special.erfc((beta / se).abs() / np.sqrt(2.0))
    return {"SNP": snps, "A1": np.full(m, "A"), "A2": np.full(m, "G"),
            "MAF": maf.cpu().numpy(), "BETA": beta.cpu().numpy(), "SE": se.cpu().numpy(),
            "P": p.cpu().numpy(), "NMISS": np.full(m, float(n))}


def write_ma(path, st):
    with open(path, "w") as f:
        f.write(" ".join(st) + "\n")
        cols = [st[k] for k in st]
        f.write("".join(" ".join(v if isinstance(v, str) else repr(float(v)) for v in row)
                        + "\n" for row in zip(*cols)))


def predict(torch, M, alpha, chunk=8192):
    """M alpha on the card (M int8 on the card, alpha numpy)."""
    a = torch.as_tensor(alpha, dtype=torch.float32, device=M.device)
    out = torch.zeros(M.shape[0], dtype=torch.float32, device=M.device)
    for c0 in range(0, M.shape[1], chunk):
        out += M[:, c0:c0 + chunk].float() @ a[c0:c0 + chunk]
    return out


def corr(a, b) -> float:
    return float(np.corrcoef(np.asarray(a, np.float64), np.asarray(b, np.float64))[0, 1])


def time_guarded_segment(torch, TSG, TB, spec, data, pr, pi, errs):
    """The guarded segment sweep over phase 8's first chromosome block
    (B=64), one chain and 4, held to the bar and timed beside its plain
    version and torch.mv / torch.mm of the update's whole product on the
    sweep's own dg.  Returns (times, bounds)."""
    seg = data.ld_segs[0]
    mc = seg.shape[0]
    sub = spec.__class__(**{**spec.__dict__, "m_pad": mc, "seg_sizes": (mc,),
                            "seg_real": (spec.seg_real[0],)})
    mv = segments_matvec(torch, data, spec)
    ins = [s_sweep_inputs(torch, TSG, spec, data, pr, pi, mv, 40 + k) for k in range(4)]
    ins = [(g[:mc], r[:mc].contiguous(), P[:, :mc].contiguous()) for g, r, P in ins]
    g, r, P = ins[0]
    g4, r4, P4 = (torch.stack(x) for x in zip(*ins))
    guarded_case(torch, TSG, TB, sub, seg, g, r, P,
                 f"sweep_s_segment guarded at phase 8's shapes (m={mc}, B=64)", errs,
                 "sweep_s_segment_guard", False)
    guarded_case(torch, TSG, TB, sub, seg, g4, r4, P4,
                 f"sweep_s_segment guarded K=4 at phase 8's shapes (m={mc}, B=64)", errs,
                 "sweep_s_segment_guard", False)
    dg1 = TB.sweep_s_segment(sub, seg, r, P, sub.n)[0]
    dg4 = TB.sweep_s_segment(sub, seg, r4, P4, sub.n)[0]
    t = {"seg_guard": cuda_ms(torch, lambda: TB.sweep_s_segment(sub, seg, r, P, sub.n), 10),
         "seg_guard_plain": cuda_ms(
             torch, lambda: TB.sweep_s_segment_plain(sub, seg, r, P, sub.n), 1),
         "seg_guard_k4": cuda_ms(torch, lambda: TB.sweep_s_segment(sub, seg, r4, P4, sub.n), 10),
         "seg_guard_k4_plain": cuda_ms(
             torch, lambda: TB.sweep_s_segment_plain(sub, seg, r4, P4, sub.n), 1),
         "seg_guard_library": cuda_ms(torch, lambda: torch.mv(seg, dg1), 10),
         "seg_guard_k4_library": cuda_ms(torch, lambda: torch.mm(seg, dg4.T), 10),
         "seg_guard_split": segment_split(torch, TB, sub, seg, r, P)}
    B = sub.block
    return t, {"seg_guard": bound(nbytes(seg, r, P) + 4 * mc * 3, 2.0 * mc * mc + 2.0 * B * mc),
               "seg_guard_k4": bound(nbytes(seg, r4, P4) + 4 * 4 * mc * 3,
                                     4 * (2.0 * mc * mc + 2.0 * B * mc))}


def check_sweep_qs(torch, TG, TB, dev, M, y, errs, B=64, nbg=16, key="sweep_mc_qs",
                   pad_n="auto", label="phase 8's ibrm"):
    """sweep_mc at the shapes an ibrm call gives it: the int8 genotype's
    first nbg blocks of B=64 SNPs, all its rows (padded as ibrm pads them,
    or with ``pad_n=False`` not, as BSLMM's ibrm keeps them), K=1,
    BayesCpi; held to the bar (into ``errs[key]``), bit-identical on a
    second launch, and timed beside its plain version.  Returns (times,
    bounds)."""
    n = M.shape[0]
    data = TG.prepare_gibbs_data(y, M[:, :nbg * B], block=B, geno_dtype="int8", pad_n=pad_n,
                                 device=dev)
    spec, pr, pi = make_spec(TG, "BayesCpi", data, nbg * B, n)
    args = sweep_args(torch, TG, spec, data, pr, pi, 1, seed=6)
    out, again = (TB.sweep_mc(spec, *args) for _ in range(2))
    what = f"sweep_mc at {label} shapes (int8, B={B}, n={spec.n}, {nbg} blocks)"
    errs[key] = max(errs[key], bar(TB.sweep_mc_plain(spec, *args), out, what))
    if not all(torch.equal(a, b) for a, b in zip(out, again)):
        raise AssertionError(f"{what}: two runs differ (not deterministic)")
    log(f"  ok {what}")
    t = {key: cuda_ms(torch, lambda: TB.sweep_mc(spec, *args), 10),
         key + "_plain": cuda_ms(torch, lambda: TB.sweep_mc_plain(spec, *args), 1)}
    consts, X_b, W, xpx, vx, *per = args
    by = nbytes(X_b, W, xpx, vx, *per) + 4 * nbg * B * 3 + nbytes(per[7], per[8])
    return t, {key: bound(by, nbg * (4.0 * spec.n * B + 2.0 * B * B))}


def segments_matvec(torch, data, spec):
    """LD v over a segment layout's blocks (v padded like the layout)."""
    def mv(v):
        parts, off = [], 0
        for seg, mc in zip(data.ld_segs, spec.seg_sizes):
            parts.append(seg @ v[off:off + mc])
            off += mc
        return torch.cat(parts)
    return mv


def quickstart(torch, ht, TG, TSG, TB, dev, gen, args, smi, errs, thin, after=None):
    """Phase 8: the README quick start on the port from PLINK files at
    n x m (args.qs_n, args.qs_m, args.qs_chr chromosomes).  ``after(stem,
    bed, pheno)`` runs on the fileset before it is removed (phase 9a);
    its result is ``results["after"]``.  Returns (results, times,
    bounds)."""
    from hibayes_tpu_torch.data import ld as TLD
    from hibayes_tpu_torch.data.plink import encode_bed_bytes
    from hibayes_tpu_torch.data.sumstats import sumstat_matrix
    from hibayes_tpu_torch.native import bed_codec

    n, m, nchr = args.qs_n, args.qs_m, args.qs_chr
    mc = m // nchr
    niter_eff = args.nburn + ((args.niter - args.nburn) // thin) * thin
    res, times, bounds = {}, {}, {}
    t0 = time.perf_counter()
    M = ld_genotype(torch, n, m, nchr, gen, dev)
    data, gv, causal, b = phenotype(torch, M, gen, dev)
    torch.cuda.synchronize()
    log(f"[8] genotype {tuple(M.shape)} int8 with LD (rho {QS_RHO}) on {nchr} chromosomes "
        f"and the phenotype made on the card in {time.perf_counter() - t0:.1f} s")
    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="quickstart_", dir=os.path.join(root, "build"))
    try:
        stem = os.path.join(tmp, "cohort")
        t0 = time.perf_counter()
        Mh = M.cpu().numpy()
        write_fileset(Mh, data, nchr, stem, encode_bed_bytes)
        bed_bytes = os.path.getsize(stem + ".bed")
        log(f"[8] PLINK fileset written in {time.perf_counter() - t0:.1f} s: .bed "
            f"{bed_bytes / 1e9:.3f} GB, .bim, .fam, .phe")

        # -- read_plink, read_pheno --
        t0 = time.perf_counter()
        path = "native (g++ codec, OpenMP)" if bed_codec.available() else "numpy"
        bed = ht.read_plink(stem)
        t_read = time.perf_counter() - t0
        if not np.array_equal(bed["geno"].values, Mh):
            raise AssertionError("read_plink: the decoded genotype differs from the written one")
        del Mh
        pheno = ht.read_pheno(stem + ".phe")
        if not np.array_equal(pheno["y"], data["y"].astype(np.float64)):
            raise AssertionError("read_pheno: y differs from the written phenotype")
        res["read_s"] = t_read
        log(f"[8] read_plink {n} x {m} through the {path} path in {t_read:.2f} s "
            f"({bed_bytes / t_read / 1e9:.3f} GB/s of .bed), bit for bit the written "
            f"genotype; read_pheno: {len(pheno)} columns")

        # -- the one-chain sweep at the ibrm call's shapes, then the call --
        t_s, b_s = check_sweep_qs(torch, TG, TB, dev, M, data["y"], errs)
        times.update(t_s)
        bounds.update(b_s)
        reset_counts(TB)
        fit = ht.ibrm("y ~ x1 + (1|grp)", data=pheno, M=bed["geno"].values,
                      M_id=bed["fam"][1], method="BayesCpi", map=bed["map"], windsize=1e6,
                      niter=args.niter, nburn=args.nburn, thin=thin, seed=args.seed,
                      device=dev, printfreq=50)
        torch.cuda.synchronize()
        launches, plain = read_counts(TB)
        expect_counts(launches, plain, {"sweep_mc": niter_eff, "sweep1": niter_eff}, "8 ibrm")
        for k in ("Vg", "Ve", "h2"):
            if not np.isfinite(getattr(fit, k)):
                raise AssertionError(f"phase 8 ibrm: {k} is not finite")
        if not 0.0 < fit.h2 < 1.0:
            raise AssertionError(f"phase 8 ibrm: h2 {fit.h2} outside (0, 1)")
        wppa = np.asarray(fit.gwas["WPPA"])
        if not (np.isfinite(wppa).all() and ((wppa >= 0) & (wppa <= 1)).all()):
            raise AssertionError("phase 8 ibrm: WPPA not in [0, 1]")
        acc = corr(fit.g["gebv"], gv.cpu().numpy())
        res.update(ibrm_launches=launches, ibrm_acc=acc,
                   ibrm_ms=1e3 * fit.chain_seconds / niter_eff)
        log(f"[8] ibrm BayesCpi y ~ x1 + (1|grp), windsize 1e6 ({wppa.size} windows): "
            f"Vg {fit.Vg:.4f} Ve {fit.Ve:.4f} h2 {fit.h2:.4f}, GEBV corr {acc:.4f} (bar "
            f"{QS_GEBV_CORR_MIN}); chain {fit.chain_seconds:.2f} s = "
            f"{res['ibrm_ms']:.2f} ms/iter on {smi}")
        if not acc >= QS_GEBV_CORR_MIN:
            raise AssertionError(f"phase 8 ibrm accuracy {acc} below {QS_GEBV_CORR_MIN}")
        del fit

        # -- summary statistics of the cohort: marginal regressions on y
        # adjusted for the covariate and the factor, written as COJO --
        Z = np.column_stack([np.ones(n), pheno["x1"],
                             (pheno["grp"][:, None] == np.unique(pheno["grp"])[None, 1:])])
        y_adj = pheno["y"] - Z @ np.linalg.lstsq(Z, pheno["y"], rcond=None)[0]
        write_ma(stem + ".ma", marginal_stats(torch, M, y_adj, bed["map"]["SNP"]))
        ss = ht.read_sumstat(stem + ".ma")

        # -- ldmat, each layout, and the Gram's rate --
        lds = {}
        for key, kw in (("blockdiag", dict(map=bed["map"], ldchr=False)),
                        ("tiled", dict(map=bed["map"], chisq=QS_CHISQ, tiled=True)),
                        ("sparse", dict(chisq=QS_CHISQ))):
            geno = bed["geno"] if key != "sparse" else bed["geno"].values[:, :mc]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lds[key] = ht.ldmat(geno, device=dev, **kw)
            torch.cuda.synchronize()
            res[f"ldmat_{key}_s"] = time.perf_counter() - t0
        tl = lds["tiled"]
        XT = torch.zeros((mc, -(-n // 8) * 8), dtype=torch.int8, device=dev)
        XT[:, :n] = M[:, :mc].T
        gram = cuda_ms(torch, lambda: TLD._int_mm(XT, XT), 3)
        tops = 2.0 * n * mc * mc / (gram * 1e-3) / 1e12
        del XT
        res.update(gram_ms=gram, gram_tops=tops, tiles=tl.n_tiles, k_max=tl.k_max)
        log(f"[8] ldmat on the card: BlockDiagLD ({nchr} blocks of {mc}) "
            f"{res['ldmat_blockdiag_s']:.2f} s; TiledSparseLD (chisq {QS_CHISQ}, tile "
            f"{tl.tile}, per chromosome, device path) {res['ldmat_tiled_s']:.2f} s: "
            f"{tl.nbr} rows x {tl.k_max} slots, {tl.n_tiles} tiles "
            f"({tl.tiles.numel() * 4 / 1e9:.3f} GB f32); SparseLD of chromosome 1 "
            f"(chisq {QS_CHISQ}) {res['ldmat_sparse_s']:.2f} s, "
            f"{int(lds['sparse'].nnz_col.sum())} nonzeros of {mc * mc}")
        log(f"[8] the exact int8 Gram of one chromosome (torch._int_mm, {mc} x {n} by "
            f"{n} x {mc}): {gram:.3f} ms, {tops:.1f} TOP/s of the 1,979 TOP/s int8 dense "
            f"peak ({100 * tops / 1979:.1f}%) on {smi}")

        # -- the new kernel instances at these shapes --
        bdata, bspec, bpr, bpi = s_setup(torch, TG, TSG, sumstat_matrix(ss), lds["blockdiag"],
                                        "BayesCpi", 64, dev, True)
        t_g, b_g = time_guarded_segment(torch, TSG, TB, bspec, bdata, bpr, bpi, errs)
        times.update(t_g)
        bounds.update(b_g)
        del bdata
        tdata, tspec, tpr, tpi = s_setup(torch, TG, TSG, sumstat_matrix(ss), tl, "BayesCpi",
                                        tl.tile, dev, True)
        t_t, b_t = time_tiled(torch, TSG, TB, tspec, tdata, tpr, tpi, tl, errs,
                              key="sweep_s_tiled64")
        ren = lambda k: k.replace("sweep_s_tiled", "tiled64").replace("chain_", "tiled64_chain_")
        times.update({ren(k): v for k, v in t_t.items()})
        bounds.update({ren(k): v for k, v in b_t.items()})
        del tdata
        log(f"[8] times (ms) of the guarded segment sweep and the tile-64 tiled sweep on "
            f"{smi}: {json.dumps({**t_g, **{ren(k): v for k, v in t_t.items()}})}; bounds "
            f"{json.dumps({**b_g, **{ren(k): v for k, v in b_t.items()}})}")

        # -- sbrm BayesCpi on each layout --
        gv_np = gv.cpu().numpy()
        on1 = causal < mc
        gv1 = (M[:, causal[on1]].float() @ b[on1]).cpu().numpy()
        for key in ("blockdiag", "sparse", "tiled"):
            ld = lds[key]
            sub = ss if key != "sparse" else {k: v[:mc] for k, v in ss.items()}
            reset_counts(TB)
            fit = ht.sbrm(sub, ld, method="BayesCpi", niter=args.niter, nburn=args.nburn,
                          thin=thin, seed=args.seed, device=dev, printfreq=0,
                          verbose=False)
            torch.cuda.synchronize()
            got, plain = read_counts(TB)
            if key == "tiled":
                want = {"sweep_s_tiled": niter_eff, "tiled_sweep": niter_eff}
            else:
                nseg = nchr if key == "blockdiag" else 1
                want = {"sweep_s_segment": nseg * niter_eff, "segment_sweep": nseg * niter_eff}
            expect_counts(got, plain, want, f"8 sbrm {key}")
            for k in ("Vg", "Ve", "h2"):
                if not np.isfinite(getattr(fit, k)):
                    raise AssertionError(f"phase 8 sbrm {key}: {k} is not finite")
            if not 0.0 < fit.h2 < 1.0:
                raise AssertionError(f"phase 8 sbrm {key}: h2 {fit.h2} outside (0, 1)")
            if fit.alpha.shape != (ld.m,) or not np.isfinite(fit.alpha).all():
                raise AssertionError(f"phase 8 sbrm {key}: effects of the wrong shape")
            pred = predict(torch, M[:, :ld.m], fit.alpha).cpu().numpy()
            a = corr(pred, gv_np if key != "sparse" else gv1)
            rej, exh = (int(x) for x in fit.guard[0])
            res[f"sbrm_{key}"] = {"launches": got, "acc": a, "guard": [rej, exh],
                                  "ms": 1e3 * fit.chain_seconds / niter_eff}
            log(f"[8] sbrm BayesCpi on the {key} LD (m={ld.m}): Vg {fit.Vg:.4f} Ve "
                f"{fit.Ve:.4f} h2 {fit.h2:.4f}; corr(X alpha, g) {a:.4f} (bar "
                f"{QS_SBRM_CORR_MIN[key]}{'; chromosome 1 part of g' if key == 'sparse' else ''}); "
                f"guard: {rej} first draws rejected, {exh} of them with all 8 candidates "
                f"failed, over {niter_eff} sweeps of {ld.m} SNPs; chain "
                f"{fit.chain_seconds:.2f} s = {res[f'sbrm_{key}']['ms']:.2f} ms/iter on {smi}")
            if not a >= QS_SBRM_CORR_MIN[key]:
                raise AssertionError(f"phase 8 sbrm {key} accuracy {a} below "
                                     f"{QS_SBRM_CORR_MIN[key]}")
            del fit
        if after is not None:
            del lds, tl, ld, M
            torch.cuda.empty_cache()
            res["after"] = after(stem, bed, pheno)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return res, times, bounds


# ---------------------------------------------------------------------------
# phase 9: the command line killed and resumed, BSLMM, a resume on each engine
# ---------------------------------------------------------------------------

# Phase 9a's CLI chain: the CLI keeps ibrm's default printfreq (100), so it
# saves at iterations 100 (the end of burn-in), 200, 300 and 400; the kill
# comes once the checkpoint reports 200 or 300, a save past burn-in before
# the end.
CLI_NITER, CLI_NBURN = 400, 100
# 9a's CLI and 12b(vi) read the first CLI_CHR chromosomes of phase 8's
# fileset, written again on their own (16,384 SNPs at the full size): the
# whole 0.82 GB .bed, read twice in 9a and once more in 12b(vi), took about
# 170 s of a 1,031 s run on an H100 host, time spent in reads that phase 8
# already makes, not in the paths 9a and 12b(vi) check.
CLI_CHR = 4

# Phase 9b, BSLMM at the flagship's width m = 65,536 with n cut to 20,000:
# the GRM is a dense n x n matrix (1.6 GB in float32 at 20,000; 10 GB at
# 50,000) and its eigh is O(n^3).  Accuracy bar: the polygenic term alone
# (GBLUP) would reach about sqrt(n h2 / (n h2 + m)) = 0.36 here; each of
# the 500 causal SNPs explains 1e-3 of the variance, a marginal z of about
# 4.5 at this n, so the sparse part finds most of them: phase 4c's BayesCpi
# at n = 4,096 (z about 2) reached 0.81.  0.7 leaves room for the shorter
# chain and Monte-Carlo error; a sweep or a polygenic draw against the
# wrong residual falls far below.
BSLMM_GEBV_CORR_MIN = 0.7


class Killed(Exception):
    """Stands for a process killed once a checkpoint is written."""


def read_meta(path):
    """The iteration a checkpoint's meta file reports, or None while it is
    missing or being written."""
    try:
        with open(path + ".meta.json") as f:
            return int(json.load(f)["it"])
    except (OSError, ValueError, KeyError):
        return None


def output_line(path, start):
    for line in open(path).read().splitlines():
        if line.startswith(start):
            return line
    raise AssertionError(f"no line starting {start!r} in {path}:\n{open(path).read()[-2000:]}")


def cli_resume(torch, ht, TB, dev, stem, bed, pheno, args, smi, thin):
    """Phase 9a: ``python -m hibayes_tpu_torch ibrm`` (the quick start's call,
    --checkpoint, --quiet) on ``stem`` (phase 8's first CLI_CHR chromosomes),
    killed with SIGKILL once its checkpoint reports an iteration past
    burn-in, then run again to the end.  Its .alpha/.gebv/.var/.gwas files
    must equal, byte for byte, what the CLI's writer makes of an
    uninterrupted ibrm with the same arguments in this process on ``bed``,
    the same fileset read here.  Returns its numbers."""
    import signal

    from hibayes_tpu_torch import cli

    t_start = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(os.path.dirname(stem), "cli")
    os.makedirs(work)
    ck, out = os.path.join(work, "ck"), os.path.join(work, "fit")
    niter_eff = CLI_NBURN + ((CLI_NITER - CLI_NBURN) // thin) * thin
    argv = [sys.executable, "-u", "-m", "hibayes_tpu_torch", "ibrm", "--bfile", stem,
            "--pheno", stem + ".phe", "--formula", "y ~ x1 + (1|grp)", "--method", "BayesCpi",
            "--windsize", "1e6", "--niter", str(CLI_NITER), "--nburn", str(CLI_NBURN),
            "--thin", str(thin), "--seed", str(args.seed), "--checkpoint", ck, "--quiet",
            "--out-prefix", out, "--device", dev.type]
    env = {**os.environ, "PYTHONPATH": root}

    def start(k):
        with open(os.path.join(work, f"run{k}.out"), "w") as fo, \
                open(os.path.join(work, f"run{k}.err"), "w") as fe:
            return subprocess.Popen(argv, cwd=root, env=env, stdout=fo, stderr=fe)

    def err_tail(k):
        return open(os.path.join(work, f"run{k}.err")).read()[-3000:]

    t0 = time.perf_counter()
    proc = start(1)
    try:
        while True:
            it = read_meta(ck)
            if it is not None and it > CLI_NBURN:
                if it >= niter_eff:
                    raise AssertionError(
                        f"phase 9a: the kill raced the end of the chain: the first checkpoint "
                        f"past burn-in seen reports iteration {it} of {niter_eff}")
                proc.send_signal(signal.SIGKILL)
                break
            if proc.poll() is not None:
                raise AssertionError(
                    f"phase 9a: the first CLI run ended (exit {proc.returncode}) before a "
                    f"checkpoint past burn-in was seen:\n{err_tail(1)}")
            if time.perf_counter() - t0 > 900:
                raise AssertionError("phase 9a: no checkpoint past burn-in within 900 s")
            time.sleep(0.02)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
    t_first = time.perf_counter() - t0
    it_saved = read_meta(ck)
    if proc.returncode != -signal.SIGKILL or it_saved >= niter_eff or os.path.exists(
            out + ".alpha.tsv"):
        raise AssertionError(
            f"phase 9a: the kill raced the end of the chain (exit {proc.returncode}, "
            f"checkpoint at iteration {it_saved} of {niter_eff}): nothing would be resumed")
    log(f"[9a] CLI ibrm killed (SIGKILL) after {t_first:.1f} s with its checkpoint at "
        f"iteration {it_saved} of {niter_eff} (burn-in {CLI_NBURN})")
    t0 = time.perf_counter()
    proc = start(2)
    rc = proc.wait(timeout=900)
    t_second = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"phase 9a: the resumed CLI run exited {rc}:\n{err_tail(2)}")
    o1, o2 = (os.path.join(work, f"run{k}.out") for k in (1, 2))
    output_line(o2, f"checkpoint {ck}: resuming at iteration {it_saved}")
    reads = [float(output_line(o, "read_plink").split(" in ")[1].split()[0]) for o in (o1, o2)]
    chain_s = float(output_line(o2, "chain ").split()[1])
    if read_meta(ck) != niter_eff:
        raise AssertionError(f"phase 9a: the resumed run's checkpoint ends at {read_meta(ck)}")

    reset_counts(TB)
    fit = ht.ibrm("y ~ x1 + (1|grp)", data=pheno, M=bed["geno"].values, M_id=bed["fam"][1],
                  method="BayesCpi", map=bed["map"], windsize=1e6, windnum=None,
                  niter=CLI_NITER, nburn=CLI_NBURN, thin=thin, seed=args.seed, verbose=False,
                  device=dev)
    torch.cuda.synchronize()
    launches, plain = read_counts(TB)
    expect_counts(launches, plain, {"sweep_mc": niter_eff, "sweep1": niter_eff},
                  "9a uninterrupted ibrm")
    ref = os.path.join(work, "ref")
    cli.save_fit(fit, ref, map_=bed["map"])
    for suffix in (".alpha.tsv", ".gebv.tsv", ".var.tsv", ".gwas.tsv"):
        a, b = open(out + suffix, "rb").read(), open(ref + suffix, "rb").read()
        if a != b:
            raise AssertionError(f"phase 9a: the resumed CLI run's {suffix} differs from the "
                                 f"uninterrupted run's ({len(a)} and {len(b)} bytes)")
    res = {"read_s": reads, "killed_at": it_saved, "first_run_s": t_first,
           "second_run_s": t_second, "resumed_chain_s": chain_s,
           "resumed_ms_per_iter": 1e3 * chain_s / (niter_eff - it_saved),
           "uninterrupted_ms_per_iter": 1e3 * fit.chain_seconds / niter_eff,
           "launches": launches, "wall_s": time.perf_counter() - t_start}
    log(f"[9a] resumed CLI run: read_plink {reads[0]:.2f} s and {reads[1]:.2f} s in the two "
        f"processes; the resumed chain ran iterations {it_saved}-{niter_eff} in {chain_s:.2f} s "
        f"= {res['resumed_ms_per_iter']:.2f} ms/iter (the uninterrupted run in this process "
        f"{res['uninterrupted_ms_per_iter']:.2f}); its .alpha/.gebv/.var/.gwas files equal the "
        f"uninterrupted run's byte for byte; processes {t_first:.1f} s and {t_second:.1f} s "
        f"on {smi}")
    return res


def bslmm(torch, ht, TG, TB, dev, gen, args, smi, errs, thin):
    """Phase 9b: ibrm("y ~ x1 + (1|grp)", method="BSLMM") at n=args.bs_n x
    m=args.m (int8 on the card, h2=0.5 from 500 causal SNPs), one chain:
    sweep1 held against its plain version at BSLMM's own shapes (rows not
    padded) first; the GRM's exact int8 product, the GRM and its eigh and
    the polygenic block's three n x n products timed on their own; the fit
    through sweep1 only, finite Va, Vb >= 0, and its GEBV accuracy.
    Returns (results, times, bounds)."""
    from hibayes_tpu_torch.data import ld as TLD
    from hibayes_tpu_torch.math.grm import make_grm

    n, m = args.bs_n, args.m
    niter_eff = args.nburn + ((args.niter - args.nburn) // thin) * thin
    t0 = time.perf_counter()
    M, data, gv = simulate(torch, n, m, gen, dev)
    torch.cuda.synchronize()
    log(f"[9b] genotype {tuple(M.shape)} int8 and the phenotype made on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    errs["sweep_mc_bslmm"] = 0.0
    times, bounds = check_sweep_qs(torch, TG, TB, dev, M, data["y"], errs,
                                   key="sweep_mc_bslmm", pad_n=False, label="BSLMM's ibrm")
    gram = cuda_ms(torch, lambda: TLD._int_mm(M, M), 3)
    tops = 2.0 * n * n * m / (gram * 1e-3) / 1e12
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    G = make_grm(M, device=dev)
    torch.cuda.synchronize()
    grm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    vals, K = torch.linalg.eigh(G)
    torch.cuda.synchronize()
    eigh_s = time.perf_counter() - t0
    del G, vals
    v = torch.randn((3, n), generator=gen, device=dev)
    times["bslmm_products"] = cuda_ms(torch, lambda: (v[0] @ K, v[1] @ K.T, v[2] @ K), 5)
    bounds["bslmm_products"] = bound(3 * (K.numel() * 4 + 2 * n * 4), 3 * 2.0 * n * n)
    del K, v
    torch.cuda.empty_cache()
    log(f"[9b] the GRM's exact int8 product (torch._int_mm, {n} x {m} by {m} x {n}): "
        f"{gram:.3f} ms, {tops:.1f} TOP/s of the 1,979 TOP/s int8 dense peak "
        f"({100 * tops / 1979:.1f}%); make_grm (product, mean corrections, scaling) "
        f"{grm_s:.2f} s; eigh of the {n} x {n} float32 GRM {eigh_s:.2f} s; the polygenic "
        f"block's three n x n products {times['bslmm_products']:.3f} ms (bound "
        f"{bounds['bslmm_products'][0]:.3f} ms, 3 x {4 * n * n / 1e9:.2f} GB over 3.35 TB/s) "
        f"on {smi}")
    reset_counts(TB)
    t0 = time.perf_counter()
    fit = ht.ibrm("y ~ x1 + (1|grp)", data=data, M=M, M_id=data["id"], method="BSLMM",
                  niter=args.niter, nburn=args.nburn, thin=thin, seed=args.seed, device=dev,
                  verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = read_counts(TB)
    expect_counts(launches, plain, {"sweep_mc": niter_eff, "sweep1": niter_eff}, "9b BSLMM")
    for k in ("Vg", "Ve", "h2", "Va", "Vb"):
        if not np.isfinite(getattr(fit, k)):
            raise AssertionError(f"phase 9b BSLMM: {k} is not finite")
    if not (fit.Va >= 0 and fit.Vb >= 0 and 0.0 < fit.h2 < 1.0):
        raise AssertionError(f"phase 9b BSLMM: Va {fit.Va}, Vb {fit.Vb}, h2 {fit.h2}")
    gebv = fit.g["gebv"]
    if gebv.shape != (n,) or not np.isfinite(gebv).all():
        raise AssertionError("phase 9b BSLMM: GEBV of the wrong shape or not finite")
    acc = corr(gebv, gv.cpu().numpy())
    ms = 1e3 * fit.chain_seconds / niter_eff
    res = {"launches": launches, "acc": acc, "ms_per_iter": ms, "wall_s": wall,
           "gram_ms": gram, "gram_tops": tops, "make_grm_s": grm_s, "eigh_s": eigh_s,
           "products_share": times["bslmm_products"] / ms, "Va": fit.Va, "Vb": fit.Vb}
    log(f"[9b] ibrm BSLMM n={n} m={m}: Vg {fit.Vg:.4f} Va {fit.Va:.4f} Vb {fit.Vb:.4f} "
        f"Ve {fit.Ve:.4f} h2 {fit.h2:.4f}; GEBV corr {acc:.4f} (bar {BSLMM_GEBV_CORR_MIN}); "
        f"wall {wall:.1f} s (set-up with the GRM and its eigh included); chain "
        f"{fit.chain_seconds:.2f} s = {ms:.2f} ms/iter, the three n x n products "
        f"{100 * res['products_share']:.1f}% of it, on {smi}")
    if not acc >= BSLMM_GEBV_CORR_MIN:
        raise AssertionError(f"phase 9b BSLMM accuracy {acc} below {BSLMM_GEBV_CORR_MIN}")
    return res, times, bounds


def resume_case(torch, TB, what, run, nburn, want):
    """One chain or batch on the card (``run(checkpoint)`` returns its
    records, GEBV and guard counts as numpy arrays): uninterrupted, then
    with a checkpoint, killed once a save is past burn-in and run again.
    Both equal bit for bit; each run launches its kernels ``want`` times:
    the killed and the resumed run together do each iteration once."""
    from hibayes_tpu_torch.engine import checkpoint as CK
    from hibayes_tpu_torch.utils import PhaseTimer

    timer, saves = PhaseTimer(), [0]
    reset_counts(TB)
    full = run(None)
    torch.cuda.synchronize()
    got, plain = read_counts(TB)
    expect_counts(got, plain, want, f"9c {what}, uninterrupted")
    ck = os.path.join(tempfile.mkdtemp(prefix="resume_"), "ck")
    real = CK.save_checkpoint

    def timed_save(path, state, samples):   # a save's wall, the host copies included
        with timer.phase("save"):
            real(path, state, samples)
        saves[0] += 1

    def save_then_die(path, state, samples):
        timed_save(path, state, samples)
        if read_meta(path) > nburn:
            raise Killed()

    reset_counts(TB)
    CK.save_checkpoint = save_then_die
    try:
        run(ck)
        raise AssertionError(f"phase 9c {what}: no checkpoint past burn-in was saved")
    except Killed:
        pass
    finally:
        CK.save_checkpoint = real
    killed_at = read_meta(ck)
    CK.save_checkpoint = timed_save
    try:
        resumed = run(ck)
    finally:
        CK.save_checkpoint = real
    torch.cuda.synchronize()
    got, plain = read_counts(TB)
    expect_counts(got, plain, want, f"9c {what}, killed and resumed")
    shutil.rmtree(os.path.dirname(ck), ignore_errors=True)
    if full.keys() != resumed.keys():
        raise AssertionError(f"phase 9c {what}: other records after the resume")
    for k in full:
        if not np.array_equal(full[k], resumed[k], equal_nan=True):
            raise AssertionError(f"phase 9c {what}: {k} differs after the resume at "
                                 f"iteration {killed_at}")
    log(f"[9c] {what}: killed after its checkpoint at iteration {killed_at} and resumed: "
        f"every record{', the GEBV' if 'gebv' in full else ''}"
        f"{' and the guard counts ' + str(full['guard'].tolist()) if 'guard' in full else ''} "
        f"bit for bit the uninterrupted run's; {saves[0]} saves took "
        f"{timer.phases.get('save', 0.0):.4f} s (PhaseTimer), "
        f"{1e3 * timer.phases.get('save', 0.0) / max(saves[0], 1):.2f} ms a save")
    return {"killed_at": killed_at, "launches": got, "saves": saves[0],
            "save_s": timer.phases.get("save", 0.0),
            **({"guard": full["guard"].tolist()} if "guard" in full else {})}


def resumes(torch, ht, TG, TSG, TLD, TSLD, TB, dev, gen, args):
    """Phase 9c (and 10c): a resume on each engine at small sizes on the
    card (n=args.rs_n, m=args.rs_m): an ibrm batch of 4, sbrm on a tiled LD
    of m SNPs with one chain and with 4, sbrm on a BlockDiagLD of two blocks
    of m/8 with 4 chains and a lowered vary so that the guard fires (its
    counts are carried), and ssbrm on a 3,000-id pedigree with one chain
    and with 4.  Returns each case's numbers."""
    out = {}
    kw = dict(niter=60, nburn=20, thin=5, seed=args.seed, verbose=False, device=dev)
    niter_eff = 60
    n, m = args.rs_n, args.rs_m

    # ibrm, a batch of 4 chains (BayesR, a covariate and a factor), B=128
    M, data, _ = simulate(torch, n, m, gen, dev)
    nb = -(-m // 128)

    def ibrm_run(ck):
        fit = ht.ibrm("y ~ x1 + (1|grp)", data=data, M=M, M_id=data["id"], method="BayesR",
                      block=128, nchains=4, checkpoint=ck, **kw)
        return {**fit.MCMCsamples, "gebv": fit.g["gebv"]}

    out["ibrm_4_chains"] = resume_case(
        torch, TB, f"ibrm BayesR, 4 chains, n={n} m={m}", ibrm_run, 20,
        {"sweep_mc": niter_eff, "rows_mc_kernel": niter_eff * (nb + 1),
         "draws_kernel": niter_eff * nb})
    del M, data

    # sbrm on a tiled LD (tiles of 128 in a 9-tile band)
    tld = banded_ld(torch, TSLD, m, dev)
    ss, _ = summary_stats(torch, tiled_matvec(torch, tld), m, tld.m_pad, gen, dev)

    def tiled_run(ck):
        fit = ht.sbrm(ss, tld, method="BayesCpi", printfreq=20, checkpoint=ck, **kw)
        return {**fit.MCMCsamples, "guard": fit.guard}

    out["sbrm_tiled"] = resume_case(torch, TB, f"sbrm BayesCpi, tiled LD m={m}", tiled_run,
                                    20, {"sweep_s_tiled": niter_eff, "tiled_sweep": niter_eff})

    def tiled4_run(ck):
        fit = ht.sbrm(ss, tld, method="BayesCpi", nchains=4, checkpoint=ck, **kw)
        return {**fit.MCMCsamples, "guard": fit.guard}

    out["sbrm_tiled_4_chains"] = resume_case(
        torch, TB, f"sbrm BayesCpi, tiled LD m={m}, 4 chains", tiled4_run, 20,
        {"sweep_s_tiled": niter_eff, "tiled_sweep": niter_eff})
    del tld

    # sbrm on a BlockDiagLD of two AR(1) blocks, 4 chains, the guard firing
    mb = m // 8
    A = ar1_ld(torch, mb, dev)
    bld = TLD.BlockDiagLD(blocks=[A, A.clone()], sizes=[mb, mb])
    ss, _ = summary_stats(torch, lambda v: torch.cat([A @ v[:mb], A @ v[mb:]]), 2 * mb,
                          2 * mb, gen, dev)
    sdata, spec, pr, pi = s_setup(torch, TG, TSG, ss, bld, "BayesCpi", 64, dev, True)
    spec = spec.__class__(**{**spec.__dict__, "niter": 60, "nburn": 20, "thin": 5,
                             "vary": 2e-4})

    def blockdiag_run(ck):
        _, smp, ex = TSG.run_s_chains(spec, sdata, pr, pi, seed=args.seed, nchains=4,
                                      checkpoint_path=ck, chunk_records=2)
        return {**smp, "guard": ex["guard"]}

    out["sbrm_blockdiag_4_chains"] = resume_case(
        torch, TB, f"sbrm BayesCpi, BlockDiagLD (2 blocks of {mb}), 4 chains, vary 2e-4",
        blockdiag_run, 20, {"sweep_s_segment": 2 * niter_eff, "segment_sweep": 2 * niter_eff})
    if not np.asarray(out["sbrm_blockdiag_4_chains"]["guard"])[:, 0].sum() > 0:
        raise AssertionError("phase 9c: the guard did not fire on the BlockDiagLD batch")
    del A, bld, sdata

    # ssbrm: 3,000 ids, 600 genotyped, m=2,048, imputation by PCG
    sids, ssir, sdam, _, _ = make_pedigree(150, 2850, args.seed + 2)
    srng = np.random.default_rng(args.seed + 2)
    sg = sids[np.sort(srng.choice(3000, 600, replace=False))]
    sM = torch.randint(0, 3, (600, 2048), generator=gen, device=dev, dtype=torch.int8)
    sphe = sids[srng.choice(3000, 900, replace=False)]
    sy = srng.normal(size=900)

    def ssbrm_run(ck):
        fit = ht.ssbrm("y ~ 1", data={"id": sphe, "y": sy}, M=sM, M_id=sg,
                       pedigree={"id": sids, "sire": ssir, "dam": sdam}, impute="pcg",
                       chunk_cols=512, printfreq=20, checkpoint=ck, **kw)
        return {**fit.MCMCsamples, "gebv": fit.g["gebv"]}

    out["ssbrm"] = resume_case(torch, TB, "ssbrm BayesCpi, 3,000 ids, m=2,048", ssbrm_run, 20,
                               {"sweep_mc": niter_eff, "sweep1": niter_eff,
                                "mme_sweep": niter_eff, "mme_sweep_kernel": niter_eff})

    def ssbrm4_run(ck):
        fit = ht.ssbrm("y ~ 1", data={"id": sphe, "y": sy}, M=sM, M_id=sg,
                       pedigree={"id": sids, "sire": ssir, "dam": sdam}, impute="pcg",
                       chunk_cols=512, nchains=4, checkpoint=ck, **kw)
        return {**fit.MCMCsamples, "gebv": fit.g["gebv"]}

    nbs = 2048 // 64
    out["ssbrm_4_chains"] = resume_case(
        torch, TB, "ssbrm BayesCpi, 4 chains, 3,000 ids, m=2,048", ssbrm4_run, 20,
        {"sweep_mc": niter_eff, "rows_mc_kernel": niter_eff * (nbs + 1),
         "draws_kernel": niter_eff * nbs, "mme_sweep": niter_eff, "mme_sweep_kernel": niter_eff})
    return out


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
        split["rows"] = part("rows_mc_kernel")
        split["draws"] = part("draws_kernel")
        split["sweep1"] = part("sweep1_kernel")
        split["sweep_mc"] = split["rows"] + split["draws"] + split["sweep1"]
        split["mme_sweep"] = part("mme_sweep_kernel")
        split["torch"] = busy / 1e3 - split["sweep_mc"] - split["mme_sweep"]
        split["wall"] = 1e3 * wall / iters
    return state


def per_chain(fit, key, nchains, n_rec):
    """The records of ``key`` of a pooled fit, (nchains, n_records, ...)."""
    v = fit.MCMCsamples[key]
    return v.reshape((nchains, n_rec) + v.shape[1:])


def ssbrm_chains(torch, ht, TB, inputs, ids, gi, phe, gv, nchains, args, niter_eff, thin,
                 smi, ms1, times, veps1):
    """Phase 10a: ssbrm(impute="pcg", method="BayesCpi", nchains=...) on
    phase 7's cohort through the K-chain rows and draws kernels and one
    K-chain epsilon launch an iteration only (launch counts, no plain call);
    every chain finite, R-hat(Ve), the GEBV agreement of chains 0 and 1 and
    the pooled accuracy of the non-genotyped phenotyped ids, each against
    its bar, and the pooled Veps against phase 7's one chain's ``veps1``.
    Prints ms/iter beside phase 7's one chain, the set-up split and the
    epsilon sweep's time at K beside K=1 (check_mme, phase 7)."""
    n_rec = (args.niter - args.nburn) // thin
    m = inputs["M"].shape[1]
    nb = -(-m // 64)
    reset_counts(TB)
    t0 = time.perf_counter()
    fit = ht.ssbrm("y ~ 1", **inputs, method="BayesCpi", niter=args.niter, nburn=args.nburn,
                   thin=thin, impute="pcg", chunk_cols=2048, seed=args.seed,
                   device=inputs["M"].device, nchains=nchains, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = read_counts(TB)
    expect_counts(launches, plain, {"sweep_mc": niter_eff,
                                    "rows_mc_kernel": niter_eff * (nb + 1),
                                    "draws_kernel": niter_eff * nb, "mme_sweep": niter_eff,
                                    "mme_sweep_kernel": niter_eff}, "10a")
    for k in ("mu", "Vg", "Ve", "h2", "alpha", "Veps", "J", "epsilon"):
        per = per_chain(fit, k, nchains, n_rec)
        bad = [c for c in range(nchains) if not np.isfinite(per[c]).all()]
        if bad:
            raise AssertionError(f"10a: chains {bad} have non-finite {k}")
    gebv = dict(zip(fit.g["id"], fit.g["gebv"]))
    ng_phe = np.setdiff1d(phe, gi)
    gv_np = gv.cpu().numpy()
    acc = float(np.corrcoef([gebv[i] for i in ids[ng_phe]], gv_np[ng_phe])[0, 1])
    g01 = chain_gebv(fit, nchains, n_rec)
    pos = {v: i for i, v in enumerate(fit.g["id"])}
    held = np.array([pos[i] for i in ids[np.union1d(gi, phe)]])   # ids with data
    corr01 = float(np.corrcoef(g01[0][held], g01[1][held])[0, 1])
    corr01_all = float(np.corrcoef(g01[0], g01[1])[0, 1])
    sec, setup = fit.chain_seconds, fit.setup_seconds
    veps_rel = abs(fit.Veps / veps1 - 1.0)
    out = {"ms_per_iter": 1e3 * sec / niter_eff, "rhat_Ve": fit.rhat["Ve"],
           "rhat_Veps": fit.rhat["Veps"], "corr01": corr01, "corr01_all": corr01_all,
           "acc": acc, "wall_s": wall, "launches": launches, "setup_s": setup,
           "veps_rel": veps_rel}
    log(f"[10a] ssbrm BayesCpi nchains={nchains}, {len(ids)} ids x m={m}: Vg {fit.Vg:.4f} "
        f"Ve {fit.Ve:.4f} Veps {fit.Veps:.4f} J {fit.J:.4f} h2 {fit.h2:.4f}; R-hat Ve "
        f"{fit.rhat['Ve']:.4f} (bar {RHAT_VE_MAX_SSBRM_CHAINS}), Veps {fit.rhat['Veps']:.4f}, "
        f"J {fit.rhat['J']:.4f}; corr(GEBV chain 0, chain 1) {corr01:.4f} on the "
        f"{len(held)} genotyped or phenotyped ids (bar {SSBRM_CHAINS_CORR_MIN}), "
        f"{corr01_all:.4f} on all; pooled GEBV accuracy on the {len(ng_phe)} non-genotyped "
        f"phenotyped {acc:.4f} (bar {SSBRM_CORR_MIN}); Veps {veps_rel:.4f} off phase 7's "
        f"{veps1:.4f} (bar {SSBRM_CHAINS_VEPS_REL_MAX})")
    log(f"[10a] wall {wall:.2f} s; set-up (s) pedigree {setup['pedigree']:.2f}, imputation "
        f"{setup['imputation']:.2f}, prepare {setup['prepare']:.2f}; chain {sec:.2f} s = "
        f"{out['ms_per_iter']:.2f} ms/iter against phase 7's one chain {ms1:.2f}; the epsilon "
        f"sweep at K={nchains} {times[f'mme_sweep_k{nchains}_full']:.4f} ms against K=1 "
        f"{times['mme_sweep_full']:.4f} ms on {smi}")
    if not fit.rhat["Ve"] < RHAT_VE_MAX_SSBRM_CHAINS:
        raise AssertionError(f"10a: R-hat(Ve) {fit.rhat['Ve']} not below "
                             f"{RHAT_VE_MAX_SSBRM_CHAINS}")
    if not corr01 >= SSBRM_CHAINS_CORR_MIN:
        raise AssertionError(f"10a: chains 0 and 1 GEBV corr {corr01} below "
                             f"{SSBRM_CHAINS_CORR_MIN}")
    if not acc >= SSBRM_CORR_MIN:
        raise AssertionError(f"10a: pooled accuracy {acc} below {SSBRM_CORR_MIN}")
    if not veps_rel <= SSBRM_CHAINS_VEPS_REL_MAX:
        raise AssertionError(f"10a: Veps {fit.Veps} is {veps_rel:.3f} off phase 7's {veps1} "
                             f"(bar {SSBRM_CHAINS_VEPS_REL_MAX})")
    return out


def tiled_chains(torch, ht, TB, ss, tld, b_true, nchains, args, niter_eff, thin, smi, ms1):
    """Phase 10b: sbrm(method="BayesCpi", nchains=...) on phase 5's tiled LD
    (the guard on) through one K-chain tiled launch an iteration only; each
    chain finite with its guard counts (rejected, all 8 candidates failed),
    each chain's and the pooled accuracy against b_true and R-hat(Vg),
    against their bars.  Prints ms/iter beside phase 5's one chain."""
    n_rec = (args.niter - args.nburn) // thin
    reset_counts(TB)
    t0 = time.perf_counter()
    fit = ht.sbrm(ss, tld, method="BayesCpi", fold=np.array([0.0, 1.0]), niter=args.niter,
                  nburn=args.nburn, thin=thin, seed=args.seed, device=tld.tiles.device,
                  nchains=nchains, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = read_counts(TB)
    expect_counts(launches, plain, {"sweep_s_tiled": niter_eff, "tiled_sweep": niter_eff},
                  "10b")
    corr = check_fit(fit, b_true, "10b")
    alpha = per_chain(fit, "alpha", nchains, n_rec)
    if not np.isfinite(alpha).all():
        raise AssertionError("10b: non-finite effects")
    accs = [float(np.corrcoef(alpha[c].mean(0), b_true)[0, 1]) for c in range(nchains)]
    guard = np.asarray(fit.guard)
    if guard.shape != (nchains, 2) or (guard < 0).any() or (guard[:, 1] > guard[:, 0]).any():
        raise AssertionError(f"10b: guard counts {guard.tolist()}")
    out = {"ms_per_iter": 1e3 * fit.chain_seconds / niter_eff, "rhat_Vg": fit.rhat["Vg"],
           "rhat_Ve": fit.rhat["Ve"], "acc": corr, "acc_per_chain": accs, "wall_s": wall,
           "launches": launches, "guard": guard.tolist()}
    log(f"[10b] sbrm BayesCpi tiled m={tld.m}, {nchains} chains: Vg {fit.Vg:.4f} Ve "
        f"{fit.Ve:.4f} h2 {fit.h2:.4f}; R-hat Vg {fit.rhat['Vg']:.4f} (bar "
        f"{RHAT_MAX_TILED_CHAINS}) Ve {fit.rhat['Ve']:.4f}; corr(alpha, b_true) pooled "
        f"{corr:.4f}, per chain {[round(a, 4) for a in accs]} (bar {SBAYES_CORR_MIN}); guard "
        f"counts per chain (rejected, all 8 failed) {guard.tolist()}")
    log(f"[10b] wall {wall:.2f} s; chain {fit.chain_seconds:.2f} s = {out['ms_per_iter']:.2f} "
        f"ms/iter against phase 5's one chain {ms1:.2f}, "
        f"{nchains * niter_eff * tld.m / fit.chain_seconds:.4g} SNP-updates/s over "
        f"{nchains} chains on {smi}")
    if not fit.rhat["Vg"] < RHAT_MAX_TILED_CHAINS:
        raise AssertionError(f"10b: R-hat(Vg) {fit.rhat['Vg']} not below {RHAT_MAX_TILED_CHAINS}")
    if not min(accs + [corr]) >= SBAYES_CORR_MIN:
        raise AssertionError(f"10b: accuracy {corr}, per chain {accs}, below {SBAYES_CORR_MIN}")
    return out


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


def ssbrm_cohort(torch, n_ids, m, seed, gen, dev):
    """Phase 7's cohort: a pedigree of n_ids ids (5% founders), 20%
    genotyped (m SNPs dropped down the pedigree on the card, h2=0.5 from 500
    causal SNPs), 5% genotyped and 5% non-genotyped phenotyped.  Returns
    (ids, sires, dams, genotyped rows, phenotyped rows, genotype, true
    genetic values, y, generations)."""
    nfound, n_g, n_ph = n_ids // 20, n_ids // 5, n_ids // 20
    ids, sires, dams, s_par, d_par = make_pedigree(nfound, n_ids - nfound, seed)
    rng = np.random.default_rng(seed)
    gi = np.sort(rng.choice(n_ids, n_g, replace=False))
    others = np.setdiff1d(np.arange(n_ids), gi)
    phe = np.concatenate([rng.choice(gi, n_ph, replace=False),
                          rng.choice(others, n_ph, replace=False)])
    Mg, gv, depth = drop_genes(torch, nfound, s_par, d_par, m, gi, gen, dev)
    y = (gv[torch.as_tensor(phe, device=dev)]
         + np.sqrt(0.5) * torch.randn(len(phe), generator=gen, device=dev)).cpu().numpy()
    return ids, sires, dams, gi, phe, Mg, gv, y, depth


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


def check_mme(torch, TG, TB, lay, counts, gen, dev, errs, nb=16, K=4):
    """The epsilon sweep at the main path's layout: its first ``nb`` blocks
    (the layout and vectors cut to them) and the whole sweep against the
    plain version (the effects at the kernel bar, the residual where the
    sweep leaves it), a bit-identical second launch, times, bounds, and
    torch.linalg.solve_triangular on block 0 (the one library call that
    computes a block's draws); then the same at K chains (phase 10a's
    batch: each chain bit for bit its K=1 launch), timed beside K=1, with
    a batched solve_triangular of one block a chain.  Returns (times,
    bounds)."""
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
         "mme_sweep_full": cuda_ms(torch, lambda: TB.mme_sweep(*runs[nbr]), 5),
         "mme_sweep_cold": cold_ms(torch, lambda: TB.mme_sweep(*runs[nb]), 10),
         "mme_sweep_full_cold": cold_ms(torch, lambda: TB.mme_sweep(*runs[nbr]), 5),
         "mme_sweep_split": mme_split(torch, TB, runs[nbr])}
    # the epsilon chain alone (one warp, block 0 staged), cycles a draw,
    # and its time a block from CUDA events around one launch of 400
    TB.mme_chain_latency(lay.diag_blocks[0], counts[:T], z[:T], scale, ve, res[:T], 10)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    cyc = TB.mme_chain_latency(lay.diag_blocks[0], counts[:T], z[:T], scale, ve, res[:T], 400)
    e1.record()
    torch.cuda.synchronize()
    t["mme_chain_cycles_per_draw"] = int(cyc) / 400 / T
    t["mme_chain_us_per_block"] = 1e3 * e0.elapsed_time(e1) / 400
    t["mme_chain_floor_ms"] = nbr * t["mme_chain_us_per_block"] / 1e3
    plan = TB.mme_plan(lay, nbr).host
    d = plan["dist"]
    t["mme_target_distance_rows"] = {"1": int(d[1]), "2": int(d[2]), "3-19": int(d[3:20].sum()),
                                     ">=20": int(d[20:].sum()), "max": int(len(d) - 1)}
    log(f"  mme_sweep plan over {nbr} blocks: forward rows by target-block distance "
        f"{t['mme_target_distance_rows']}; {plan['near_rows']} rows to the next block "
        f"(the drawer's), {plan['two_rows']} two blocks on, {plan['far_rows_n']} further; "
        f"at most {plan['ncap']} entries a block to the next")

    # library yardstick: block 0's draws as one triangular solve,
    # tril(Wb) dx = r + diag(Wb) noise, unit diagonal on padded sites (a
    # batch of one block a chain for K chains)
    def tri(sc, vv, zz, rr):
        Wb, invd, noise = TB._block_constants(lay.diag_blocks[0].clone(), counts[:T],
                                              sc.reshape(-1, 1, 1), vv.reshape(-1, 1),
                                              zz.reshape(-1, T))
        ok = invd > 0
        L = torch.tril(Wb) + torch.diag_embed((~ok).float())
        rhs = torch.where(ok, rr.reshape(-1, T) + torch.diagonal(Wb, dim1=-2, dim2=-1) * noise,
                          0.0)[..., None]
        dx_lib = torch.linalg.solve_triangular(L, rhs, upper=False)[..., 0]
        dx_plain = TB._mme_draws(Wb, rr.reshape(-1, T).clone(), invd, noise)
        lib_err = float((dx_lib - dx_plain).abs().max())
        if not lib_err <= 1e-4 * float(dx_plain.abs().max()):
            raise AssertionError(f"solve_triangular off the block draws by {lib_err}")
        ms = cuda_ms(torch, lambda: torch.linalg.solve_triangular(L, rhs, upper=False), 200)
        return ms, lib_err

    t["mme_library"], lib_err = tri(scale, ve, z[:T], res[:T])
    log(f"  ok solve_triangular on block 0 (T={T}) matches the block draws to {lib_err:.3g}")

    # K chains: phase 10a's batch, each chain its own x, z, residual, scale, ve
    sc, vv, zK, xK, rK = mme_chains_inputs(torch, TG, lay, counts, gen, dev, K)
    kruns = {nb: (part, cut(counts), sc, vv, zK[:, :nb * T], xK[:, :nb * T], rK),
             nbr: (lay, counts, sc, vv, zK, xK, rK)}
    for k, args in kruns.items():
        check_mme_case(torch, TB, args, f"mme_sweep K={K} over {k} of {nbr} blocks of {T}",
                       errs, "mme_sweep_k")
    t.update({f"mme_sweep_k{K}": cuda_ms(torch, lambda: TB.mme_sweep(*kruns[nb]), 20),
              f"mme_sweep_k{K}_plain": cuda_ms(torch, lambda: TB.mme_sweep_plain(*kruns[nb]), 1),
              f"mme_sweep_k{K}_full": cuda_ms(torch, lambda: TB.mme_sweep(*kruns[nbr]), 5),
              f"mme_sweep_k{K}_full_cold": cold_ms(torch, lambda: TB.mme_sweep(*kruns[nbr]),
                                                   5)})
    t[f"mme_k{K}_library"], lib_err = tri(sc, vv, zK[:, :T], rK[:, :T])
    log(f"  ok batched solve_triangular on block 0 of {K} chains matches the block draws "
        f"to {lib_err:.3g}; mme_sweep over {nbr} blocks: K={K} "
        f"{t[f'mme_sweep_k{K}_full']:.4f} ms against K=1 {t['mme_sweep_full']:.4f} ms "
        f"(L2 cold {t[f'mme_sweep_k{K}_full_cold']:.4f} against {t['mme_sweep_full_cold']:.4f})")

    # bounds: each input read once, each output written once.  The kernel
    # takes dense (T, T) diagonal blocks, as TPU kernel 10 does; the sweep's
    # own work is their nonzeros.  bound_ms counts the nonzeros, 8 bytes
    # each (value and in-block column, as for the triplets); the dense
    # layout's bound is printed beside it.
    def sweep_bound(k, dense, chains=1):
        u1 = int(lay.blk_ptr[k])
        e1 = int(lay.row_ptr[u1])
        rows = int(torch.unique(lay.urow[:u1]).numel())
        D = lay.diag_blocks[:k]
        nz = int((D != 0).sum())                     # diagonal-block nonzeros
        nz_low = int((torch.tril(D, diagonal=-1) != 0).sum())
        # the layout and counts once; each chain's z, x, res of its blocks,
        # its forward rows read and written and its x out
        by = ((k * T * T * 4 if dense else 8 * nz) + 4 * k * T   # blocks; counts
              + 4 * (k + 1) + 4 * 2 * u1 + 8 * e1       # blk_ptr, urow + row_ptr, entries
              + chains * (4 * 3 * k * T + 4 * 2 * rows + 4 * k * T))
        # Wb and the site constants (the diagonal, 6 per site), 2 per
        # strictly lower entry of a block, per triplet and per draw, a chain
        low = k * T * (T - 1.0) / 2 if dense else nz_low
        flops = chains * ((k * T * T if dense else nz) + k * 8.0 * T + 2.0 * low + 2.0 * e1)
        return bound(by, flops)

    bounds = {key: sweep_bound(k, False) for key, k in (("mme_sweep", nb),
                                                          ("mme_sweep_full", nbr))}
    bounds["mme_sweep_full_dense_layout"] = sweep_bound(nbr, True)
    bounds[f"mme_sweep_k{K}"] = sweep_bound(nb, False, K)
    bounds[f"mme_sweep_k{K}_full"] = sweep_bound(nbr, False, K)
    log(f"  mme_sweep bounds over {nbr} blocks: nonzeros "
        f"{bounds['mme_sweep_full'][0]:.6g} ms, dense (T, T) layout "
        f"{bounds['mme_sweep_full_dense_layout'][0]:.6g} ms; the epsilon chain alone "
        f"{t['mme_chain_cycles_per_draw']:.2f} cycles a draw, "
        f"{t['mme_chain_us_per_block']:.3f} us a block of {T}: a latency floor of "
        f"{t['mme_chain_floor_ms']:.4f} ms a sweep; split per block "
        f"{json.dumps(t['mme_sweep_split'])}")
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


# ---------------------------------------------------------------------------
# any block, fold count, tile and chain count (phases 3 and 11)
# ---------------------------------------------------------------------------

# Phase 11 (the shapes the JAX package runs and the kernels take as
# sub-blocks, with the run-time fold count, re-tiled, or in groups of
# chains).  11a is phase 4's cohort and recipe at blocks of 256: the same
# sampler in another blocking (exact for any blocking), so its GEBV
# accuracy keeps phase 4's bar, GEBV_CORR_MIN.  11b is the cohort at 12
# folds (variances log-spaced 1e-5 .. 1e-2 of Vg per SNP) for 50 iterations,
# 30 of them burn-in: phase 4's chain reaches 0.97 within its first 100
# iterations on this cohort (every causal SNP a marginal z of about 10),
# and a draw that reads the wrong packed rows (a fold's logit or slab
# mixed up) drops the effects or blows them up; 0.85 leaves room for the
# shorter chain.  11c is phase 5's LD and statistics in tiles of 256
# (band of 0.9^|i-j| as in phase 5: entries past 5 x 128 SNPs apart are
# below 1e-20 either way), re-tiled to 128: phase 5's bar SBAYES_CORR_MIN.
# 11d runs 160 chains of that fit for 20 iterations in groups of chains:
# each chain's sweep is bit for bit its K=1 launch (checked on one sweep of
# every group's first chain and chain 0), and every chain's effects finite.
BAYESR12_CORR_MIN = 0.85
GROUPED_CHAINS = 160


def fold_prior(nf):
    """BayesR's pi and fold variances: the four folds of the other phases,
    or nf folds with variances log-spaced from 1e-5 to 1e-2."""
    if nf == 4:
        return np.array([0.95, 0.02, 0.02, 0.01]), np.array([0.0, 1e-4, 1e-3, 1e-2])
    return (np.array([0.95] + [0.05 / (nf - 1)] * (nf - 1)),
            np.concatenate([[0.0], np.logspace(-5, -2, nf - 1)]))


def same(outs, what):
    """Two launches on one input must be bit-identical."""
    import torch

    if not all(torch.equal(a, b) for a, b in zip(*outs)):
        raise AssertionError(f"{what}: two runs differ (not deterministic)")


def ibrm_case(torch, TG, TB, M, y, n, m, model, B, K, nf, errs, key, seed):
    """sweep_mc (and block_draws at one block) at blocks of B with nf
    folds, K chains, against the plain versions at the bar, the kernel
    bit-identical twice.  Returns (spec, args)."""
    pi, fold = fold_prior(nf) if model == "BayesR" else (None, None)
    data = TG.prepare_gibbs_data(y, M, block=B, fold=fold, geno_dtype="int8", device=M.device)
    spec, pr, pi = make_spec(TG, model, data, m, n, nf=nf)
    args = sweep_args(torch, TG, spec, data, pr, pi, K, seed=seed)
    outs = [TB.sweep_mc(spec, *args) for _ in range(2)]
    ref = TB.sweep_mc_plain(spec, *args)
    sb = TB.mc_layout(spec, data.X_blocks)
    what = (f"sweep_mc {model} B={B} ({sb.S} sub-blocks of {sb.W}) folds={spec.n_fold} "
            f"K={K}")
    errs[key] = max(errs.get(key, 0.0), bar(ref, outs[0], what))
    same(outs, what)
    consts, X, _, xpx, vx, *per = args
    P = TB.pack_rows(spec, consts, xpx, vx, per[0], per[1], per[2], per[3], per[4], per[6],
                     torch.float32)
    b = min(1, spec.nblocks - 1)
    P_b = TB.to_block_layout(P, spec.nblocks, B)[b].contiguous()
    # block b's B columns (its sub-blocks side by side) and their Gram:
    # integer sums below 2^24, exact in f32
    Xb = X[b * sb.S:(b + 1) * sb.S].float().permute(1, 0, 2).reshape(X.shape[1], -1)[:, :B]
    Wb = (Xb.T @ Xb).contiguous()
    r0 = (per[7] @ Xb).T.contiguous()
    logpi = consts["logpi"][:, :1].T.contiguous()
    g_old = P_b[:, 1, :]
    dg_k, tr_k = TB.block_draws(spec, logpi, P_b, Wb, r0)
    dg_p, tr_p = TB.block_draws_plain(spec, logpi, P_b, Wb, r0)
    errs["block_draws_shapes"] = max(errs.get("block_draws_shapes", 0.0), bar(
        (g_old - dg_p, tr_p), (g_old - dg_k, tr_k), "block_draws " + what))
    log(f"  ok {what}, and block_draws")
    return spec, args


def summary_case(torch, TB, spec, lay, ins, what, errs, key, fire=False):
    """A summary sweep (``lay`` a dense segment, or the (tiles, cols, valid)
    of a tiled LD) against its plain version for one chain and for the
    stacked chains of ``ins`` [(g, r, P)]: the bar, bit-identical twice,
    the guard's counts equal to the plain version's, each chain of the
    batch bit for bit its K=1 launch."""
    dense = not isinstance(lay, tuple)
    run = ((lambda r, P: TB.sweep_s_segment(spec, lay, r, P, spec.n)) if dense else
           (lambda r, P, **kw: TB.sweep_s_tiled(spec, *lay, r, P, spec.n, **kw)))
    plain = ((lambda r, P: TB.sweep_s_segment_plain(spec, lay, r, P, spec.n)) if dense else
             (lambda r, P: TB.sweep_s_tiled_plain(spec, *lay, r, P, spec.n)))
    g, r, P = (torch.stack(x) for x in zip(*ins))
    K = g.shape[0]
    fired = 0
    for gg, rr, PP, label in ((g[0], r[0], P[0], "K=1"), (g, r, P, f"K={K}")):
        outs = [run(rr, PP) for _ in range(2)]
        ref = plain(rr, PP)
        torch.cuda.synchronize()
        w = f"{what} {label}"
        errs[key] = max(errs.get(key, 0.0), bar(
            (gg - ref[0], ref[1], ref[2]), (gg - outs[0][0], outs[0][1], outs[0][2]), w,
            r_index=2))
        same(outs, w)
        if not dense:
            if not torch.equal(outs[0][3], ref[3]):
                raise AssertionError(f"{w}: guard counts {outs[0][3].tolist()}, plain "
                                     f"{ref[3].tolist()}")
            fired += int(outs[0][3].sum())
    batch = run(r, P)
    for k in range(K if r.device.type == "cuda" else 0):   # a kernel's property
        if not all(torch.equal(a[k], b) for a, b in zip(batch, run(r[k], P[k]))):
            raise AssertionError(f"{what}: chain {k} differs from its K=1 launch")
    if fire and not fired:
        raise AssertionError(f"{what}: the guard did not fire")
    log(f"  ok {what}: K=1 and K={K} against the plain version, each chain bit for bit "
        f"its K=1 launch" + (f"; {fired} first draws rejected" if not dense else ""))
    return fired


def check_shapes(torch, TG, TSG, TLD, TSLD, TB, dev, errs, n=4096, m=1024):
    """Phase 3's checks of the shapes the kernels do not take as they are:
    sweep_mc and block_draws at blocks of 30, 192, 250 and 256 (sub-blocks
    of 32, 96, 128 and 128, with pad slots at 30 and 250), BayesR one chain
    and BayesCpi four, and at 12 and 16 folds (the draw chain's run-time
    fold instance) at blocks of 128; the dense segment sweep at those
    blocks; the guarded segment and tiled sweeps at 12 and 16 folds (rows
    of 136 and 184 floats a SNP, the tiled sweep re-tiled to 64); the tiled
    sweep on stores of tiles of 10 and 256 (re-tiled to 12 and 128) at a
    lowered vary where the guard rejects.  Each against its plain version
    at the bar, bit-identical twice, and each chain of a batch bit for bit
    its K=1 launch.  Returns the guard's first-draw rejections per case."""
    from hibayes_tpu_torch.data.ld import DenseLD

    gen = torch.Generator(device=dev).manual_seed(19)
    M = make_genotype(torch, n, m, gen, dev)
    y = (M[:, :64].float() @ (0.1 * torch.randn(64, generator=gen, device=dev))
         + torch.randn(n, generator=gen, device=dev)).cpu().numpy()
    for B in (30, 192, 250, 256):
        for model, K in (("BayesR", 1), ("BayesCpi", 4)):
            ibrm_case(torch, TG, TB, M, y, n, m, model, B, K, 4, errs, "sweep_mc_shapes", K)
    for nf in (12, 16):
        for K in (1, 4):
            ibrm_case(torch, TG, TB, M, y, n, m, "BayesR", 128, K, nf, errs, "sweep_mc_folds",
                      K + nf)
    del M
    sm = 1000
    LD = ar1_ld(torch, sm, dev)
    ss, _ = summary_stats(torch, lambda v: LD @ v, sm, sm, gen, dev)
    for B in (30, 192, 250, 256):
        data, spec, pr, pi = s_setup(torch, TG, TSG, ss, DenseLD(values=LD), "BayesCpi", B,
                                     dev, False)
        seg = data.ld_segs[0]
        ins = [s_sweep_inputs(torch, TSG, spec, data, pr, pi, lambda v: seg @ v, seed=5 + k)
               for k in range(4)]
        sb = TB.segment_sub_blocks(spec, B)
        summary_case(torch, TB, spec, seg, ins,
                     f"sweep_s_segment B={B} ({sb.S} sub-blocks of {sb.W})", errs,
                     "sweep_s_segment_shapes")
    fired = {}
    sld = pruned_ld(torch, TLD, sm, dev)
    ss_p, _ = summary_stats(torch, lambda v: sld.values @ v, sm, sm, gen, dev)
    tld = banded_ld(torch, TSLD, sm, dev, K=5)
    ss_t, _ = summary_stats(torch, tiled_matvec(torch, tld), sm, tld.m_pad, gen, dev)
    for nf in (12, 16):
        data, spec, pr, pi = s_setup(torch, TG, TSG, ss_p, sld, "BayesR", 64, dev, True, nf=nf)
        seg = data.ld_segs[0]
        ins = [s_sweep_inputs(torch, TSG, spec, data, pr, pi, lambda v: seg @ v, seed=7 + k)
               for k in range(4)]
        summary_case(torch, TB, spec, seg, ins, f"sweep_s_segment guarded BayesR {nf} folds",
                     errs, "seg_folds")
        data, spec, pr, pi = s_setup(torch, TG, TSG, ss_t, tld, "BayesR", 128, dev, True, nf=nf)
        lay = (data.ld_tiles, data.ld_cols, data.ld_valid)
        ins = [s_sweep_inputs(torch, TSG, spec, data, pr, pi, tiled_matvec(torch, tld),
                              seed=9 + k) for k in range(4)]
        sb = TB.tiled_sub_blocks(spec, 128)
        fired[f"folds{nf}"] = summary_case(
            torch, TB, spec, lay, ins,
            f"sweep_s_tiled BayesR {nf} folds (re-tiled to {sb.W})", errs, "tiled_folds")
    for T, K_band in ((10, 9), (256, 3)):
        tl = banded_ld(torch, TSLD, 1500, dev, T=T, K=K_band)
        ss_T, _ = summary_stats(torch, tiled_matvec(torch, tl), 1500, tl.m_pad, gen, dev)
        data, spec, pr, pi = s_setup(torch, TG, TSG, ss_T, tl, "BayesCpi", T, dev, True)
        spec = spec.__class__(**{**spec.__dict__, "vary": 2e-4})
        lay = (data.ld_tiles, data.ld_cols, data.ld_valid)
        ins = [s_sweep_inputs(torch, TSG, spec, data, pr, pi, tiled_matvec(torch, tl),
                              seed=11 + k) for k in range(4)]
        sb = TB.tiled_sub_blocks(spec, T)
        fired[f"tile{T}"] = summary_case(
            torch, TB, spec, lay, ins, f"sweep_s_tiled tile {T} (re-tiled to {sb.W}), vary 2e-4",
            errs, "tiled_retiled", fire=True)
    return fired


def time_sweep_shape(torch, TG, TB, dev, M, y, B, nf, errs, key, nbg=16):
    """sweep_mc at K=1 on the main path's genotype (phase 4's cohort) at
    blocks of B with nf BayesR folds, its first nbg blocks: the bar against
    its plain version (into errs[key]), device times of the kernel and the
    plain version, torch.mv of the two products per block as the library
    yardstick, the bound, and the full sweep.  Returns (times, bounds)."""
    n, m = M.shape
    pi, fold = fold_prior(nf)
    data = TG.prepare_gibbs_data(y, M, block=B, fold=fold, geno_dtype="int8", device=dev)
    spec, pr, pi = make_spec(TG, "BayesR", data, m, n, nf=nf)
    args = sweep_args(torch, TG, spec, data, pr, pi, 1, seed=5)
    consts, X, W, xpx, vx, *per = args
    nbg = min(nbg, spec.nblocks)
    cols = slice(0, nbg * B)
    part = (spec, consts, X, W, xpx[cols], vx[cols], *(a[:, cols] for a in per[:7]),
            per[7], per[8])
    outs = [TB.sweep_mc(*part, block_range=(0, nbg)) for _ in range(2)]
    what = f"sweep_mc at phase 4's shapes, B={B}, {nf} folds"
    errs[key] = max(errs.get(key, 0.0), bar(TB.sweep_mc_plain(*part, block_range=(0, nbg)),
                                            outs[0], what))
    same(outs, what)
    t = {key: cuda_ms(torch, lambda: TB.sweep_mc(*part, block_range=(0, nbg)), 10),
         key + "_plain": cuda_ms(torch, lambda: TB.sweep_mc_plain(*part, block_range=(0, nbg)),
                                 2),
         key + "_full": cuda_ms(torch, lambda: TB.sweep_mc(spec, *args), 3)}
    sb = TB.mc_layout(spec, X)   # X and W hold nbg S sub-blocks of W
    nbk = nbg * sb.S
    Xf = X[:nbk].float()
    t[key + "_library"] = cuda_ms(torch, mv_products(torch, Xf, per[7][0], sb.W), 10)
    del Xf
    if B <= TB.MAX_BLOCK:   # the draw chain alone on block 0 (cycles a draw)
        P = TB.pack_rows(spec, consts, xpx, vx, per[0], per[1], per[2], per[3], per[4],
                         per[6], torch.float32)
        P_b = TB.to_block_layout(P, spec.nblocks, B)[0]
        r0 = (per[7] @ X[0].float()).T
        us, cyc = chain_us(torch, TB, spec, W[0], P_b[:, :, 0].contiguous(),
                           r0[:, 0].contiguous())
        t[key + "_chain_us"], t[key + "_chain_cycles_per_draw"] = us, cyc / B
    R = TB.n_rows(spec)
    m_loc = nbg * B
    by = (nbytes(X[:nbk], W[:nbk], xpx[cols], vx[cols]) + 4 * R * m_loc + 4 * m_loc * 3
          + 2 * nbytes(per[7], per[8]))
    bounds = {key: bound(by, nbk * (4.0 * X.shape[1] * sb.W + 2.0 * sb.W * sb.W))}
    log(f"  ok {what}: {t[key]:.4f} ms (plain {t[key + '_plain']:.1f}, torch.mv "
        f"{t[key + '_library']:.4f}, bound {bounds[key][0]:.4f}); the full sweep "
        f"{t[key + '_full']:.3f} ms")
    return t, bounds


def flagship_shapes(torch, ht, TG, TB, dev, M, data, gv, args, niter_eff, thin, smi, ms4,
                    errs):
    """Phases 11a and 11b on phase 4's cohort: ibrm BayesR at blocks of
    256 (the kernels' sub-blocks of 128) for phase 4's iterations, and at
    12 folds for 50 iterations (30 burn-in), each through sweep1 only (one
    launch an iteration, no plain call), finite, its GEBV accuracy against
    its bar, ms/iter beside phase 4's; with each sweep timed beside its
    plain version at these shapes first.  Returns (numbers, times, bounds)."""
    times, bounds, out = {}, {}, {}
    for key, B, nf in (("sweep_mc_b256", 256, 4), ("sweep_mc_f12", 128, 12)):
        t, b = time_sweep_shape(torch, TG, TB, dev, M, data["y"], B, nf, errs, key)
        times.update(t)
        bounds.update(b)
    gvn = gv.cpu().numpy()
    for what, B, nf, niter, nburn, bar_min in (("11a", 256, 4, args.niter, args.nburn,
                                                GEBV_CORR_MIN),
                                               ("11b", 128, 12, 50, 30, BAYESR12_CORR_MIN)):
        pi, fold = fold_prior(nf) if nf != 4 else (None, None)   # 4: phase 4's defaults
        n_eff = nburn + ((niter - nburn) // thin) * thin
        reset_counts(TB)
        fit = ht.ibrm("y ~ x1 + (1|grp)", data=data, M=M, M_id=data["id"], method="BayesR",
                      Pi=pi, fold=fold, niter=niter, nburn=nburn, thin=thin, block=B,
                      seed=args.seed, device=dev, verbose=False)
        torch.cuda.synchronize()
        launches, plain = read_counts(TB)
        expect_counts(launches, plain, {"sweep_mc": n_eff, "sweep1": n_eff}, what)
        for k in ("Vg", "Ve", "h2"):
            if not np.isfinite(getattr(fit, k)):
                raise AssertionError(f"{what}: {k} is not finite")
        gebv = fit.g["gebv"]
        if gebv.shape != gvn.shape or not np.isfinite(gebv).all():
            raise AssertionError(f"{what}: GEBV of the wrong shape or not finite")
        acc = float(np.corrcoef(gebv, gvn)[0, 1])
        ms = 1e3 * fit.chain_seconds / n_eff
        out[what] = {"ms_per_iter": ms, "acc": acc, "launches": launches, "h2": fit.h2}
        log(f"[{what}] ibrm BayesR, blocks of {B}, {nf} folds, n={M.shape[0]} m={M.shape[1]}, "
            f"{niter} iterations: h2 {fit.h2:.4f}, GEBV corr {acc:.4f} (bar {bar_min}); "
            f"chain {fit.chain_seconds:.2f} s = {ms:.2f} ms/iter against phase 4's blocks of "
            f"128, 4 folds {ms4:.2f} on {smi}")
        if not acc >= bar_min:
            raise AssertionError(f"{what}: GEBV accuracy {acc} below {bar_min}")
        del fit
    return out, times, bounds


def tiled_shapes(torch, ht, TSLD, TSG, TG, TB, dev, ss, b_true, args, thin, smi, ms5, errs):
    """Phases 11c and 11d on phase 5's statistics: the band stored in tiles
    of 256 (built on the card), re-tiled to 128 by the sweep; the tiled
    sweep on it against its plain version (16 rows of 256) and timed; sbrm
    BayesCpi through one tiled_sweep launch an iteration only, accuracy
    against SBAYES_CORR_MIN, ms/iter beside phase 5's; then 160 chains for
    20 iterations, in groups of chains (a launch each), every chain finite,
    and one sweep on the fit's final states whose every group's first chain
    and chain 0 are bit for bit their K=1 launches."""
    t0 = time.perf_counter()
    tld = banded_ld(torch, TSLD, args.sm, dev, T=256, K=5)
    torch.cuda.synchronize()
    log(f"[11c] tiled LD m={args.sm} in tiles of 256: {tld.nbr} tile rows x {tld.k_max} slots, "
        f"{tld.tiles.numel() * 4 / 1e9:.3f} GB f32, made on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    sdata, sspec, spr, spi = s_setup(torch, TG, TSG, ss, tld, "BayesCpi", 256, dev, True)
    lay = (sdata.ld_tiles, sdata.ld_cols, sdata.ld_valid)
    t0 = time.perf_counter()
    sb = TB.tiled_sub_blocks(sspec, 256)
    TB.sub_block_tiles(*lay, sb)
    torch.cuda.synchronize()
    t_retile = time.perf_counter() - t0
    g, r, P = s_sweep_inputs(torch, TSG, sspec, sdata, spr, spi, tiled_matvec(torch, tld), 5)
    rows = 16
    part = (sdata.ld_tiles[:rows].contiguous(), sdata.ld_cols[:rows],
            sdata.ld_valid[:rows] & (sdata.ld_cols[:rows] < rows))
    cut = rows * 256
    pr_ = P[:, :cut].contiguous()
    outs = [TB.sweep_s_tiled(sspec, *part, r[:cut].contiguous(), pr_, sspec.n)
            for _ in range(2)]
    ref = TB.sweep_s_tiled_plain(sspec, *part, r[:cut].contiguous(), pr_, sspec.n)
    what = "sweep_s_tiled at 11c's shapes (16 rows of 256, re-tiled to 128)"
    errs["tiled256"] = bar((g[:cut] - ref[0], ref[1], ref[2]),
                           (g[:cut] - outs[0][0], outs[0][1], outs[0][2]), what, r_index=2)
    same(outs, what)
    times = {"tiled256": cuda_ms(torch, lambda: TB.sweep_s_tiled(
                 sspec, *part, r[:cut].contiguous(), pr_, sspec.n), 10),
             "tiled256_plain": cuda_ms(torch, lambda: TB.sweep_s_tiled_plain(
                 sspec, *part, r[:cut].contiguous(), pr_, sspec.n), 1),
             "tiled256_full": cuda_ms(torch, lambda: TB.sweep_s_tiled(
                 sspec, *lay, r, P, sspec.n), 3),
             "retile_s": t_retile}
    R = TB.summary_rows(sspec)
    nv = int(part[2].sum())
    bounds = {"tiled256": bound(nv * 256 * 256 * 4 + 4 * cut * (R + 4),
                                2.0 * nv * 256 * 256),
              "tiled256_full": bound(int(sdata.ld_valid.sum()) * 256 * 256 * 4
                                     + 4 * tld.m_pad * (R + 4),
                                     2.0 * int(sdata.ld_valid.sum()) * 256 * 256)}
    log(f"  ok {what}: {times['tiled256']:.4f} ms (plain {times['tiled256_plain']:.1f}), the "
        f"full sweep {times['tiled256_full']:.3f} ms, re-tiling once {t_retile:.2f} s")
    del sdata
    n_eff = args.nburn + ((args.niter - args.nburn) // thin) * thin
    reset_counts(TB)
    fit = ht.sbrm(ss, tld, method="BayesCpi", fold=np.array([0.0, 1.0]), niter=args.niter,
                  nburn=args.nburn, thin=thin, seed=args.seed, device=dev, verbose=False)
    torch.cuda.synchronize()
    launches, plain = read_counts(TB)
    expect_counts(launches, plain, {"sweep_s_tiled": n_eff, "tiled_sweep": n_eff}, "11c")
    acc = check_fit(fit, b_true, "11c")
    ms = 1e3 * fit.chain_seconds / n_eff
    log(f"[11c] sbrm BayesCpi on the tile-256 LD m={args.sm}: h2 {fit.h2:.4f}, corr(alpha, "
        f"b_true) {acc:.4f} (bar {SBAYES_CORR_MIN}); chain {fit.chain_seconds:.2f} s = "
        f"{ms:.2f} ms/iter against phase 5's tiles of 128 {ms5:.2f} on {smi}")
    if not acc >= SBAYES_CORR_MIN:
        raise AssertionError(f"11c: accuracy {acc} below {SBAYES_CORR_MIN}")
    out = {"11c": {"ms_per_iter": ms, "acc": acc, "launches": launches}}
    del fit
    # 11d: a batch larger than the card holds drawers at once
    C, niter, nburn = GROUPED_CHAINS, 20, 10
    n_eff = nburn + ((niter - nburn) // thin) * thin
    reset_counts(TB)
    fit = ht.sbrm(ss, tld, method="BayesCpi", fold=np.array([0.0, 1.0]), niter=niter,
                  nburn=nburn, thin=thin, seed=args.seed, device=dev, nchains=C,
                  verbose=False)
    torch.cuda.synchronize()
    launches, plain = read_counts(TB)
    sdata, sspec, spr, spi = s_setup(torch, TG, TSG, ss, tld, "BayesCpi", 256, dev, True)
    ck, vk = TB.sub_block_tiles(sdata.ld_tiles, sdata.ld_cols, sdata.ld_valid, sb)[1:]
    G = TB.tiled_group(sspec, sb.W, TB._layout_schedule(ck, vk).items.shape[0])
    groups = TB._chain_groups(C, G)
    expect_counts(launches, plain, {"sweep_s_tiled": n_eff * len(groups),
                                    "tiled_sweep": n_eff * len(groups)}, "11d")
    alpha = per_chain(fit, "alpha", C, (niter - nburn) // thin)
    if not np.isfinite(alpha).all() or np.asarray(fit.guard).shape != (C, 2):
        raise AssertionError("11d: non-finite effects or guard counts of the wrong shape")
    ms = 1e3 * fit.chain_seconds / n_eff
    accs = [float(np.corrcoef(alpha[c].mean(0), b_true)[0, 1]) for c in (0, C - 1)]
    # one sweep of all C chains from C distinct states, against K=1 launches
    ins = [s_sweep_inputs(torch, TSG, sspec, sdata, spr, spi, tiled_matvec(torch, tld), 30 + k)
           for k in range(2)]
    rs = torch.stack([ins[k % 2][1] * (1.0 + 1e-3 * k) for k in range(C)])
    Ps = torch.stack([ins[k % 2][2] for k in range(C)])
    lay = (sdata.ld_tiles, sdata.ld_cols, sdata.ld_valid)
    reset_counts(TB)
    batch = TB.sweep_s_tiled(sspec, *lay, rs, Ps, sspec.n)
    got, _ = read_counts(TB)
    if got["tiled_sweep"] != len(groups):
        raise AssertionError(f"11d: {got['tiled_sweep']} launches for {len(groups)} groups")
    firsts = sorted({0, C - 1, *(g_.start for g_ in groups)})
    for k in firsts:
        one = TB.sweep_s_tiled(sspec, *lay, rs[k], Ps[k], sspec.n)
        if not all(torch.equal(a[k], b) for a, b in zip(batch, one)):
            raise AssertionError(f"11d: chain {k} of the grouped launches differs from its "
                                 f"K=1 launch")
    times["tiled_grouped_full"] = cuda_ms(torch, lambda: TB.sweep_s_tiled(
        sspec, *lay, rs, Ps, sspec.n), 1)
    # the bar and the times on the first 16 rows of 256, all C chains
    gs = torch.stack([ins[k % 2][0][:cut] for k in range(C)])
    rc, Pc = rs[:, :cut].contiguous(), Ps[:, :, :cut].contiguous()
    outs = [TB.sweep_s_tiled(sspec, *part, rc, Pc, sspec.n) for _ in range(2)]
    ref = TB.sweep_s_tiled_plain(sspec, *part, rc, Pc, sspec.n)
    what = f"sweep_s_tiled at 11d's shapes ({C} chains, 16 rows of 256)"
    errs["tiled_grouped"] = bar((gs - ref[0], ref[1], ref[2]),
                                (gs - outs[0][0], outs[0][1], outs[0][2]), what, r_index=2)
    same(outs, what)
    times["tiled_grouped"] = cuda_ms(torch, lambda: TB.sweep_s_tiled(
        sspec, *part, rc, Pc, sspec.n), 5)
    times["tiled_grouped_plain"] = cuda_ms(torch, lambda: TB.sweep_s_tiled_plain(
        sspec, *part, rc, Pc, sspec.n), 1)
    bounds["tiled_grouped"] = bound(nv * 256 * 256 * 4 + C * 4 * cut * (R + 4),
                                    C * 2.0 * nv * 256 * 256)
    bounds["tiled_grouped_full"] = bound(
        int(sdata.ld_valid.sum()) * 256 * 256 * 4 + C * 4 * tld.m_pad * (R + 4),
        C * 2.0 * int(sdata.ld_valid.sum()) * 256 * 256)
    log(f"  ok {what}: {times['tiled_grouped']:.4f} ms (plain "
        f"{times['tiled_grouped_plain']:.1f}); one grouped sweep of the whole LD "
        f"{times['tiled_grouped_full']:.3f} ms for {C} chains")
    out["11d"] = {"ms_per_iter": ms, "launches": launches, "groups": [g_.stop - g_.start
                                                                      for g_ in groups],
                  "acc_chain0": accs[0], "acc_last": accs[1], "checked_chains": firsts}
    log(f"[11d] sbrm BayesCpi, {C} chains, {niter} iterations on the tile-256 LD: "
        f"{len(groups)} groups of {out['11d']['groups']} chains (at most {G} a launch), "
        f"{launches['tiled_sweep']} tiled_sweep launches; chains {firsts} of one grouped "
        f"sweep bit for bit their K=1 launches; accuracy chain 0 {accs[0]:.4f}, chain "
        f"{C - 1} {accs[1]:.4f} after {niter} iterations; chain {fit.chain_seconds:.2f} s = "
        f"{ms:.2f} ms/iter, {C * n_eff * args.sm / fit.chain_seconds:.4g} SNP-updates/s over "
        f"{C} chains on {smi}")
    return out, times, bounds


def profile_ssbrm_batch(torch, TG, Ai_nn, ng_ids, y_ids, n_g, m, gen, dev, K=4):
    """Phase 11e: where 10a's K-chain iteration spends its time, by the
    port's profiling helpers: device_trace (torch.profiler) over 3
    iterations of K chains at 10a's shapes (n_g + ne rows of float32
    dosages, random here; blocks of 64; the epsilon system of phase 7),
    each iteration's pre-sweep, sweep and post-sweep as annotate ranges;
    CUDA time per iteration of the rows kernel, the draws kernel, the
    epsilon kernel and the torch ops, and the ranges' host times."""
    from hibayes_tpu_torch.ops import blockgibbs as TB
    from hibayes_tpu_torch.utils import annotate, device_trace

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
    states = TG.stack_state(TG.init_state(spec, data, pr, pi), K)

    def step(st):
        noise = TG.chain_noise(1, st.it, K, dev, data.y.dtype)
        with annotate("pre_sweep"):
            pre = TG._pre_sweep(spec, data, noise, st)
        with annotate("sweep"):
            out = TB.sweep_mc(spec, pre["consts"], data.X_blocks, data.W_blocks, data.xpx,
                              data.vx, pre["vei"], st.g, *pre["rnd"], pre["vargL_in"],
                              pre["yadj"], pre["u"])
        with annotate("post_sweep"):
            return TG._post_sweep(spec, data, noise, st, pre, out)

    states = step(states)
    torch.cuda.synchronize()
    iters = 3
    logdir = tempfile.mkdtemp(prefix="profile_10a_")
    try:
        with device_trace(logdir) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                states = step(states)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        trace_mb = os.path.getsize(os.path.join(logdir, "trace.json")) / 1e6
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    dev_ms, host_ms = {}, {}
    ranges = ("pre_sweep", "sweep", "post_sweep")
    for e in prof.key_averages():
        if e.key in ranges:   # the annotations (their device spans would count twice)
            if e.cpu_time_total > 0:
                host_ms[e.key] = e.cpu_time_total / 1e3 / iters
            continue
        t = getattr(e, "self_device_time_total", 0) or 0
        if t > 0:
            dev_ms[e.key] = dev_ms.get(e.key, 0.0) + t / 1e3 / iters
    part = lambda key: sum(v for k, v in dev_ms.items() if key in k)
    split = {"rows_mc_kernel": part("rows_mc_kernel"), "draws_kernel": part("draws_kernel"),
             "mme_sweep_kernel": part("mme_sweep_kernel")}
    split["torch_ops"] = sum(dev_ms.values()) - sum(split.values())
    split["device_busy"] = sum(dev_ms.values())
    split["wall"] = 1e3 * wall / iters
    split["host_ranges"] = host_ms
    split["trace_mb"] = trace_mb
    log(f"[11e] 10a's iteration at K={K} (n={n}, m={m}, qe={Ai_nn.shape[0]}), device_trace "
        f"over {iters} iterations, ms per iteration by CUDA time: rows_mc_kernel "
        f"{split['rows_mc_kernel']:.3f}, draws_kernel {split['draws_kernel']:.3f}, "
        f"mme_sweep_kernel {split['mme_sweep_kernel']:.3f}, torch ops "
        f"{split['torch_ops']:.3f}; device busy {split['device_busy']:.3f} of a "
        f"{split['wall']:.3f} ms wall; host time of the annotated ranges "
        f"{json.dumps({k: round(v, 3) for k, v in host_ms.items()})}; trace {trace_mb:.1f} MB")
    return split


# ---------------------------------------------------------------------------
# phase 12: multi-GPU (parallel/), the pipeline emulation, kernel 9 at a row_base
# ---------------------------------------------------------------------------

# Phase 12's ranks: two processes joined by torch.distributed, NCCL with a
# card each where there are two cards, else gloo with both on cuda:0 (NCCL
# refuses two ranks on one device).  Two ranks on one card time-slice it:
# their times say nothing of a two-card machine.
MESH_RANKS = 2
MESH_SEED = 1212          # the flagship cohort of phase 12, made alike on every rank
PIPE_ITERS = 50           # 12a: iterations of the 4-chain pipeline emulation
RANK_ITERS = 10           # 12b (iii): iterations timed on the ranks
HYBRID_ITERS = 3          # 12b (ii): a block's all_reduce crosses gloo between processes
RANK_TIMEOUT_S = 600      # the spawn's limit: a rank that hangs fails the run
# 12a's chains after PIPE_ITERS iterations (half burn-in): each chain is
# phase 4's recipe in another block order, so its GEBV accuracy keeps phase
# 4's bar (11b measured 0.93-0.97 after 50 iterations of a chain of this
# cohort's recipe).
PIPE_GEBV_CORR_MIN = GEBV_CORR_MIN
# Phase 13, the relaxed concurrent schedule: merge rounds of 13a(iii) and
# 13b(viii), and 13a(i)'s bar on the merged yadj of one emulated f32 sweep
# against _recompute_residuals of its effects: the kernel bar's residual
# term (each of 512 blocks adds X_b dg in f32, and the recompute sums
# 65,536 SNPs' products in f32; both are rounding, far below it).
CONC_ROUNDS = 2
CONC_RESYNC_REL = 1e-4
# 13a(ii)/(iii)'s GEBV bar.  The concurrent kernel is biased where m > n
# (PARITY.md: GEBV corr 0.947 with the exact chain, Vg -32%, Ve +52% at
# n=4,096 x m=65,536, S=8), so its bar rests on a study at this cell's
# m/n: scripts/concurrent_accuracy.py (the flagship recipe on the CPU at
# n=1,000, m=1,311, 10 causal SNPs, seeds 2024 and 1212, and at n=2,000,
# seed 2024) read GEBV accuracy at S=4, Rm=1 0.9838, 0.9759 and 0.9797
# against the exact chain's 0.9829, 0.9708 and 0.9716 (200 iterations);
# at Rm=2 0.9624, 0.9610 and 0.9484, or after 50 iterations 0.9502,
# 0.9425 and 0.9306 (exact 0.9672, 0.9635, 0.9410): a loss of at most
# 0.023, not growing with n.  Phase 4's exact chain reads 0.978 and 12b(i)'s 0.977 on
# the card, so phase 4's bar (and PIPE_GEBV_CORR_MIN's, after 50
# iterations) still leaves room, and a sweep that draws against the wrong
# residual falls far below it.
CONC_GEBV_CORR_MIN = GEBV_CORR_MIN


def flagship12(torch, dev, args):
    """Phase 12's flagship cohort (phase 4's recipe, seed MESH_SEED), the
    same on every rank and in the parent."""
    gen = torch.Generator(device=dev).manual_seed(MESH_SEED)
    return simulate(torch, args.n, args.m, gen, dev)


def flagship12_chain(torch, TG, M, y, dev, K, B=128, schedule="turn", emulate=0, rounds=1):
    """The flagship's data, spec (BayesR, nblocks a multiple of the ranks;
    ``schedule``, ``emulate`` shards and merge ``rounds``), priors, pi and
    a mid-run state of K chains (one chain: no chain axis) made from the
    exact engine's own iteration 0, whatever the schedule."""
    data = TG.prepare_gibbs_data(y, M, block=B, geno_dtype="int8", device=dev,
                                 fold=fold_prior(4)[1], nblocks_multiple=MESH_RANKS)
    spec, pr, pi = make_spec(TG, "BayesR", data, M.shape[1], M.shape[0])
    exact = spec.__class__(**{**spec.__dict__, "resync_every": 0})
    spec = exact.__class__(**{**exact.__dict__, "shard_schedule": schedule,
                              "emulate_shards": emulate, "merge_rounds": rounds})
    st = TG.init_state(exact, data, pr, pi)
    if K > 1:
        st = TG.one_iteration_batch(exact, data, MESH_SEED, TG.stack_state(st, K))
    else:
        st = TG.one_iteration(exact, data, MESH_SEED, st)
    return data, spec, pr, pi, st


def state_bar(ref, out, what):
    """The kernel bar between two chain states (one chain, or chain by
    chain): effects and mixture draws, residuals when none flips."""
    many = ref.g.dim() > 1
    errs = [bar((ref.g[k], ref.track[k], None, ref.yadj[k]),
                (out.g[k], out.track[k], None, out.yadj[k]), f"{what} chain {k}")
            for k in range(ref.g.shape[0])] if many else [
        bar((ref.g, ref.track, None, ref.yadj), (out.g, out.track, None, out.yadj), what)]
    return max(errs)


def pipeline_emulation(torch, ht, TG, TB, dev, args, smi, errs):
    """12a: the flagship with 4 chains and emulate_shards=4 on one card.  One
    sweep from the same inputs (16 sweep1 launches, three of four with an
    offset block range): group 0's chain against the one-device K=1 sweep,
    bit for bit where the kernel sums alike, else at the kernel bar; then
    PIPE_ITERS iterations through ibrm: ms/iter and each chain's GEBV
    accuracy.  Also the emulation at emulate_shards=2 on 12b(iii)'s inputs,
    which the ranks' pipeline must equal bit for bit.  Returns its
    results."""
    M, data, gv = flagship12(torch, dev, args)
    gd, spec, pr, pi, st = flagship12_chain(torch, TG, M, data["y"], dev, 4, emulate=4,
                                            schedule="pipeline")
    ins = sweep_args(torch, TG, spec, gd, pr, pi, 4, 12)
    reset_counts(TB)
    emu = TG._sweep_pipeline_emu_mc(spec, *ins)
    torch.cuda.synchronize()
    launches, plain = read_counts(TB)
    if launches["sweep1"] != 16 or plain:
        raise AssertionError(f"12a: the emulation's sweep made {launches} launches, "
                             f"{plain} plain calls; expected 16 sweep1")
    one = TB.sweep_mc(spec, {k: v[:1] for k, v in ins[0].items()}, *ins[1:5],
                      *(a[:1] for a in ins[5:]))
    names = ("g", "track", "vargL", "yadj", "u")
    same = all(torch.equal(a[:1], b) for a, b in zip(emu[:5], one[:5]))
    errs["pipeline_group0"] = bar((one[0][0], one[1][0], None, one[3][0]),
                                  (emu[0][0], emu[1][0], None, emu[3][0]),
                                  "12a group 0 against the one-device sweep")
    diff = {nm: float((a[:1].double() - b.double()).abs().max())
            for nm, a, b in zip(names, emu[:5], one[:5])}
    log(f"[12a] one emulated sweep (4 chains, emulate_shards=4): {launches['sweep1']} sweep1 "
        f"launches; group 0 bit for bit the one-device K=1 sweep: {same} (max |diff| "
        f"{json.dumps(diff)})")
    spec2 = spec.__class__(**{**spec.__dict__, "emulate_shards": 2})
    emu2 = TG.one_iteration_batch(spec2, gd, MESH_SEED, st)
    ref2 = {k: getattr(emu2, k).cpu().numpy() for k in ("g", "track", "yadj", "u", "vare")}
    t_emu = cuda_ms(torch, lambda: TG._sweep_pipeline_emu_mc(spec, *ins), 3)
    t_one = cuda_ms(torch, lambda: TB.sweep_mc(spec, {k: v[:1] for k, v in ins[0].items()},
                                               *ins[1:5], *(a[:1] for a in ins[5:])), 3)
    del ins, gd, st, emu, emu2
    torch.cuda.empty_cache()
    reset_counts(TB)
    fit = ht.ibrm("y ~ x1 + (1|grp)", data=data, M=M, M_id=data["id"], method="BayesR",
                  niter=PIPE_ITERS, nburn=PIPE_ITERS // 2, thin=5, block=128, nchains=4,
                  shard_schedule="pipeline", emulate_shards=4, seed=args.seed, device=dev,
                  verbose=False)
    torch.cuda.synchronize()
    launches, plain = read_counts(TB)
    expect_counts(launches, plain, {"sweep_mc": 16 * PIPE_ITERS, "sweep1": 16 * PIPE_ITERS},
                  "12a")
    n_rec = (PIPE_ITERS - PIPE_ITERS // 2) // 5
    gvn = gv.cpu().numpy()
    accs = [corr(g, gvn) for g in chain_gebv(fit, 4, n_rec)]
    ms = 1e3 * fit.chain_seconds / PIPE_ITERS
    log(f"[12a] ibrm BayesR 4 chains, pipeline emulated on 4 shards, {PIPE_ITERS} "
        f"iterations: {ms:.2f} ms/iter on {smi}; GEBV accuracy per chain "
        f"{[round(a, 4) for a in accs]} (bar {PIPE_GEBV_CORR_MIN}); one emulated sweep "
        f"{t_emu:.3f} ms against one chain's one-device sweep {t_one:.3f} ms")
    if not min(accs) >= PIPE_GEBV_CORR_MIN:
        raise AssertionError(f"12a: a chain's GEBV accuracy {min(accs)} below "
                             f"{PIPE_GEBV_CORR_MIN}")
    del fit, M, data, gv
    torch.cuda.empty_cache()
    return {"launches_one_sweep": 16, "group0_bit_for_bit": same, "group0_diff": diff,
            "ms_per_iter": ms, "gebv_acc": accs, "sweep_ms": t_emu, "one_chain_sweep_ms": t_one,
            "emulate2": ref2}


def concurrent_s2(torch, TG, dev, args):
    """13b(vii)'s reference: one iteration of the flagship's one chain from
    flagship12_chain's state (MESH_SEED's noise) under the concurrent
    emulation at S = 2, Rm = 1, the fields the ranks' (1, 2) run must equal
    bit for bit."""
    M, data, _ = flagship12(torch, dev, args)
    gd, spec, _, _, st = flagship12_chain(torch, TG, M, data["y"], dev, 1,
                                          schedule="concurrent", emulate=MESH_RANKS)
    out = TG.one_iteration(spec, gd, MESH_SEED, st)
    ref = {k: getattr(out, k).cpu().numpy() for k in ("g", "track", "yadj", "u", "vara",
                                                     "vare", "pi")}
    del M, data, gd, st, out
    torch.cuda.empty_cache()
    return ref


def concurrent_emulation(torch, ht, TG, TB, dev, args, smi, errs, exact_gebv):
    """13a, the concurrent schedule emulated on one card on the flagship
    cohort of phase 12 (n=50,000 x m=65,536, BayesR, int8, 512 blocks of
    128).  (i) One emulated sweep at S=4, Rm=1, K=1 from flagship12_chain's
    state: four sweep1 launches of 128 blocks; group 0 bit for bit the
    one-device sweep's first 16,384 SNPs; group 1 bit for bit its own
    launch and at the bar against its plain version; the merged yadj
    within CONC_RESYNC_REL of _recompute_residuals of the new effects;
    bit-identical twice.  (ii) ibrm(shard_schedule="concurrent",
    emulate_shards=4) with phase 4's recipe: the m > n warning, sweep1 S
    times an iteration, ms/iter, the GEBV's correlation with 12b(i)'s exact
    chain on this cohort (``exact_gebv``) and its accuracy against
    CONC_GEBV_CORR_MIN.  (iii) ibrm(nchains=4, ..., merge_rounds=2) for
    PIPE_ITERS iterations: the K-chain kernels at every group, each chain's
    accuracy against CONC_GEBV_CORR_MIN.  Returns its results."""
    import warnings

    from hibayes_tpu_torch.engine.rng import IterNoise

    M, data, gv = flagship12(torch, dev, args)
    gd, spec, pr, pi, st = flagship12_chain(torch, TG, M, data["y"], dev, 1)
    S = 4
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # m > n: checked in (ii)
        emu_spec = spec.__class__(**{**spec.__dict__, "shard_schedule": "concurrent",
                                     "emulate_shards": S})
    pre = TG._pre_sweep(spec, gd, IterNoise(MESH_SEED, st.it, dev), st)
    reset_counts(TB)
    emu = TG._run_sweep_k1(emu_spec, gd, pre, st.g)
    torch.cuda.synchronize()
    launches = read_counts(TB)[0]
    if launches["sweep1"] != S or launches["sweep_mc"] != S:
        raise AssertionError(f"13a(i): the emulated sweep made {launches}; expected {S} sweep1")
    again = TG._run_sweep_k1(emu_spec, gd, pre, st.g)
    if not all(torch.equal(a, b) for a, b in zip(emu, again)):
        raise AssertionError("13a(i): two emulated sweeps differ (not deterministic)")
    one = TG._run_sweep_k1(spec, gd, pre, st.g)
    mg = spec.m_pad // S
    same0 = all(torch.equal(a[:mg], b[:mg]) for a, b in zip(emu[:3], one[:3]))
    if not same0:
        raise AssertionError("13a(i): group 0 is not the one-device sweep's first "
                             f"{mg} SNPs bit for bit")
    b = lambda v: v[None]
    sl = slice(mg, 2 * mg)
    g1 = (spec, {k: b(v) for k, v in pre["consts"].items()}, gd.X_blocks, gd.W_blocks,
          gd.xpx[sl], gd.vx[sl],
          *(b(a)[:, sl] for a in (pre["vei"], st.g, *pre["rnd"], pre["vargL_in"])),
          b(pre["yadj"]), b(pre["u"]))
    nbg = spec.nblocks // S
    kern = TB.sweep_mc(*g1, block_range=(nbg, nbg))
    t0 = time.perf_counter()
    ref = TB.sweep_mc_plain(*g1, block_range=(nbg, nbg))
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    if not all(torch.equal(a[0], e[sl]) for a, e in zip(kern[:3], emu[:3])):
        raise AssertionError("13a(i): group 1 of the emulation is not its own launch")
    errs["concurrent_group1"] = bar((ref[0][0], ref[1][0], None, ref[3][0]),
                                    (kern[0][0], kern[1][0], None, kern[3][0]),
                                    "13a(i) group 1 against its plain version")
    ya_rec, _ = TG._recompute_residuals(spec, gd, pre["mu"], pre["beta"], pre["estR"],
                                        emu[0], pre["J_beta"], pre["epsl_estR"],
                                        pre["k_estR"])
    drift = float((emu[3] - ya_rec).abs().max() / ya_rec.abs().max())
    if not drift <= CONC_RESYNC_REL:
        raise AssertionError(f"13a(i): merged yadj {drift:.3g} of max|yadj| from the "
                             f"recomputed one (bar {CONC_RESYNC_REL})")
    t_emu = cuda_ms(torch, lambda: TG._run_sweep_k1(emu_spec, gd, pre, st.g), 3)
    t_one = cuda_ms(torch, lambda: TG._run_sweep_k1(spec, gd, pre, st.g), 3)
    log(f"[13a] (i) one emulated concurrent sweep (S={S}, Rm=1, K=1): {S} sweep1 launches of "
        f"{nbg} blocks, bit-identical twice; group 0 bit for bit the one-device sweep's first "
        f"{mg} SNPs; group 1 at the bar against its plain version (max |g| error "
        f"{errs['concurrent_group1']:.3g}; plain {t_plain:.1f} s); merged yadj {drift:.3g} "
        f"of max|yadj| from the recomputed residual (bar {CONC_RESYNC_REL}); the sweep "
        f"{t_emu:.3f} ms against the one-device sweep {t_one:.3f} ms on {smi}")
    del pre, emu, again, one, kern, ref, g1, ya_rec, gd, st
    torch.cuda.empty_cache()
    res = {"i": {"group0_bit_for_bit": same0, "group1_max_abs_err": errs["concurrent_group1"],
                 "yadj_drift_rel": drift, "sweep_ms": t_emu, "one_device_sweep_ms": t_one,
                 "plain_group1_s": t_plain}}

    thin = 5
    niter_eff = args.nburn + ((args.niter - args.nburn) // thin) * thin
    gvn = gv.cpu().numpy()
    reset_counts(TB)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        fit = ht.ibrm("y ~ x1 + (1|grp)", data=data, M=M, M_id=data["id"], method="BayesR",
                      niter=args.niter, nburn=args.nburn, thin=thin, block=128, seed=args.seed,
                      device=dev, verbose=False, shard_schedule="concurrent", emulate_shards=S)
    torch.cuda.synchronize()
    warned = [str(x.message) for x in w if "block-Jacobi" in str(x.message)]
    if (args.m > args.n) != bool(warned) or (
            warned and f"m ({args.m}) > n ({args.n})" not in warned[0]):
        raise AssertionError(f"13a(ii): the m > n warning where m={args.m}, n={args.n}: "
                             f"{[str(x.message) for x in w]}")
    launches, plain = read_counts(TB)
    expect_counts(launches, plain, {"sweep_mc": S * niter_eff, "sweep1": S * niter_eff},
                  "13a(ii)")
    acc = corr(fit.g["gebv"], gvn)
    with_exact = corr(fit.g["gebv"], exact_gebv)
    ms = 1e3 * fit.chain_seconds / niter_eff
    res["ii"] = {"ms_per_iter": ms, "gebv_acc": acc, "corr_with_exact": with_exact,
                 "Vg": fit.Vg, "Ve": fit.Ve, "launches": launches, "warned": bool(warned)}
    log(f"[13a] (ii) ibrm BayesR, concurrent emulated on {S} shards, {niter_eff} iterations: "
        f"the m > n warning {'caught' if warned else 'not raised (m <= n)'}; {ms:.2f} ms/iter "
        f"on {smi}; GEBV accuracy {acc:.4f} (bar "
        f"{CONC_GEBV_CORR_MIN}), corr with 12b(i)'s exact chain {with_exact:.4f}; Vg "
        f"{fit.Vg:.4f} Ve {fit.Ve:.4f}")
    if not acc >= CONC_GEBV_CORR_MIN:
        raise AssertionError(f"13a(ii): GEBV accuracy {acc} below {CONC_GEBV_CORR_MIN}")
    del fit

    reset_counts(TB)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        fit = ht.ibrm("y ~ x1 + (1|grp)", data=data, M=M, M_id=data["id"], method="BayesR",
                      niter=PIPE_ITERS, nburn=PIPE_ITERS // 2, thin=5, block=128, nchains=4,
                      seed=args.seed, device=dev, verbose=False, shard_schedule="concurrent",
                      emulate_shards=S, merge_rounds=CONC_ROUNDS)
    torch.cuda.synchronize()
    launches, plain = read_counts(TB)
    groups = S * CONC_ROUNDS
    nbg = spec.nblocks // groups
    expect_counts(launches, plain, {"sweep_mc": groups * PIPE_ITERS,
                                    "rows_mc_kernel": groups * PIPE_ITERS * (nbg + 1),
                                    "draws_kernel": groups * PIPE_ITERS * nbg}, "13a(iii)")
    n_rec = (PIPE_ITERS - PIPE_ITERS // 2) // 5
    accs = [corr(g, gvn) for g in chain_gebv(fit, 4, n_rec)]
    ms3 = 1e3 * fit.chain_seconds / PIPE_ITERS
    res["iii"] = {"ms_per_iter": ms3, "gebv_acc": accs, "launches": launches}
    log(f"[13a] (iii) ibrm BayesR 4 chains, concurrent emulated on {S} shards x "
        f"{CONC_ROUNDS} rounds ({groups} groups of {nbg} blocks), {PIPE_ITERS} iterations: "
        f"{ms3:.2f} ms/iter on {smi}; GEBV accuracy per chain "
        f"{[round(a, 4) for a in accs]} (bar {CONC_GEBV_CORR_MIN})")
    if not min(accs) >= CONC_GEBV_CORR_MIN:
        raise AssertionError(f"13a(iii): a chain's GEBV accuracy {min(accs)} below "
                             f"{CONC_GEBV_CORR_MIN}")
    del fit, M, data, gv
    torch.cuda.empty_cache()
    return res


def row_base_kernel(torch, TSLD, TSG, TG, TB, dev, errs, sspec, sdata, spr, spi, tld):
    """The tiled sweep at a row_base: a store of 64 tile rows of phase 5's
    recipe swept as each shard of 2 and of 4 against the whole r_hat, the
    kernel against the plain version at the bar (guard counts equal) and
    bit-identical on a second launch; then timed on the last shard of 4
    beside its plain version, and on shard 1 of 2 of phase 5's own store.
    Returns (times, bounds)."""
    small = banded_ld(torch, TSLD, 64 * 128, dev)
    ss, _ = summary_stats(torch, tiled_matvec(torch, small), small.m, small.m_pad,
                          torch.Generator(device=dev).manual_seed(77), dev)
    data, spec, pr, pi = s_setup(torch, TG, TSG, ss, small, "BayesCpi", 128, dev, True)
    g, r, P = s_sweep_inputs(torch, TSG, spec, data, pr, pi, tiled_matvec(torch, small), 5)
    T, nbr = spec.block, data.ld_tiles.shape[0]
    shard_err, rej = {}, {}
    for S in (2, 4):
        nl = nbr // S
        for k in range(S):
            b0 = k * nl
            rows = slice(b0, b0 + nl)
            a = (data.ld_tiles[rows].contiguous(), data.ld_cols[rows].contiguous(),
                 data.ld_valid[rows].contiguous(), r, P[:, b0 * T:(b0 + nl) * T].contiguous(),
                 spec.n)
            out = TB.sweep_s_tiled(spec, *a, row_base=b0)
            again = TB.sweep_s_tiled(spec, *a, row_base=b0)
            ref = TB.sweep_s_tiled_plain(spec, *a, row_base=b0)
            if not all(torch.equal(x, y) for x, y in zip(out, again)):
                raise AssertionError(f"tiled sweep at row_base {b0}: a second launch differs")
            if int(out[3]) != int(ref[3]):
                raise AssertionError(f"tiled sweep at row_base {b0}: guard counts "
                                     f"{int(out[3])} against {int(ref[3])}")
            gk = g[b0 * T:(b0 + nl) * T]
            shard_err[f"{k}/{S}"] = bar((gk - ref[0], ref[1], ref[2]),
                                        (gk - out[0], out[1], out[2]),
                                        f"tiled sweep, shard {k} of {S}", r_index=2)
            rej[f"{k}/{S}"] = int(out[3])
    errs["tiled_row_base"] = max(shard_err.values())
    log(f"  ok tiled sweep at a row_base, every shard of 2 and of 4 (64 tile rows of 128): "
        f"max |g| error {json.dumps(shard_err)}; first draws rejected {json.dumps(rej)}; "
        f"each bit-identical on a second launch")
    b0, nl = 48, 16
    rows = slice(b0, b0 + nl)
    a = (data.ld_tiles[rows].contiguous(), data.ld_cols[rows].contiguous(),
         data.ld_valid[rows].contiguous(), r, P[:, b0 * T:].contiguous(), spec.n)
    t = {"tiled_row_base": cuda_ms(torch, lambda: TB.sweep_s_tiled(spec, *a, row_base=b0), 10),
         "tiled_row_base_plain": cuda_ms(
             torch, lambda: TB.sweep_s_tiled_plain(spec, *a, row_base=b0), 1)}
    nv = int(a[2].sum())
    bnd = {"tiled_row_base": bound(nv * T * T * 4 + nbytes(*a[1:5]) + 4 * (r.numel() * 2
                                                                         + 2 * nl * T + nl),
                                   2.0 * T * T * (nv + nl))}
    # shard 1 of 2 of phase 5's store, the whole r_hat
    g5, r5, P5 = s_sweep_inputs(torch, TSG, sspec, sdata, spr, spi, tiled_matvec(torch, tld), 9)
    nbr5 = sdata.ld_tiles.shape[0]
    h = nbr5 // 2
    rows = slice(h, nbr5)
    a5 = (sdata.ld_tiles[rows], sdata.ld_cols[rows].contiguous(),
          sdata.ld_valid[rows].contiguous(), r5, P5[:, h * T:].contiguous(), sspec.n)
    t["tiled_row_base_shard"] = cuda_ms(torch, lambda: TB.sweep_s_tiled(sspec, *a5, row_base=h),
                                        3)
    nv5 = int(a5[2].sum())
    bnd["tiled_row_base_shard"] = bound(
        nv5 * T * T * 4 + nbytes(*a5[1:5]) + 4 * (r5.numel() * 2 + 2 * (nbr5 - h) * T),
        2.0 * T * T * (nv5 + nbr5 - h))
    log(f"  tiled sweep at a row_base, times (ms): 16 rows at row_base 48 "
        f"{t['tiled_row_base']:.4f} (plain {t['tiled_row_base_plain']:.1f}); shard 1 of 2 of "
        f"phase 5's store ({nbr5 - h} rows at row_base {h}) {t['tiled_row_base_shard']:.4f}; "
        f"bounds {json.dumps(bnd)}")
    return t, bnd


def mesh_ranks(torch, args, after8, emu12a, emu13):
    """12b: MESH_RANKS processes (spawned here) run the port's mesh paths
    (rank12); a rank that fails fails the run.  Returns rank 0's results
    with every rank's launch counts."""
    import torch.multiprocessing as mp

    backend = "nccl" if torch.cuda.device_count() >= MESH_RANKS else "gloo"
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="mesh_", dir=root)
    try:
        init = "file://" + os.path.join(tmp, "rendezvous")
        payload = {"args": vars(args), "backend": backend, "init": init, "out": tmp,
                   "fileset": after8, "emu2": emu12a, "emu13": emu13}
        log(f"[12b] {MESH_RANKS} ranks, backend {backend}, "
            f"{'a card each' if backend == 'nccl' else 'both on cuda:0 (time-sliced)'}")
        ctx = mp.start_processes(rank12, args=(MESH_RANKS, payload), nprocs=MESH_RANKS,
                                 join=False, start_method="spawn")
        t_end = time.time() + RANK_TIMEOUT_S
        try:
            while not ctx.join(timeout=max(1.0, t_end - time.time())):
                if time.time() > t_end:
                    raise AssertionError(f"12b: the ranks did not end in {RANK_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        import pickle

        res = []
        for r in range(MESH_RANKS):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                res.append(pickle.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = res[0]
    out["launches_all_ranks"] = {
        k: {name: sum(r["launches"][k][name] for r in res) for name in res[0]["launches"][k]}
        for k in res[0]["launches"]}
    out["backend"] = backend
    return out


def rank12(rank, world, payload):
    """One rank of 12b: (vi) its rows of 9a's fileset, then (i)-(v)
    on the meshes (1, 2) and (2, 1).  Writes its results to
    <out>/rank<r>.pkl; raises (so the spawn fails) on any failed check."""
    import pickle

    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import hibayes_tpu_torch as ht
    from hibayes_tpu_torch.data import sparse_ld as TSLD
    from hibayes_tpu_torch.engine import gibbs as TG
    from hibayes_tpu_torch.engine import sgibbs as TSG
    from hibayes_tpu_torch.ops import blockgibbs as TB
    from hibayes_tpu_torch.parallel import distributed as D
    from hibayes_tpu_torch.parallel.mesh import gather_state, make_mesh

    args = argparse.Namespace(**payload["args"])
    backend = payload["backend"]
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    world_, me = D.init_multihost(payload["init"], world, rank, backend=backend)
    assert (world_, me) == (world, rank)
    m12, m21 = make_mesh(shape=(1, world), device=dev), make_mesh(shape=(world, 1), device=dev)
    lead = rank == 0
    say = (lambda msg: log(msg)) if lead else (lambda msg: None)
    res, launches, thin = {}, {}, 5
    niter_eff = args.nburn + ((args.niter - args.nburn) // thin) * thin

    def run(what, fn):
        """fn() with the launch counts from 0 and the collectives timed."""
        reset_counts(TB)
        D.reset_collective_timer(timed=True)
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[what] = read_counts(TB)[0]
        coll = D.COLLECTIVES["seconds"]
        D.reset_collective_timer(timed=False)
        return out, wall, coll

    # (vi) this rank's rows of 9a's fileset
    import hashlib

    t0 = time.perf_counter()
    fs, local = D.load_plink_host_sharded(payload["fileset"]["stem"], m21)
    r0, rc = D.process_row_range(payload["fileset"]["n"], m21)
    digest = hashlib.sha256(np.ascontiguousarray(fs["geno"].values).tobytes()).hexdigest()
    if digest != payload["fileset"]["rows_sha256"][rank] or local.shape[0] != rc:
        raise AssertionError(f"12b(vi) rank {rank}: rows {r0}..{r0 + rc} differ from "
                             "9a's whole read")
    del fs, local
    say(f"[12b] (vi) load_plink_host_sharded: each rank's rows of 9a's fileset bit "
        f"for bit the whole read's ({time.perf_counter() - t0:.1f} s)")

    # (i) the flagship on (1, 2), turn, one chain
    M, data, gv = flagship12(torch, dev, args)
    gd, spec, pr, pi, st = flagship12_chain(torch, TG, M, data["y"], dev, 1)
    ref = TG.one_iteration(spec, gd, MESH_SEED, st)
    out, wall, coll = run("i_one", lambda: gather_state(
        TG.one_iteration(spec, gd, MESH_SEED, st, mesh=m12), m12, spec.n))
    err_i = state_bar(ref, out, "12b(i) one iteration on (1, 2)")
    fit, wall, coll = run("i", lambda: ht.ibrm(
        "y ~ x1 + (1|grp)", data=data, M=M, M_id=data["id"], method="BayesR",
        niter=args.niter, nburn=args.nburn, thin=thin, block=128, seed=args.seed,
        device=dev, verbose=False, mesh=m12))
    acc = corr(fit.g["gebv"], gv.cpu().numpy())
    res["i"] = {"max_abs_err": err_i, "ms_per_iter": 1e3 * fit.chain_seconds / niter_eff,
                "collective_share": coll / max(fit.chain_seconds, 1e-9), "gebv_acc": acc}
    res["exact_gebv"] = fit.g["gebv"]   # 13a(ii) correlates the concurrent chain with it
    say(f"[12b] (i) flagship on (1, 2), turn: one iteration at the bar against one device "
        f"(max |g| error {err_i:.3g}); {niter_eff} iterations {res['i']['ms_per_iter']:.2f} "
        f"ms/iter, collectives {100 * res['i']['collective_share']:.1f}% of it; GEBV "
        f"accuracy {acc:.4f} (bar {GEBV_CORR_MIN}) on {smi_line()}")
    if not acc >= GEBV_CORR_MIN:
        raise AssertionError(f"12b(i): GEBV accuracy {acc} below {GEBV_CORR_MIN}")
    del fit

    # (ii) the flagship on (2, 1), the ind hybrid
    out, wall, coll = run("ii_one", lambda: gather_state(
        TG.one_iteration(spec, gd, MESH_SEED, st, mesh=m21), m21, spec.n))
    err_ii = state_bar(ref, out, "12b(ii) one iteration on (2, 1)")

    def iters(mesh, sp, s0, k):
        s = s0
        for _ in range(k):
            s = (TG.one_iteration_batch if s.g.dim() > 1 else TG.one_iteration)(
                sp, gd, MESH_SEED, s, mesh=mesh)
        return s

    from hibayes_tpu_torch.parallel.mesh import shard_state

    _, wall, coll = run("ii", lambda: iters(m21, spec, shard_state(st, m21, spec.n),
                                            HYBRID_ITERS))
    res["ii"] = {"max_abs_err": err_ii, "ms_per_iter": 1e3 * wall / HYBRID_ITERS,
                 "collective_share": coll / wall}
    say(f"[12b] (ii) flagship on (2, 1), the ind hybrid (draws_kernel a block, r0 summed "
        f"over ind): one iteration at the bar (max |g| error {err_ii:.3g}); "
        f"{res['ii']['ms_per_iter']:.2f} ms/iter, collectives "
        f"{100 * res['ii']['collective_share']:.1f}%")
    del gd, st, ref, out

    # (iii) the flagship on (1, 2), the ring pipeline, 4 chains
    gd, spec4, pr, pi, st4 = flagship12_chain(torch, TG, M, data["y"], dev, 4,
                                              schedule="pipeline")
    out, wall, coll = run("iii_one", lambda: gather_state(
        TG.one_iteration_batch(spec4, gd, MESH_SEED, st4, mesh=m12), m12, spec4.n))
    emu = payload["emu2"]
    same = {k: bool(np.array_equal(getattr(out, k).cpu().numpy(), emu[k])) for k in emu}
    if not all(same.values()):
        raise AssertionError(f"12b(iii): the pipeline on 2 ranks is not 12a's emulation "
                             f"at emulate_shards=2 bit for bit: {same}")
    _, wall, coll = run("iii", lambda: iters(m12, spec4, st4, RANK_ITERS))
    res["iii"] = {"bit_for_bit_emulation": True, "ms_per_iter": 1e3 * wall / RANK_ITERS,
                  "collective_share": coll / wall}
    say(f"[12b] (iii) flagship 4 chains on (1, 2), ring pipeline: one iteration bit for bit "
        f"12a's emulation at emulate_shards=2; {res['iii']['ms_per_iter']:.2f} ms/iter, "
        f"collectives {100 * res['iii']['collective_share']:.1f}%")
    del gd, st4, out

    # 13b (vii) the flagship on (1, 2), the concurrent schedule, one merge round
    t13 = time.perf_counter()
    gd, specc, pr, pi, stc = flagship12_chain(torch, TG, M, data["y"], dev, 1,
                                              schedule="concurrent")
    out, wall, coll = run("vii_one", lambda: gather_state(
        TG.one_iteration(specc, gd, MESH_SEED, stc, mesh=m12), m12, specc.n))
    emu = payload["emu13"]
    same = {k: bool(np.array_equal(getattr(out, k).cpu().numpy(), emu[k])) for k in emu}
    if not all(same.values()):
        raise AssertionError(f"13b(vii): the concurrent sweep on 2 ranks is not the emulation "
                             f"at S=2 bit for bit: {same}")
    _, wall, coll = run("vii", lambda: iters(m12, specc, stc, RANK_ITERS))
    res["vii"] = {"bit_for_bit_emulation": True, "ms_per_iter": 1e3 * wall / RANK_ITERS,
                  "collective_share": coll / wall}
    say(f"[13b] (vii) flagship on (1, 2), concurrent, one merge round (ya + all_reduce of the "
        f"ranks' deltas): one iteration bit for bit the emulation at S=2; "
        f"{res['vii']['ms_per_iter']:.2f} ms/iter, collectives "
        f"{100 * res['vii']['collective_share']:.1f}% on {smi_line()}")
    del gd, stc, out, M, data, gv
    torch.cuda.empty_cache()
    t13 = time.perf_counter() - t13

    # (iv) phase 5's LD on (1, 2), turn, kernel 9 at its row_base: its
    # recipe at the nearest m whose tile rows the ranks divide (500,224 for
    # 500,000: 3,908 rows of 128), as the JAX package shards only then
    sm = -(-args.sm // (128 * world)) * 128 * world
    tld = banded_ld(torch, TSLD, sm, dev)
    ss, b_true = summary_stats(torch, tiled_matvec(torch, tld), sm, tld.m_pad,
                               torch.Generator(device=dev).manual_seed(MESH_SEED), dev)
    sdata, sspec, spr, spi = s_setup(torch, TG, TSG, ss, tld, "BayesCpi", 128, dev, True)
    g, r, P = s_sweep_inputs(torch, TSG, sspec, sdata, spr, spi, tiled_matvec(torch, tld), 9)
    one = TB.sweep_s_tiled(sspec, sdata.ld_tiles, sdata.ld_cols, sdata.ld_valid, r, P, sspec.n)
    part = TSG._on_mesh(sdata, m12)[0]
    tally = torch.zeros(2, dtype=torch.int64, device=dev)
    (dg, tr, rh), wall, coll = run("iv_one", lambda: TSG._tiled_sweep_snp_sharded(
        sspec, part, r, P, m12, tally))
    err_iv = bar((g - one[0], one[1], one[2]), (g - dg, tr, rh), "12b(iv) one sweep on (1, 2)",
                 r_index=2)
    if int(tally[0]) != int(one[3]):
        raise AssertionError(f"12b(iv): guard counts {int(tally[0])} on the mesh against "
                             f"{int(one[3])} on one device")
    del part, one, g, r, P, dg, tr, rh
    fit, wall, coll = run("iv", lambda: ht.sbrm(
        ss, tld, method="BayesCpi", fold=np.array([0.0, 1.0]), niter=args.niter,
        nburn=args.nburn, thin=thin, seed=args.seed, device=dev, verbose=False, mesh=m12))
    acc = check_fit(fit, b_true, "12b(iv) sbrm on (1, 2)")
    res["iv"] = {"max_abs_err": err_iv, "guard_rejected": int(tally[0]),
                 "ms_per_iter": 1e3 * fit.chain_seconds / niter_eff,
                 "collective_share": coll / max(fit.chain_seconds, 1e-9), "acc": acc}
    say(f"[12b] (iv) sbrm tiled m={sm} on (1, 2), turn (tiled sweep at row_base 0 and "
        f"{tld.nbr // world}): one sweep at the bar against one device (max |g| error "
        f"{err_iv:.3g}, guard counts equal: {int(tally[0])}); "
        f"{res['iv']['ms_per_iter']:.2f} ms/iter, collectives "
        f"{100 * res['iv']['collective_share']:.1f}%; accuracy {acc:.4f} (bar {SBAYES_CORR_MIN})")
    if not acc >= SBAYES_CORR_MIN:
        raise AssertionError(f"12b(iv): accuracy {acc} below {SBAYES_CORR_MIN}")
    del fit, sdata

    # 13b (viii) phase 5's LD on (1, 2), concurrent in CONC_ROUNDS merge rounds:
    # one sweep of a 64-row store of its recipe against the plain version of
    # the same rounds, then the fit on the m=500,224 store
    t0 = time.perf_counter()
    small = banded_ld(torch, TSLD, 64 * 128, dev)
    ss_s, _ = summary_stats(torch, tiled_matvec(torch, small), small.m, small.m_pad,
                            torch.Generator(device=dev).manual_seed(77), dev)
    d_s, sp_s, pr_s, pi_s = s_setup(torch, TG, TSG, ss_s, small, "BayesCpi", 128, dev, True)
    sp_c = sp_s.__class__(**{**sp_s.__dict__, "shard_schedule": "concurrent",
                             "merge_rounds": CONC_ROUNDS})
    g_s, r_s, P_s = s_sweep_inputs(torch, TSG, sp_c, d_s, pr_s, pi_s,
                                   tiled_matvec(torch, small), 5)
    part_s = TSG._on_mesh(d_s, m12)[0]
    tallies = [torch.zeros(2, dtype=torch.int64, device=dev) for _ in range(3)]
    outc, _, _ = run("viii_one", lambda: TSG._tiled_sweep_snp_sharded(
        sp_c, part_s, r_s, P_s, m12, tallies[0]))
    again = TSG._tiled_sweep_snp_sharded(sp_c, part_s, r_s, P_s, m12, tallies[1])
    with plain_route(TB, "sweep_s_tiled"):
        refc = TSG._tiled_sweep_snp_sharded(sp_c, part_s, r_s, P_s, m12, tallies[2])
    if not all(torch.equal(a, b) for a, b in zip(outc, again)):
        raise AssertionError("13b(viii): two concurrent tiled sweeps differ")
    if not (torch.equal(tallies[0], tallies[1]) and torch.equal(tallies[0], tallies[2])):
        raise AssertionError(f"13b(viii): guard counts {[t.tolist() for t in tallies]} "
                             "(kernel, again, plain)")
    err_viii = bar((g_s - refc[0], refc[1], refc[2]), (g_s - outc[0], outc[1], outc[2]),
                   "13b(viii) one concurrent sweep on (1, 2)", r_index=2)
    del small, d_s, part_s, outc, again, refc, g_s, r_s, P_s
    fit, wall, coll = run("viii", lambda: ht.sbrm(
        ss, tld, method="BayesCpi", fold=np.array([0.0, 1.0]), niter=args.niter,
        nburn=args.nburn, thin=thin, seed=args.seed, device=dev, verbose=False, mesh=m12,
        shard_schedule="concurrent", merge_rounds=CONC_ROUNDS))
    acc = check_fit(fit, b_true, "13b(viii) sbrm concurrent on (1, 2)")
    res["viii"] = {"max_abs_err": err_viii, "guard": tallies[0].tolist(),
                   "ms_per_iter": 1e3 * fit.chain_seconds / niter_eff,
                   "collective_share": coll / max(fit.chain_seconds, 1e-9), "acc": acc,
                   "s": time.perf_counter() - t0}
    say(f"[13b] (viii) sbrm tiled on (1, 2), concurrent in {CONC_ROUNDS} merge rounds: one "
        f"sweep of a 64-row store at the bar against the plain rounds (max |g| error "
        f"{err_viii:.3g}, guard counts equal: {tallies[0].tolist()}), bit-identical twice; "
        f"m={sm}: {res['viii']['ms_per_iter']:.2f} ms/iter, collectives "
        f"{100 * res['viii']['collective_share']:.1f}%; accuracy {acc:.4f} (bar "
        f"{SBAYES_CORR_MIN})")
    if not acc >= SBAYES_CORR_MIN:
        raise AssertionError(f"13b(viii): accuracy {acc} below {SBAYES_CORR_MIN}")
    t13 += time.perf_counter() - t0
    res["seconds_13b"] = t13
    del fit, tld
    torch.cuda.empty_cache()

    # (v) a small ssbrm, the epsilon term on, on (2, 1) and (1, 2)
    sids, ssir, sdam, _, _ = make_pedigree(150, 2850, args.seed + 1)
    srng = np.random.default_rng(args.seed + 1)
    sg = sids[np.sort(srng.choice(3000, 600, replace=False))]
    sM = torch.randint(0, 3, (600, 2048), generator=torch.Generator(device=dev).manual_seed(5),
                       device=dev, dtype=torch.int8)
    sphe = sids[srng.choice(3000, 900, replace=False)]
    skw = dict(data={"id": sphe, "y": srng.normal(size=900)}, M=sM, M_id=sg,
               pedigree={"id": sids, "sire": ssir, "dam": sdam}, niter=3, nburn=1, thin=1,
               seed=args.seed, device=dev, verbose=False, impute="pcg", chunk_cols=512)
    res["v"] = {}
    for shape, mesh in (("2x1", m21), ("1x2", m12)):
        fit, wall, coll = run(f"v_{shape}", lambda mesh=mesh: ht.ssbrm("y ~ 1", mesh=mesh, **skw))
        vare = fit.MCMCsamples["Ve"]
        if not (np.isfinite(vare).all() and np.isfinite(fit.Veps)):
            raise AssertionError(f"12b(v) ssbrm on {shape}: vare {vare}, Veps {fit.Veps}")
        res["v"][shape] = {"vare": [float(v) for v in vare], "Veps": float(fit.Veps),
                           "s": wall}
    say(f"[12b] (v) ssbrm (3,000 ids, 600 genotyped, m=2048, the epsilon term on), 3 "
        f"iterations on (2, 1) and (1, 2): finite vare {json.dumps(res['v'])}")
    res["launches"] = launches
    with open(os.path.join(payload["out"], f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


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
    ap.add_argument("--qs-n", type=int, default=50_000, help="individuals of phase 8")
    ap.add_argument("--qs-m", type=int, default=65_536, help="SNPs of phase 8")
    ap.add_argument("--qs-chr", type=int, default=16, help="chromosomes of phase 8")
    ap.add_argument("--bs-n", type=int, default=20_000,
                    help="individuals of phase 9's BSLMM fit (m is --m)")
    ap.add_argument("--rs-n", type=int, default=4096, help="individuals of phase 9c's ibrm")
    ap.add_argument("--rs-m", type=int, default=8192,
                    help="SNPs of phase 9c's ibrm and tiled LD (the BlockDiagLD: 2 x m/8)")
    args = ap.parse_args(argv)
    t_main = time.perf_counter()
    phase_s, t_phase = {}, [t_main]

    def mark(name):   # the seconds of the phase that ends here
        phase_s[name] = round(time.perf_counter() - t_phase[0], 1)
        t_phase[0] = time.perf_counter()

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
    mark("1-2")

    # ---- 3. kernels vs plain ----
    t0 = time.perf_counter()
    errs = check_kernels(torch, TG, TB, dev, n=4096, m=1024, B=128)
    errs.update(sweep_s_segment=0.0, sweep_s_tiled=0.0, sweep_mc_k=0.0,
                sweep_s_segment_k=0.0)
    nrej = check_s_kernels(torch, TG, TSG, TSLD, TB, dev, errs)
    check_kernels_mc(torch, TG, TB, dev, errs)
    check_segment_mc(torch, TG, TSG, TB, dev, errs)
    from hibayes_tpu_torch.data import ld as TLD

    errs.update(sweep_s_segment_guard=0.0, sweep_s_tiled64=0.0, sweep_mc_qs=0.0)
    fired = check_guard_kernels(torch, TG, TSG, TLD, TSLD, TB, dev, errs)
    errs.update(sweep_s_tiled_k=0.0, mme_sweep_k=0.0)
    fired_k = check_tiled_mc(torch, TG, TSG, TSLD, TB, dev, errs)
    check_mme_mc(torch, TG, TB, dev, errs)
    fired_shapes = check_shapes(torch, TG, TSG, TLD, TSLD, TB, dev, errs)
    t13_phase3 = time.perf_counter()
    check_concurrent_emulation(torch, TG, TB, dev, errs)
    t13_phase3 = time.perf_counter() - t13_phase3
    log(f"[3] kernel checks passed in {time.perf_counter() - t0:.1f} s: {errs}; "
        f"the guard rejected {nrej} first draws at the lowered vary (tile 128); "
        f"guarded segment and tile-64 counts at the lowered vary {json.dumps(fired)}; "
        f"K-chain tiled counts per chain at the lowered vary {json.dumps(fired_k)}; "
        f"re-tiled and many-fold tiled first draws rejected {json.dumps(fired_shapes)}")

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

    mark("3")

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
    expect_counts(launches, plain, {"sweep_mc": niter_eff, "sweep1": niter_eff}, "4")
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
    mark("4")

    # ---- 11a, 11b. the flagship at blocks of 256 and with 12 folds ----
    flag11, t11, b11 = flagship_shapes(torch, hibayes_tpu_torch, TG, TB, dev, M, data, gv,
                                       args, niter_eff, thin, smi,
                                       1e3 * chain_s / niter_eff, errs)
    times.update(t11)
    bounds.update(b11)
    torch.cuda.empty_cache()
    mark("11a-11b")

    # ---- 4b. the flagship with 4 chains, to read R-hat ----
    split4 = profile_chains(torch, TG, TB, M, data["y"], 4, "BayesR", smi, B)
    flag = ibrm_chains(torch, hibayes_tpu_torch, TB, M, data, gv, "BayesR", 4, args.niter,
                       args.nburn, args.seed, smi, "4b", GEBV_CORR_MIN,
                       FLAGSHIP_CHAINS_CORR_MIN, RHAT_VE_MAX_FLAGSHIP, B)
    del M, data, gv
    torch.cuda.empty_cache()
    mark("4b")

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
    mark("4c")

    # ---- 5. sbrm main path: tiled LD ----
    t0 = time.perf_counter()
    tld = banded_ld(torch, TSLD, args.sm, dev)
    ss, b_true = summary_stats(torch, tiled_matvec(torch, tld), args.sm, tld.m_pad, gen, dev)
    torch.cuda.synchronize()
    log(f"[5] tiled LD m={args.sm}: {tld.nbr} tile rows x {tld.k_max} slots, "
        f"{tld.n_tiles} tiles, {tld.tiles.numel() * 4 / 1e9:.3f} GB f32, and the "
        f"statistics made on the card in {time.perf_counter() - t0:.1f} s")
    sdata, sspec, spr, spi = s_setup(torch, TG, TSG, ss, tld, "BayesCpi", 128, dev, True)
    t_tiled, b_tiled = time_tiled(torch, TSG, TB, sspec, sdata, spr, spi, tld, errs, K=4)
    times.update(t_tiled)
    bounds.update(b_tiled)
    log(f"[5] sweep_s_tiled matches its plain version at the main path's shapes; "
        f"times (ms) on {smi}: {json.dumps(t_tiled)}; bounds {json.dumps(b_tiled)}")
    t_rb, b_rb = row_base_kernel(torch, TSLD, TSG, TG, TB, dev, errs, sspec, sdata, spr, spi,
                                 tld)
    times.update(t_rb)
    bounds.update(b_rb)
    log(f"[5] draw chain alone, per block of {B} draws in one warp, on {smi}: BayesR "
        f"(4 folds) {times['chain_bayesr_us']:.3f} us ({times['chain_bayesr_cycles']:.0f} "
        f"cycles, {times['chain_bayesr_cycles'] / B:.1f} a draw), BayesCpi "
        f"{times['chain_bayescpi_us']:.3f} us ({times['chain_bayescpi_cycles']:.0f}, "
        f"{times['chain_bayescpi_cycles'] / B:.1f} a draw), BayesCpi with the guard "
        f"{times['chain_bayescpi_guard_us']:.3f} us ({times['chain_bayescpi_guard_cycles']:.0f}, "
        f"{times['chain_bayescpi_guard_cycles'] / B:.1f} a draw)")
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
    mark("5")

    # ---- 10b. the tiled chain with 4 chains (phase 5's LD and statistics) ----
    ms5 = 1e3 * fit.chain_seconds / niter_eff
    del fit
    tiled4 = tiled_chains(torch, hibayes_tpu_torch, TB, ss, tld, b_true, 4, args, niter_eff,
                          thin, smi, ms5)
    mark("10b")
    del tld
    torch.cuda.empty_cache()

    # ---- 11c, 11d. phase 5's LD in tiles of 256; 160 chains in groups ----
    tiled11, t11c, b11c = tiled_shapes(torch, hibayes_tpu_torch, TSLD, TSG, TG, TB, dev, ss,
                                       b_true, args, thin, smi, ms5, errs)
    times.update(t11c)
    bounds.update(b11c)
    torch.cuda.empty_cache()
    mark("11c-11d")

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
    expect_counts(d_launches, plain, {"sweep_s_segment": niter_eff,
                                      "segment_sweep": niter_eff}, "6")
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
                                       "segment_sweep": niter_eff}, "6b")
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
    mark("6-6b")

    # ---- 7. ssbrm: pedigree, imputation, epsilon Gibbs ----
    n_ids, ss_m = args.ss_ids, args.ss_m
    nfound, n_g = n_ids // 20, n_ids // 5
    t0 = time.perf_counter()
    ids, sires, dams, gi, phe, Mg, gv, y, depth = ssbrm_cohort(torch, n_ids, ss_m, args.seed,
                                                                gen, dev)
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
    split10a = profile_ssbrm_batch(torch, TG, Ai_nn, ng_ids, ids[phe], n_g, ss_m,
                                   torch.Generator(device=dev).manual_seed(23), dev)
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
    expect_counts(e_launches, plain, {"sweep_mc": niter_eff, "mme_sweep": niter_eff,
                                      "mme_sweep_kernel": niter_eff,
                                      "sweep1": niter_eff}, "7")
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
    ms7 = 1e3 * fit.chain_seconds / niter_eff
    veps7 = fit.Veps
    del fit
    torch.cuda.empty_cache()
    mark("7")

    # ---- 10a. the ssbrm path with 4 chains (phase 7's cohort) ----
    ss4 = ssbrm_chains(torch, hibayes_tpu_torch, TB, dict(
        data={"id": ids[phe], "y": y}, M=Mg, M_id=ids[gi],
        pedigree={"id": ids, "sire": sires, "dam": dams}), ids, gi, phe, gv, 4, args,
        niter_eff, thin, smi, ms7, times, veps7)
    del Mg
    mark("10a")

    # ---- 8. the README quick start from PLINK files, and on its fileset
    # 9a: the command line killed and resumed ----
    torch.cuda.empty_cache()
    os.makedirs(os.path.join(os.path.dirname(os.path.abspath(__file__)), "build"),
                exist_ok=True)
    kept = tempfile.mkdtemp(prefix="fileset_", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))

    def after8(stem, bed, pheno):
        # 9a and 12b(vi) read the first CLI_CHR chromosomes of this fileset,
        # written again into a directory kept until 12b, with their rows by
        # rank
        import hashlib

        from hibayes_tpu_torch.data.plink import encode_bed_bytes

        nchr = min(CLI_CHR, args.qs_chr)
        vals = bed["geno"].values[:, :bed["geno"].values.shape[1] // args.qs_chr * nchr]
        sub = os.path.join(kept, "cohort")
        t0 = time.perf_counter()
        write_fileset(np.ascontiguousarray(vals), pheno, nchr, sub, encode_bed_bytes)
        sbed = hibayes_tpu_torch.read_plink(sub)
        if not np.array_equal(sbed["geno"].values, vals):
            raise AssertionError("phase 9a: the chromosomes' fileset reads back otherwise")
        log(f"[9a] the first {nchr} chromosomes ({vals.shape[1]} SNPs) written and read "
            f"back bit for bit in {time.perf_counter() - t0:.1f} s")
        per = -(-vals.shape[0] // MESH_RANKS)
        keep = {"stem": sub, "n": int(vals.shape[0]),
                "rows_sha256": [hashlib.sha256(np.ascontiguousarray(
                    vals[r * per:(r + 1) * per]).tobytes()).hexdigest()
                    for r in range(MESH_RANKS)]}
        return cli_resume(torch, hibayes_tpu_torch, TB, dev, sub, sbed, pheno, args, smi,
                          thin), keep

    qs, t_qs, b_qs = quickstart(
        torch, hibayes_tpu_torch, TG, TSG, TB, dev, gen, args, smi, errs, thin, after=after8)
    cli_res, fileset12 = qs["after"]
    times.update(t_qs)
    bounds.update(b_qs)
    torch.cuda.empty_cache()
    mark("8-9a")

    # ---- 9b. BSLMM at n=20,000 x m=65,536; 9c. a resume on each engine ----
    t0 = time.perf_counter()
    bs, t_bs, b_bs = bslmm(torch, hibayes_tpu_torch, TG, TB, dev, gen, args, smi, errs, thin)
    times.update(t_bs)
    bounds.update(b_bs)
    torch.cuda.empty_cache()
    t9b = time.perf_counter() - t0
    mark("9b")
    t0 = time.perf_counter()
    rs = resumes(torch, hibayes_tpu_torch, TG, TSG, TLD, TSLD, TB, dev, gen, args)
    t9c = time.perf_counter() - t0
    mark("9c")
    log(f"[9] phase 9 took {cli_res['wall_s'] + t9b + t9c:.1f} s: 9a {cli_res['wall_s']:.1f}, "
        f"9b {t9b:.1f}, 9c {t9c:.1f}; the whole run so far {time.perf_counter() - t_main:.1f} s")

    # ---- 12. multi-GPU: the pipeline emulated on one card, then ranks ----
    gc.collect()
    torch.cuda.empty_cache()
    pipe = pipeline_emulation(torch, hibayes_tpu_torch, TG, TB, dev, args, smi, errs)
    mark("12a")
    t0 = time.perf_counter()
    emu13 = concurrent_s2(torch, TG, dev, args)
    t13_s2 = time.perf_counter() - t0
    try:
        mesh12 = mesh_ranks(torch, args, fileset12, pipe.pop("emulate2"), emu13)
    finally:
        shutil.rmtree(kept, ignore_errors=True)
    want12 = {"i": ("sweep1",), "ii": ("draws_kernel",), "iii": ("rows_mc_kernel",
                                                                  "draws_kernel"),
              "iv": ("tiled_sweep",), "v_2x1": ("draws_kernel", "mme_sweep_kernel"),
              "v_1x2": ("sweep1", "mme_sweep_kernel"), "vii": ("sweep1",),
              "viii_one": ("tiled_sweep",), "viii": ("tiled_sweep",)}
    for run_, names in want12.items():
        got = mesh12["launches_all_ranks"][run_]
        if not all(got[k] > 0 for k in names):
            raise AssertionError(f"12b({run_}): kernels {names} not launched: {got}")
    # 13b's counts exactly: a local sweep a rank and merge round, an iteration
    want13 = {"vii": ("sweep1", MESH_RANKS * RANK_ITERS),
              "viii_one": ("tiled_sweep", MESH_RANKS * CONC_ROUNDS),
              "viii": ("tiled_sweep", MESH_RANKS * CONC_ROUNDS * niter_eff)}
    for run_, (k, n_) in want13.items():
        if mesh12["launches_all_ranks"][run_][k] != n_:
            raise AssertionError(f"13b({run_}): {k} launched "
                                 f"{mesh12['launches_all_ranks'][run_][k]} times, not {n_}")
    log(f"[12b] launches by run, summed over the ranks: "
        f"{json.dumps(mesh12['launches_all_ranks'])}")
    mark("12b")

    # ---- 13a. the concurrent schedule emulated on one card ----
    conc = concurrent_emulation(torch, hibayes_tpu_torch, TG, TB, dev, args, smi, errs,
                                mesh12.pop("exact_gebv"))
    mark("13a")
    t13 = t13_phase3 + t13_s2 + phase_s["13a"] + mesh12["seconds_13b"]
    log(f"[13] phase 13 took {t13:.1f} s: its phase 3 cases {t13_phase3:.1f}, 13b(vii)'s "
        f"reference {t13_s2:.1f}, 13a {phase_s['13a']:.1f}, 13b on the ranks "
        f"{mesh12['seconds_13b']:.1f}; the whole run so far "
        f"{time.perf_counter() - t_main:.1f} s")

    # ---- 10. results ----
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
                                  "BayesCpi": times["chain_bayescpi_us"]},
              resumed_ibrm_4_chains_launches=rs["ibrm_4_chains"]["launches"]["rows_mc_kernel"],
              ssbrm_4_chains_launches=ss4["launches"]["rows_mc_kernel"],
              concurrent_4_chains_launches=conc["iii"]["launches"]["rows_mc_kernel"],
              concurrent_4_chains_ms_per_iter=conc["iii"]["ms_per_iter"]),
        entry("sweep1_kernel_for_kernel1", src, "hibayes_tpu/ops/blockgibbs.py:138",
              launches["sweep1"], errs["sweep_mc"], "sweep_mc",
              library_ms=times["sweep_mc_library"],
              timed=f"sweep_mc at K=1, n={n_rows} (as row 3)"),
        entry("sweep1_kernel_for_kernel8", src, "hibayes_tpu/ops/blockgibbs.py:1371",
              launches["sweep1"], errs["sweep_mc_k8"], "sweep_mc_k8",
              library_ms=times["sweep_mc_k8_library"],
              timed="sweep_mc at K=1, n=131,072",
              block_split_us=times["sweep_mc_k8_split"]),
        entry("sweep1_kernel", src, "hibayes_tpu/ops/blockgibbs.py:642", launches["sweep1"],
              errs["sweep_mc"], "sweep_mc", library_ms=times["sweep_mc_library"],
              library="torch.mv of X_b' r and X_b dg, 16 blocks, float32 copy of the int8 blocks",
              sweep_mc_launches=launches["sweep_mc"],
              quickstart_ibrm_launches=qs["ibrm_launches"]["sweep1"],
              quickstart_max_abs_err=errs["sweep_mc_qs"], quickstart_ms=times["sweep_mc_qs"],
              quickstart_plain_ms=times["sweep_mc_qs_plain"],
              quickstart_bound_ms=bounds["sweep_mc_qs"][0],
              quickstart_timed="phase 8's int8 genotype, B=64, 16 blocks, BayesCpi, K=1",
              block_split_us=times["sweep_mc_split"],
              full_sweep_ms=times["sweep_full"],
              chain_cycles_per_draw={"BayesR_4_folds": times["chain_bayesr_cycles"] / B},
              ssbrm_launches=e_launches["sweep1"], ssbrm_ms=times["sweep_mc_ssbrm"],
              ssbrm_plain_ms=times["sweep_mc_ssbrm_plain"],
              ssbrm_bound_ms=bounds["sweep_mc_ssbrm"][0],
              bslmm_launches=bs["launches"]["sweep1"],
              bslmm_max_abs_err=errs["sweep_mc_bslmm"], bslmm_ms=times["sweep_mc_bslmm"],
              bslmm_plain_ms=times["sweep_mc_bslmm_plain"],
              bslmm_bound_ms=bounds["sweep_mc_bslmm"][0],
              bslmm_timed=f"BSLMM's int8 genotype, B=64, n={args.bs_n} not padded, 16 blocks, K=1",
              cli_uninterrupted_launches=cli_res["launches"]["sweep1"],
              resumed_ssbrm_launches=rs["ssbrm"]["launches"]["sweep1"],
              concurrent_emulation_launches=conc["ii"]["launches"]["sweep1"],
              concurrent_emulation_max_abs_err=errs["concurrent_group1"],
              concurrent_emulation_sweep_ms=conc["i"]["sweep_ms"],
              concurrent_mesh_launches=mesh12["launches_all_ranks"]["vii"]["sweep1"],
              concurrent_phase3_max_abs_err=errs["concurrent_emulation"]),
        entry("draws_kernel", src, "hibayes_tpu/ops/blockgibbs.py:1264",
              flag["launches"]["draws_kernel"], errs["block_draws"], "block_draws",
              launches_from="phase 4b (4 chains; one chain sweeps through sweep1_kernel)",
              resumed_ibrm_4_chains_launches=rs["ibrm_4_chains"]["launches"]["draws_kernel"],
              concurrent_4_chains_launches=conc["iii"]["launches"]["draws_kernel"],
              segment_draw_chains_in="segment_sweep (phases 6 and 6b)",
              chain_cycles_per_draw={
                  "BayesR_4_folds": times["chain_bayesr_cycles"] / B,
                  "BayesCpi": times["chain_bayescpi_cycles"] / B,
                  "BayesCpi_guard": times["chain_bayescpi_guard_cycles"] / B}),
        entry("segment_sweep", ssrc, "hibayes_tpu/ops/blockgibbs.py:1141",
              d_launches["segment_sweep"], errs["sweep_s_segment"], "sweep_s_segment",
              library_ms=times["sweep_s_segment_library"],
              sweep_s_segment_launches=d_launches["sweep_s_segment"],
              block_split_us=times["sweep_s_segment_split"],
              k4_launches=d4_launches["segment_sweep"],
              k4_max_abs_err=errs["sweep_s_segment_k"], k4_ms=times["sweep_s_segment_k4"],
              k4_bound_ms=bounds["sweep_s_segment_k4"][0],
              k4_library_ms=times["sweep_s_segment_k4_library"],
              k4_block_split_us=times["sweep_s_segment_k4_split"]),
        entry("segment_sweep_guarded", ssrc, "hibayes_tpu/ops/blockgibbs.py:1141",
              qs["sbrm_blockdiag"]["launches"]["segment_sweep"]
              + qs["sbrm_sparse"]["launches"]["segment_sweep"],
              errs["sweep_s_segment_guard"], "seg_guard",
              library_ms=times["seg_guard_library"],
              timed="phase 8's first chromosome block, BayesCpi, SBayesS guard",
              replaces_also="hibayes_tpu/engine/sgibbs.py:309 (the guarded XLA scan)",
              blockdiag_launches=qs["sbrm_blockdiag"]["launches"]["segment_sweep"],
              sparse_launches=qs["sbrm_sparse"]["launches"]["segment_sweep"],
              guard_counts={k: qs["sbrm_" + k]["guard"] for k in ("blockdiag", "sparse")},
              block_split_us=times["seg_guard_split"], k4_ms=times["seg_guard_k4"],
              k4_plain_ms=times["seg_guard_k4_plain"], k4_bound_ms=bounds["seg_guard_k4"][0],
              k4_library_ms=times["seg_guard_k4_library"],
              resumed_blockdiag_4_chains_launches=rs["sbrm_blockdiag_4_chains"]["launches"][
                  "segment_sweep"],
              resumed_blockdiag_4_chains_guard=rs["sbrm_blockdiag_4_chains"]["guard"]),
        entry("tiled_sweep_tile64", ssrc, "hibayes_tpu/ops/blockgibbs.py:1635",
              qs["sbrm_tiled"]["launches"]["tiled_sweep"], errs["sweep_s_tiled64"], "tiled64",
              library_ms=times["tiled64_library"],
              library="torch.bmm of the 16 rows' tiles, every slot, with their row's dg",
              timed="phase 8's tiled LD, first 16 tile rows of 64",
              guard_counts=qs["sbrm_tiled"]["guard"],
              full_sweep_ms=times["tiled64_full"],
              full_sweep_bound_ms=bounds["tiled64_full"][0],
              full_sweep_split=times["tiled64_split"],
              chain_us_per_block_of_64={"BayesCpi": times["tiled64_chain_bayescpi_us"],
                                        "BayesCpi_guard":
                                            times["tiled64_chain_bayescpi_guard_us"]}),
        entry("sweep_s_tiled", ssrc, "hibayes_tpu/ops/blockgibbs.py:1635",
              s_launches["sweep_s_tiled"], errs["sweep_s_tiled"], "sweep_s_tiled",
              library_ms=times["sweep_s_tiled_library"],
              library="torch.bmm of the 16 rows' tiles, every slot, with their row's dg",
              tiled_sweep_launches=s_launches["tiled_sweep"],
              full_sweep_ms=times["sweep_s_tiled_full"],
              full_sweep_bound_ms=bounds["sweep_s_tiled_full"][0],
              full_sweep_split=times["sweep_s_tiled_split"],
              chain_us_per_block={"BayesCpi": times["chain_bayescpi_us"],
                                  "BayesCpi_guard": times["chain_bayescpi_guard_us"]},
              resumed_launches=rs["sbrm_tiled"]["launches"]["tiled_sweep"]),
        entry("mme_sweep_kernel", "hibayes_tpu_torch/csrc/mme.cu",
              "hibayes_tpu/ops/blockgibbs.py:1805",
              e_launches["mme_sweep_kernel"], errs["mme_sweep"], "mme_sweep",
              library_ms=times["mme_library"], mme_sweep_launches=e_launches["mme_sweep"],
              cold_ms=times["mme_sweep_cold"], full_sweep_ms=times["mme_sweep_full"],
              full_sweep_cold_ms=times["mme_sweep_full_cold"],
              full_sweep_bound_ms=bounds["mme_sweep_full"][0],
              full_sweep_dense_layout_bound_ms=bounds["mme_sweep_full_dense_layout"][0],
              chain_cycles_per_draw=times["mme_chain_cycles_per_draw"],
              chain_latency_floor_ms=times["mme_chain_floor_ms"],
              block_split_us=times["mme_sweep_split"],
              target_distance_rows=times["mme_target_distance_rows"],
              resumed_launches=rs["ssbrm"]["launches"]["mme_sweep_kernel"]),
        entry("tiled_sweep_k_chains", ssrc, "hibayes_tpu/ops/blockgibbs.py:1635",
              tiled4["launches"]["tiled_sweep"], errs["sweep_s_tiled_k"], "sweep_s_tiled_k4",
              library_ms=times["sweep_s_tiled_k4_library"],
              library="torch.bmm of the 16 rows' tiles, every slot, with the 4 chains' dg",
              timed="phase 5's tiled LD, first 16 tile rows of 128, K=4 chains, BayesCpi, guard",
              launches_from="phase 10b (sbrm, 4 chains, m=500,000)",
              k1_ms=times["sweep_s_tiled"], full_sweep_ms=times["sweep_s_tiled_k4_full"],
              full_sweep_k1_ms=times["sweep_s_tiled_full"],
              full_sweep_bound_ms=bounds["sweep_s_tiled_k4_full"][0],
              full_sweep_host_ms=times["sweep_s_tiled_k4_full_host"],
              full_sweep_split=times["sweep_s_tiled_k4_split"],
              ms_per_iter=tiled4["ms_per_iter"], guard_counts=tiled4["guard"],
              resumed_launches=rs["sbrm_tiled_4_chains"]["launches"]["tiled_sweep"]),
        entry("mme_sweep_kernel_k_chains", "hibayes_tpu_torch/csrc/mme.cu",
              "hibayes_tpu/ops/blockgibbs.py:1805",
              ss4["launches"]["mme_sweep_kernel"], errs["mme_sweep_k"], "mme_sweep_k4",
              library_ms=times["mme_k4_library"],
              library="torch.linalg.solve_triangular, batched: block 0 of each of 4 chains",
              timed="phase 7's layout, first 16 blocks of 64, K=4 chains",
              launches_from="phase 10a (ssbrm, 4 chains, qe=80,000)",
              k1_ms=times["mme_sweep"], full_sweep_ms=times["mme_sweep_k4_full"],
              full_sweep_cold_ms=times["mme_sweep_k4_full_cold"],
              full_sweep_k1_ms=times["mme_sweep_full"],
              full_sweep_bound_ms=bounds["mme_sweep_k4_full"][0],
              chain_latency_floor_ms=times["mme_chain_floor_ms"],
              ms_per_iter=ss4["ms_per_iter"],
              resumed_launches=rs["ssbrm_4_chains"]["launches"]["mme_sweep_kernel"],
              split_10a_ms=split10a),
        entry("sweep1_kernel_blocks_of_256", src, "hibayes_tpu/ops/blockgibbs.py:642",
              flag11["11a"]["launches"]["sweep1"], errs["sweep_mc_b256"], "sweep_mc_b256",
              library_ms=times["sweep_mc_b256_library"],
              library="torch.mv of X_b' r and X_b dg, 16 blocks of 256, float32 copy",
              timed="phase 4's genotype at blocks of 256 (sub-blocks of 128), 16 blocks, "
                    "BayesR, K=1",
              launches_from="phase 11a", full_sweep_ms=times["sweep_mc_b256_full"],
              ms_per_iter=flag11["11a"]["ms_per_iter"],
              shapes_max_abs_err={"sweep_mc": errs["sweep_mc_shapes"],
                                  "block_draws": errs["block_draws_shapes"],
                                  "segment": errs["sweep_s_segment_shapes"]}),
        entry("sweep1_kernel_12_folds", src, "hibayes_tpu/ops/blockgibbs.py:1264",
              flag11["11b"]["launches"]["sweep1"], errs["sweep_mc_f12"], "sweep_mc_f12",
              library_ms=times["sweep_mc_f12_library"],
              library="torch.mv of X_b' r and X_b dg, 16 blocks of 128, float32 copy",
              timed="phase 4's genotype, BayesR with 12 folds (the run-time fold instance), "
                    "16 blocks of 128, K=1",
              launches_from="phase 11b", full_sweep_ms=times["sweep_mc_f12_full"],
              ms_per_iter=flag11["11b"]["ms_per_iter"],
              chain_us_per_block=times["sweep_mc_f12_chain_us"],
              chain_cycles_per_draw=times["sweep_mc_f12_chain_cycles_per_draw"],
              folds_max_abs_err={"sweep_mc": errs["sweep_mc_folds"],
                                 "segment_guarded": errs["seg_folds"],
                                 "tiled_guarded": errs["tiled_folds"]}),
        entry("tiled_sweep_tile256", ssrc, "hibayes_tpu/ops/blockgibbs.py:1635",
              tiled11["11c"]["launches"]["tiled_sweep"], errs["tiled256"], "tiled256",
              timed="phase 5's LD in tiles of 256, re-tiled to 128, first 16 rows of 256",
              launches_from="phase 11c", full_sweep_ms=times["tiled256_full"],
              full_sweep_bound_ms=bounds["tiled256_full"][0], retile_s=times["retile_s"],
              ms_per_iter=tiled11["11c"]["ms_per_iter"],
              retiled_max_abs_err=errs["tiled_retiled"]),
        entry("tiled_sweep_grouped", ssrc, "hibayes_tpu/ops/blockgibbs.py:1635",
              tiled11["11d"]["launches"]["tiled_sweep"], errs["tiled_grouped"],
              "tiled_grouped",
              timed=f"{GROUPED_CHAINS} chains in groups on 11c's LD, first 16 rows of 256",
              launches_from="phase 11d", groups=tiled11["11d"]["groups"],
              full_sweep_ms=times["tiled_grouped_full"],
              full_sweep_bound_ms=bounds["tiled_grouped_full"][0],
              ms_per_iter=tiled11["11d"]["ms_per_iter"]),
    ]
    kernels.append(entry(
        "tiled_sweep_row_base", ssrc, "hibayes_tpu/ops/blockgibbs.py:1641",
        mesh12["launches_all_ranks"]["iv"]["tiled_sweep"], errs["tiled_row_base"],
        "tiled_row_base",
        timed="16 tile rows of 128 at row_base 48 of a 64-row store (phase 5's recipe), "
              "BayesCpi, guard",
        launches_from=f"phase 12b(iv) (sbrm on (1, 2), {mesh12['backend']}, "
                      f"{MESH_RANKS} ranks)",
        shard_max_abs_err=errs["tiled_row_base"],
        shard_of_phase5_ms=times["tiled_row_base_shard"],
        shard_of_phase5_bound_ms=bounds["tiled_row_base_shard"][0],
        mesh_ms_per_iter=mesh12["iv"]["ms_per_iter"],
        mesh_collective_share=mesh12["iv"]["collective_share"],
        concurrent_launches=mesh12["launches_all_ranks"]["viii"]["tiled_sweep"],
        concurrent_max_abs_err=mesh12["viii"]["max_abs_err"],
        concurrent_ms_per_iter=mesh12["viii"]["ms_per_iter"],
        concurrent_collective_share=mesh12["viii"]["collective_share"]))
    log(f"[12] results: 12a {json.dumps(pipe)}; 12b {json.dumps({k: mesh12[k] for k in ('i', 'ii', 'iii', 'iv', 'v')})}")
    log(f"[13] results: 13a {json.dumps(conc)}; 13b "
        f"{json.dumps({k: mesh12[k] for k in ('vii', 'viii')})}")
    idle = [k["name"] for k in kernels if not k["launches"]]
    if idle:
        raise AssertionError(f"kernels not launched on their main path: {idle}")
    print(json.dumps({"kernels": kernels}))
    log(f"[10] seconds by phase: {json.dumps(phase_s)}; the whole run took "
        f"{time.perf_counter() - t_main:.1f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
