"""Plain reference of the individual-level chain on a SNP-sharded cohort,
following the ring pipeline (``shard_schedule`` "pipeline"), for K chains,
in plain PyTorch.

It is :class:`~.ibrm.IbrmReference` (the SNP statistics, Gram blocks,
priors, start and residual worked out again from the inputs; the same
intercept, covariate, factor, marker-variance, mixture and residual-variance
updates, each chain's SNP draws judged against the exact residual), with
two differences:

* the genotype is never held: each block of B columns is made again from
  the seed when it is needed (inputs/cohort_sharded.py: a block is one
  chunk, a pure function of the seed and its index), so no process and no
  card holds the whole (120 GB at the cell's size);
* the sweep follows the pipeline's order.  The blocks, padded to a
  multiple of the S shards, are split into S shards of nb / S; chain k
  (of group c = k // (K / S)) visits the shards c, c + 1, ... (mod S), each
  shard's blocks in their order.  So the residual from which chain k draws
  SNP j is the iteration's residual less the updates X_b dg_b of every
  block b the chain visited before j, in that order.

The sweep takes two passes over the genotype an iteration, all chains at
once: the first makes each chain's update of each shard, U[s, k] = X_s
dg_{k,s} (from the chain's own draws), the second sweeps each shard's
blocks from each chain's residual on entering it (the iteration's, less
the U of the shards the chain visited before) and judges them.  In exact
arithmetic this is the chain visiting the shards one after another.
"""

from __future__ import annotations

import torch

from . import noise as N
from .draws import components
from .ibrm import IbrmReference
from ..inputs import cohort_sharded


class _Unheld:
    """Stands for the (n, m) genotype that no process holds: its shape and
    the device on which its blocks are made."""

    def __init__(self, n: int, m: int, dev):
        self.shape, self.device = (n, m), torch.device(dev)


class IbrmMeshReference(IbrmReference):

    def __init__(self, cfg: dict, seed: int, data: dict, dev, dtype=torch.float64,
                 operands=None):
        self.seed, self.S = int(seed), int(cfg["mesh"][1])
        super().__init__(cfg, {"M": _Unheld(cfg["n"], cfg["m"], dev), "data": data},
                         dtype, operands)
        # the blocks padded to a multiple of the shards, as the program pads
        # them: all-zero blocks, never active
        nb = -(-self.nb // self.S) * self.S
        extra = nb - self.nb
        if extra:
            pad = lambda t, v: torch.cat([t, torch.full((extra * self.B,) + tuple(t.shape[1:]),
                                                        v, dtype=t.dtype, device=t.device)])
            self.W_lower = torch.cat([self.W_lower, torch.zeros(
                (extra, self.B, self.B), dtype=self.W_lower.dtype, device=self.dev)])
            self.xpx, self.vx = pad(self.xpx, 0.0), pad(self.vx, 0.0)
            self.act, self.real = pad(self.act, False), pad(self.real, False)
        self.nb, self.m_pad = nb, nb * self.B

    def block(self, b: int, dtype):
        """Genotype block b (n, B) in ``dtype``, made again from the seed;
        zero columns past m."""
        X = torch.zeros((self.n, self.B), dtype=dtype, device=self.dev)
        if b * self.B < self.m:
            c = cohort_sharded.chunk(self.seed, b, self.n, self.B, self.m, self.dev)
            X[:, :c.shape[1]] = c.to(dtype)
        return X

    def _visits(self, K: int) -> list:
        """visits[k]: the shards chain k sweeps, in its order."""
        Kg = K // self.S
        return [[(k // Kg + t) % self.S for t in range(self.S)] for k in range(K)]

    def step(self, st: dict, noises: list, g_out, track_out):
        """One iteration from ``st``, the SNP sweep in the pipeline's order
        following the chain's own draws ``g_out``, ``track_out`` (K,
        m_pad).  Returns (the next state, the sweep's (scores, effects,
        sds) of every component)."""
        p, dt = self.priors, self.dt
        d = lambda draws: torch.stack([x.to(dt) for x in draws])
        K = len(noises)
        ve = st["vare"]
        yadj = st["yadj"].clone()
        # intercept, covariates, factors (src/Bayes.cpp:480-516)
        z = d([nz.normal(N.STREAM_MU) for nz in noises])
        delta = yadj.sum(-1) / self.n + torch.sqrt(ve / self.n) * z
        mu = st["mu"] + delta
        yadj -= delta[:, None]
        beta = st["beta"].clone()
        if self.C.shape[1]:
            zc = d([nz.normal(N.STREAM_COV, (self.C.shape[1],)) for nz in noises])
            for i in range(self.C.shape[1]):
                ci = self.C[:, i]
                cpc = ci @ ci
                rhs = (yadj * ci).sum(-1) + cpc * beta[:, i]
                b = rhs / cpc + torch.sqrt(ve / cpc) * zc[:, i]
                yadj += (beta[:, i] - b)[:, None] * ci
                beta[:, i] = b
        estR, vrtmp, vr = [], st["vrtmp"].clone(), st["vr"].clone()
        for i, (codes, counts) in enumerate(zip(self.codes, self.counts)):
            old = st["estR"][i]
            nl = counts.shape[0]
            sums = torch.zeros((K, nl), dtype=dt, device=self.dev).index_add_(1, codes, yadj)
            lhs = counts + ve[:, None] / vrtmp[:, i, None]
            zr = d([nz.normal(N.STREAM_FACTOR + 2 * i, (nl,)) for nz in noises])
            new = (sums + counts * old) / lhs + torch.sqrt(ve[:, None] / lhs) * zr
            yadj += (old - new)[:, codes]
            chi = d([nz.chisq(N.STREAM_FACTOR + 2 * i + 1, nl + p["dfr"]) for nz in noises])
            vrtmp[:, i] = ((new * new).sum(-1) + p["s2r"] * p["dfr"]) / chi
            vr[:, i] = new.var(-1, unbiased=True)
            estR.append(new)
        # the sweep, in the pipeline's order, following the chain's draws
        nf = len(self.Pi)
        zs = d([nz.normal(N.STREAM_SNP_Z, (self.m_pad,)) for nz in noises])
        us = d([nz.uniform(N.STREAM_SNP_U, (self.m_pad, nf) if self.model == "BayesR"
                           else (self.m_pad,)) for nz in noises])
        g = st["g"]
        g_new = g_out.to(dt)
        dg = g_new - g
        B, S = self.B, self.S
        nbl = self.nb // S
        moved = (dg.reshape(K, self.nb, B) != 0).any(-1).cpu()   # (K, nb)
        # pass 1: every chain's update of every shard
        U = torch.zeros((S, K, self.n), dtype=dt, device=self.dev)
        for b in torch.nonzero(moved.any(0))[:, 0].tolist():
            U[b // nbl] += self.op(dg[:, b * B:(b + 1) * B]) @ self.block(b, dt).T
        # pass 2: each shard from each chain's residual on entering it
        visits = self._visits(K)
        rhs = torch.empty((K, self.m_pad), dtype=dt, device=self.dev)
        for s in range(S):
            r = yadj.clone()
            for k in range(K):
                for s2 in visits[k][:visits[k].index(s)]:
                    r[k] -= U[s2, k]
            for b in range(s * nbl, (s + 1) * nbl):
                sl = slice(b * B, (b + 1) * B)
                X = self.block(b, dt)
                db = dg[:, sl]
                rhs[:, sl] = (self.op(r) @ X - self.op(db) @ self.W_lower[b].T
                              + self.xpx[sl] * g[:, sl])
                if bool(moved[:, b].any()):
                    r -= self.op(db) @ X.T
        upd = U.sum(0)
        yadj -= upd
        u = st["u"] + upd
        comps = components(self.model, rhs, self.xpx, ve[:, None].expand(-1, self.m_pad),
                           self.act, torch.log(st["pi"]), st["vara_fold"], st["varg"], zs, us)
        # marker variance and mixture proportions from the chain's draws
        track = track_out.to(torch.int64)
        if self.model == "BayesR":
            fold_num = torch.stack([((track == f) & self.real).sum(-1) for f in range(nf)],
                                   -1).to(dt)
            chi = d([nz.chisq(N.STREAM_VARG, p["dfvara"] + (self.m - fold_num[k, 0]))
                     for k, nz in enumerate(noises)])
            ffold = self.fold[track]
            acc = torch.where(track > 0, g_new * g_new / torch.clamp_min(ffold, 1e-30),
                              0.0).sum(-1)
            varg = (acc + p["s2varg"] * p["dfvara"]) / chi
            vara_fold = varg[:, None] * self.fold
            fold_num[:, 0] -= self.nvar0
            pi = torch.stack([nz.dirichlet(N.STREAM_PI, torch.clamp_min(fold_num[k], 0.0) + 1.0)
                              for k, nz in enumerate(noises)]).to(dt)
        else:
            nnz = ((track == 1) & self.real).sum(-1).to(dt)
            chi = d([nz.chisq(N.STREAM_VARG, p["dfvara"] + nnz[k])
                     for k, nz in enumerate(noises)])
            acc = torch.where(track == 1, g_new * g_new, 0.0).sum(-1)
            varg = (acc + p["s2varg"] * p["dfvara"]) / chi
            vara_fold = st["vara_fold"]
            pi = torch.stack([nz.dirichlet(N.STREAM_PI, torch.stack(
                [self.m - self.nvar0 - nnz[k], nnz[k]]) + 1.0)
                for k, nz in enumerate(noises)]).to(dt)
        vara = u.var(-1, unbiased=True)
        chi_e = d([nz.chisq(N.STREAM_VE, self.n + p["dfvare"]) for nz in noises])
        vare = ((yadj * yadj).sum(-1) + p["s2vare"] * p["dfvare"]) / chi_e
        nxt = dict(mu=mu, beta=beta, estR=estR, vrtmp=vrtmp, vr=vr, g=g_new, varg=varg, pi=pi,
                   vara_fold=vara_fold, vara=vara, vare=vare, yadj=yadj, u=u)
        return nxt, comps
