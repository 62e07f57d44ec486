"""Plain reference of the individual-level chain (ibrm: BayesR or BayesCpi,
covariates and random factors), for K chains, in plain PyTorch.

It takes the cohort the harness made (the int8 genotype, y, the covariate
and the factor's labels) and works out again everything the program's
set-up derives: the SNP statistics x_j = X_j' X_j and vx, the Gram blocks,
the priors (R/bayes.r and src/Bayes.cpp:319-363 defaults), the start of the
chain and its residual y - mu - C beta - Z r - X g.

One iteration (src/Bayes.cpp:477-917) is: the intercept, the covariates and
the factors' effects and variances, the sweep over the SNPs in blocks of B
(rhs_j = X_j' r + x_j g_j with r the residual after SNPs 0 .. j-1), then the
marker variance, the mixture proportions, Vg = var(X g) and Ve.  A chain
cannot be replayed draw for draw in another precision: a draw that rounding
moves across a component's boundary sends the two chains apart.  So the
reference follows the chain's own SNP draws (the effects and components it
returns), and at each SNP computes the draw it should have made from the
exact residual: :func:`~.draws.judge` then reads how far each choice and each
effect lies from the reference's.  Everything else it computes itself,
carried from step to step, so that a wrong intercept, covariate, factor,
variance or mixture update shows in the next sweep's rhs.
"""

from __future__ import annotations

import numpy as np
import torch

from . import noise as N
from .draws import components

class IbrmReference:
    guarded = False   # no SBayesS guard in the individual-level sweep

    def __init__(self, cfg: dict, inputs: dict, dtype=torch.float64, operands=None):
        """``operands`` rounds both operands of every product (the control's
        TF32); None computes them in ``dtype``."""
        self.model, self.dt = cfg["method"], dtype
        self.op = operands or (lambda t: t)
        M, data = inputs["M"], inputs["data"]
        self.M, self.dev = M, M.device
        n, m = M.shape
        self.n, self.m, self.B = n, m, cfg["block"]
        self.m_pad = -(-m // self.B) * self.B
        self.nb = self.m_pad // self.B
        f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=self.dev)
        self.y = f64(data["y"]).to(dtype)
        self.C = torch.stack([f64(data[c]) for c in cfg["covariates"]], 1).to(dtype) \
            if cfg["covariates"] else torch.zeros((n, 0), dtype=dtype, device=self.dev)
        self.codes, self.counts = [], []
        for f in cfg["factors"]:
            _, codes = np.unique(np.asarray(data[f]).astype(str), return_inverse=True)
            c = torch.as_tensor(codes, dtype=torch.int64, device=self.dev)
            self.codes.append(c)
            self.counts.append(torch.bincount(c).to(dtype))
        self.fold = f64(cfg.get("fold", [0.0] * len(cfg["Pi"]))).to(dtype)
        self.Pi = np.asarray(cfg["Pi"], np.float64)
        # SNP statistics and Gram blocks, exact in float64 for integer codes
        W = torch.zeros((self.nb, self.B, self.B), dtype=torch.float64, device=self.dev)
        s1 = torch.zeros((self.m_pad,), dtype=torch.float64, device=self.dev)
        for b in range(self.nb):
            X = self.block(b, torch.float64)
            W[b] = X.T @ X   # exact: integer codes
            s1[b * self.B:(b + 1) * self.B] = X.sum(0)
        xpx = torch.diagonal(W, dim1=1, dim2=2).reshape(-1)
        vx = (xpx - s1 * s1 / n) / (n - 1)
        self.W_lower = self.op(torch.tril(W, -1).to(dtype))
        self.xpx, self.vx = xpx.to(dtype), vx.to(dtype)
        self.act = vx > 0
        self.real = torch.arange(self.m_pad, device=self.dev) < m
        self.nvar0 = int((~self.act[:m]).sum())
        self.priors = self._priors(float(vx.sum()))

    def block(self, b: int, dtype):
        """Genotype block b (n, B) in ``dtype``, zero columns past m."""
        c0, c1 = b * self.B, min(self.m, (b + 1) * self.B)
        X = torch.zeros((self.n, self.B), dtype=dtype, device=self.dev)
        X[:, : c1 - c0] = self.M[:, c0:c1].to(dtype)
        return X

    def _priors(self, sumvx: float) -> dict:
        """Default hyperparameters (h2 = 0.5, dfvg = 4, dfve = -2, dfvr = -1)."""
        y = self.y.double().cpu().numpy()
        vary = float(np.var(y, ddof=1))
        nr, h2, dfvara = len(self.codes), 0.5, 4.0
        vara = (dfvara - 2.0) / dfvara * vary * h2
        s2vara = vara * (dfvara - 2.0) / dfvara
        denom = (1.0 - self.Pi[0]) * sumvx
        return dict(vara=vara, vare=vary * (1.0 - h2) / (nr + 1.0), dfvara=dfvara,
                    s2vara=s2vara, varg=vara / denom, s2varg=s2vara / denom,
                    dfvare=-2.0, s2vare=0.0, dfr=-1.0, s2r=0.0,
                    vr_init=vary * (1.0 - h2) / (nr + 1.0))

    def genetic(self, g):
        """X g (K, n) for effects g (K, m_pad)."""
        u = torch.zeros((g.shape[0], self.n), dtype=self.dt, device=self.dev)
        for b in range(self.nb):
            gb = g[:, b * self.B:(b + 1) * self.B]
            if bool((gb != 0).any()):
                u += self.op(gb) @ self.block(b, self.dt).T
        return u

    def start(self, K: int) -> dict:
        """The chain's first state, K chains alike."""
        p, dt, dev = self.priors, self.dt, self.dev
        full = lambda shape, v: torch.full(shape, float(v), dtype=dt, device=dev)
        mu = self.y.mean()
        varg = full((K,), p["varg"])
        fold_var = varg[:, None] * self.fold if self.model == "BayesR" else full(
            (K, len(self.Pi)), 1.0)
        nr = len(self.codes)
        return dict(mu=mu.expand(K).clone(), beta=full((K, self.C.shape[1]), 0.0),
                    estR=[full((K, len(c)), 0.0) for c in self.counts],
                    vrtmp=full((K, nr), p["vr_init"]), vr=full((K, nr), 0.0),
                    g=full((K, self.m_pad), 0.0), varg=varg,
                    pi=torch.as_tensor(self.Pi, dtype=dt, device=dev).expand(K, -1).clone(),
                    vara_fold=fold_var, vara=full((K,), p["vara"]), vare=full((K,), p["vare"]),
                    yadj=(self.y - mu).expand(K, -1).clone(), u=full((K, self.n), 0.0))

    def from_chain(self, st: dict) -> dict:
        """A state from a chain's parameters (each (K, ...)), its residual
        worked out again from them."""
        s = {k: (v.to(self.dt) if not isinstance(v, list) else [e.to(self.dt) for e in v])
             for k, v in st.items()}
        u = self.genetic(s["g"])
        pred = s["mu"][:, None] + s["beta"] @ self.C.T + u
        for e, c in zip(s["estR"], self.codes):
            pred = pred + e[:, c]
        s["yadj"], s["u"] = self.y - pred, u
        return s

    def step(self, st: dict, noises: list, g_out, track_out):
        """One iteration from ``st``, the SNP sweep following the chain's own
        draws ``g_out``, ``track_out`` (K, m_pad).  Returns (the next
        state, the sweep's (scores, effects, sds) of every component)."""
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
        # the sweep, following the chain's draws
        nf = len(self.Pi)
        zs = d([nz.normal(N.STREAM_SNP_Z, (self.m_pad,)) for nz in noises])
        us = d([nz.uniform(N.STREAM_SNP_U, (self.m_pad, nf) if self.model == "BayesR"
                           else (self.m_pad,)) for nz in noises])
        g = st["g"]
        g_new = g_out.to(dt)
        dg = g_new - g
        u = st["u"].clone()
        rhs = torch.empty((K, self.m_pad), dtype=dt, device=self.dev)
        B = self.B
        for b in range(self.nb):
            sl = slice(b * B, (b + 1) * B)
            X = self.block(b, dt)
            db = dg[:, sl]
            rhs[:, sl] = (self.op(yadj) @ X - self.op(db) @ self.W_lower[b].T
                          + self.xpx[sl] * g[:, sl])
            if bool((db != 0).any()):
                upd = self.op(db) @ X.T
                yadj -= upd
                u += upd
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
