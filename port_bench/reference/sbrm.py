"""Plain reference of the summary-level chain (sbrm, SBayes: BayesCpi with
the SBayesS guard) on an LD band stored in tiles, in plain PyTorch.

It takes the summary statistics [MAF, BETA, SE, N] and the LD tiles the
harness made and works out again what the program's set-up derives
(src/SBayesD.cpp:92-152, SBayesS.cpp:131-141): n = round(mean N), x_j =
n LD_jj, X'y = x_j BETA_j, y'y, vary = y'y / (n - 1), the per-SNP residual
inflation varediff_j = (m - nnz_j) / m, the priors and the start.

The chain's state is r_hat = X'y - n LD g.  The sweep draws SNP j from
rhs_j = r_hat_j + x_j g_j with r_hat after SNPs 0 .. j-1, in the order of
the tile rows, so rhs_j = X'y_j - n sum_{k != j} LD_jk g_k with the new
effects of the SNPs before j and the old ones after.  As in reference/ibrm.py
the reference follows the chain's own SNP draws and judges each; the rest
(Vg and Ve from r_hat, the marker variance and pi) it computes itself,
carrying r_hat exactly from the effects.
"""

from __future__ import annotations

import numpy as np
import torch

from . import noise as N
from .draws import components, guard_accept, guard_candidates

ROWS = 256   # tile rows converted to the reference's precision at once


class SbrmReference:
    guarded = True   # the SBayesS guard follows every slab draw

    def __init__(self, cfg: dict, inputs: dict, dtype=torch.float64, operands=None):
        """``operands`` rounds both operands of every product (the control's
        TF32); None computes them in ``dtype``."""
        self.model, self.dt = cfg["method"], dtype
        self.op = operands or (lambda t: t)
        self.tiles, self.cols, self.valid = inputs["tiles"], inputs["cols"], inputs["valid"]
        self.dev = self.tiles.device
        nbr, _, T, _ = self.tiles.shape
        self.nbr, self.T, self.m = nbr, T, cfg["m"]
        self.m_pad = nbr * T
        ss = np.asarray(inputs["ss"], np.float64)
        m = self.m
        n = int(np.round(np.nanmean(ss[:, 3])))
        est = np.isfinite(ss[:, 1]) & np.isfinite(ss[:, 2]) & np.isfinite(ss[:, 3])
        diag = torch.diagonal(self.tiles[:, 0].double(), dim1=1, dim2=2).reshape(-1)[:m]
        diag = diag.cpu().numpy()
        xpx = diag * n
        yyi = np.where(est, xpx * (ss[:, 1] ** 2 + (ss[:, 3] - 2.0) * ss[:, 2] ** 2), 0.0)
        yy = float(yyi.sum() / est.sum())
        pad = lambda a: torch.as_tensor(np.pad(a, (0, self.m_pad - m)), dtype=dtype,
                                        device=self.dev)
        self.n, self.yy, self.vary = n, yy, yy / (n - 1)
        self.xpx = pad(xpx)
        self.xy = pad(np.where(est, xpx * ss[:, 1], 0.0))
        self.vx = pad(np.where(est, diag, 0.0))
        self.act = self.vx > 0
        self.real = torch.as_tensor(np.pad(est, (0, self.m_pad - m)), device=self.dev)
        self.varediff = pad((m - np.asarray(inputs["nnz_col"], np.float64)) / m)
        self.nvar0 = int((~est).sum())
        self.Pi = np.asarray(cfg["Pi"], np.float64)
        h2, dfvara = 0.5, 4.0
        vara = (dfvara - 2.0) / dfvara * self.vary * h2
        s2vara = vara * (dfvara - 2.0) / dfvara
        denom = (1.0 - self.Pi[0]) * float(diag.sum())
        self.priors = dict(vara=vara, vare=self.vary * (1.0 - h2), dfvara=dfvara,
                           s2vara=s2vara, varg=vara / denom, s2varg=s2vara / denom,
                           dfvare=-2.0, s2vare=0.0)

    def _rows(self):
        for r0 in range(0, self.nbr, ROWS):
            r1 = min(self.nbr, r0 + ROWS)
            yield (r0, r1, self.op(self.tiles[r0:r1].to(self.dt)), self.cols[r0:r1].long(),
                   self.valid[r0:r1])

    def ld_times(self, g):
        """n LD g (K, m_pad) over the band."""
        K, T = g.shape[0], self.T
        gb = g.reshape(K, self.nbr, T)
        out = torch.empty_like(g).reshape(K, self.nbr, T)
        for r0, r1, tl, cl, vl in self._rows():
            acc = torch.zeros((K, r1 - r0, T), dtype=self.dt, device=self.dev)
            for k in range(tl.shape[1]):
                part = torch.einsum("rpq,krq->krp", tl[:, k], self.op(gb[:, cl[:, k]]))
                acc += torch.where(vl[None, :, k, None], part, 0.0)
            out[:, r0:r1] = acc
        return self.n * out.reshape(K, -1)

    def start(self, K: int) -> dict:
        p, dt, dev = self.priors, self.dt, self.dev
        full = lambda shape, v: torch.full(shape, float(v), dtype=dt, device=dev)
        return dict(g=full((K, self.m_pad), 0.0), varg=full((K,), p["varg"]),
                    pi=torch.as_tensor(self.Pi, dtype=dt, device=dev).expand(K, -1).clone(),
                    vara=full((K,), p["vara"]), vare=full((K,), p["vare"]),
                    r_hat=self.xy.expand(K, -1).clone())

    def from_chain(self, st: dict) -> dict:
        s = {k: v.to(self.dt) for k, v in st.items()}
        s["r_hat"] = self.xy - self.ld_times(s["g"])
        return s

    def rhs(self, g_old, g_new):
        """rhs (K, m_pad) of every SNP as the sequential sweep over the tile
        rows meets it, the effects before it new and after it old."""
        K, T = g_old.shape[0], self.T
        go = self.op(g_old).reshape(K, self.nbr, T)
        gn = self.op(g_new).reshape(K, self.nbr, T)
        low = torch.ones((T, T), dtype=torch.bool, device=self.dev).tril(-1)
        out = torch.empty((K, self.nbr, T), dtype=self.dt, device=self.dev)
        for r0, r1, tl, cl, vl in self._rows():
            rows = torch.arange(r0, r1, device=self.dev)
            acc = torch.zeros((K, r1 - r0, T), dtype=self.dt, device=self.dev)
            for k in range(tl.shape[1]):
                c = cl[:, k]
                diag = c == rows
                src = torch.where((c < rows)[None, :, None], gn[:, c], go[:, c])
                part = torch.einsum("rpq,krq->krp", tl[:, k], src)
                if bool(diag.any()):
                    t = tl[:, k]
                    own = (torch.einsum("rpq,krq->krp", torch.where(low, t, 0.0), gn[:, c])
                           + torch.einsum("rpq,krq->krp", torch.where(low.T, t, 0.0),
                                          go[:, c]))
                    part = torch.where(diag[None, :, None], own, part)
                acc += torch.where(vl[None, :, k, None], part, 0.0)
            out[:, r0:r1] = acc
        return self.xy - self.n * out.reshape(K, -1)

    def step(self, st: dict, noises: list, g_out, track_out):
        """One iteration from ``st`` following the chain's draws.  Returns
        (the next state, (scores, effects, sds), the guard's (candidates,
        index kept))."""
        p, dt = self.priors, self.dt
        d = lambda draws: torch.stack([x.to(dt) for x in draws])
        mp = self.m_pad
        zs = d([nz.normal(N.STREAM_SNP_Z, (mp,)) for nz in noises])
        us = d([nz.uniform(N.STREAM_SNP_U, (mp,)) for nz in noises])
        zr = d([nz.normal(N.STREAM_SNP_ZR, (N.N_RETRY, mp)) for nz in noises])
        vei = self.varediff * st["vara"][:, None] + st["vare"][:, None]
        g, g_new = st["g"], g_out.to(dt)
        rhs = self.rhs(g, g_new)
        comps = components(self.model, rhs, self.xpx, vei, self.act, torch.log(st["pi"]),
                           None, st["varg"], zs, us)
        cands = guard_candidates(comps[1][..., 1], rhs, self.xpx, vei, st["varg"], zr)
        kept = guard_accept(cands, self.vx, self.vary)
        track = track_out.to(torch.int64)
        nnz = ((track == 1) & self.real).sum(-1).to(dt)
        chi = d([nz.chisq(N.STREAM_VARG, p["dfvara"] + nnz[k]) for k, nz in enumerate(noises)])
        varg = (torch.where(track == 1, g_new * g_new, 0.0).sum(-1)
                + p["s2varg"] * p["dfvara"]) / chi
        pi = torch.stack([nz.dirichlet(N.STREAM_PI, torch.stack(
            [self.m - self.nvar0 - nnz[k], nnz[k]]) + 1.0)
            for k, nz in enumerate(noises)]).to(dt)
        r_hat = self.xy - self.ld_times(g_new)
        chi_a = d([nz.chisq(N.STREAM_S_VARA, self.n + p["dfvara"]) for nz in noises])
        vara = ((g_new * (self.xy - r_hat)).sum(-1) + p["s2vara"] * p["dfvara"]) / chi_a
        chi_e = d([nz.chisq(N.STREAM_VE, self.n + p["dfvare"]) for nz in noises])
        vare = (self.yy - (g_new * (self.xy + r_hat)).sum(-1)
                + p["s2vare"] * p["dfvare"]) / chi_e
        vare = torch.where(vare < 0, 0.5 * vara, vare)
        nxt = dict(g=g_new, varg=varg, pi=pi, vara=vara, vare=vare, r_hat=r_hat)
        return nxt, comps, (cands, kept)
