"""The individual-level fit (ibrm) of a cell: its set-up through the model
layer's own preparation, and its window, one call to the chain runner that
``ibrm`` calls (engine.gibbs.run_chain for one chain, run_chains for a
batch; model/ibrm.py)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hibayes_tpu_torch.engine import gibbs as G
from hibayes_tpu_torch.model.formula import build_model_frame
from hibayes_tpu_torch.model.ibrm import _align_data_to_ids

from . import mixture
from ..reference.ibrm import IbrmReference

PRINTFREQ = 100   # ibrm's default: a record chunk every printfreq // thin records


class Fit:
    """One cell's fit: ``inputs`` made by the harness, prepared as ibrm
    prepares them."""

    step_module, tally_shape = G, None

    def __init__(self, cfg: dict, cell: dict, inputs: dict, seed: int, dev):
        self.cfg, self.cell, self.inputs, self.seed = cfg, cell, inputs, int(seed)
        self.K = int(cell["traffic"]["chains"])
        self.step_name = "one_iteration" if self.K == 1 else "one_iteration_batch"
        thin = int(cell["traffic"]["thin"])
        method = cfg["method"]
        self.Pi, fold = mixture(cfg, thin)   # the iteration counts are the window's
        data = inputs["data"]
        aligned = _align_data_to_ids(data, np.asarray(data["id"]).astype(str))
        mf = build_model_frame(cfg["formula"], aligned)
        M = inputs["M"]
        nlevels = tuple(int(len(lv)) for lv in mf.R_levels)
        self.gdata = G.prepare_gibbs_data(
            mf.y, M, C=mf.X, r_codes=tuple(mf.R_codes), r_nlevels=nlevels, fold=fold,
            block=cfg["block"], dtype=getattr(torch, cfg["dtype"]),
            geno_dtype=cfg["geno_dtype"], device=dev)
        vx = self.gdata.vx.cpu().numpy()
        m = int(M.shape[1])
        self.priors = G.resolve_priors(mf.y, float(vx.sum()), float(self.Pi[0]),
                                       nr=len(nlevels))
        pr = self.priors
        self.spec0 = G.GibbsSpec(
            model=method, n=int(self.gdata.y.shape[0]), n_real=len(mf.y), m=m,
            m_pad=int(self.gdata.xpx.shape[0]), block=self.gdata.block,
            nc=mf.X.shape[1] if mf.X is not None else 0, nlevels=nlevels,
            n_fold=len(self.Pi), niter=50, nburn=30, thin=thin,
            nvar0=int((vx[:m] == 0).sum()), fixpi=False, dfvara=pr.dfvara,
            s2vara=pr.s2vara, dfvare=pr.dfvare, s2vare=pr.s2vare, dfr=pr.dfr, s2r=pr.s2r,
            s2varg=pr.s2varg, lambda_rate0=pr.lambda_rate0)

    def spec(self, niter: int, nburn: int, **kw):
        return dataclasses.replace(self.spec0, niter=niter, nburn=nburn, **kw)

    def run(self, spec):
        """One call to the chain runner, as ibrm makes it (quiet)."""
        thin = spec.thin
        if self.K == 1:
            return G.run_chain(spec, self.gdata, self.priors, self.Pi, seed=self.seed,
                               chunk_records=max(PRINTFREQ // thin, 1))
        return G.run_chains(spec, self.gdata, self.priors, self.Pi, seed=self.seed,
                            nchains=self.K)

    def free(self):
        self.gdata = None

    # --- what the check reads of the chain ---------------------------------

    @staticmethod
    def params(state, K: int) -> dict:
        """The chain's parameters (K, ...) from a captured state."""
        lead = (lambda t: t[None]) if K == 1 and state.mu.dim() == 0 else (lambda t: t)
        return dict(mu=lead(state.mu), beta=lead(state.beta),
                    estR=[lead(e) for e in state.estR], vrtmp=lead(state.vrtmp),
                    vr=lead(state.vr), g=lead(state.g), varg=lead(state.varg),
                    pi=lead(state.pi), vara_fold=lead(state.vara_fold), vara=lead(state.vara),
                    vare=lead(state.vare))

    @staticmethod
    def draws(state, K: int):
        """(g, track) (K, m_pad) of a captured state."""
        g, t = state.g, state.track
        return (g[None], t[None]) if g.dim() == 1 else (g, t)

    def records(self, state, m: int) -> dict:
        """What the chain's record of ``state`` must hold, field by field."""
        vt = state.vara + state.vare + state.vr.sum(-1)
        out = {"mu": state.mu, "pi": state.pi, "Vg": state.vara, "Ve": state.vare,
               "h2": state.vara / vt, "alpha": state.g[..., :m], "beta": state.beta,
               "Vr": state.vr,
               "r": (torch.cat(state.estR, dim=-1) if state.estR else None)}
        return {k: v for k, v in out.items() if v is not None}

    def reference(self, dtype, operands=None):
        return IbrmReference(self.cfg, self.inputs, dtype, operands)
