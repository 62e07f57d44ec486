"""The summary-level fit (sbrm) of a cell on a tiled LD band: its set-up
through the model layer's own preparation, and its window, one call to the
chain runner that ``sbrm`` calls (engine.sgibbs.run_s_chain; model/sbrm.py)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hibayes_tpu_torch.data.sparse_ld import TiledSparseLD
from hibayes_tpu_torch.engine import gibbs as G
from hibayes_tpu_torch.engine import sgibbs as SG

from . import mixture
from ..reference.sbrm import SbrmReference

PRINTFREQ = 100   # sbrm's default: a record chunk every printfreq // thin records


class Fit:
    step_module, step_name, tally_shape = SG, "one_s_iteration", (2,)

    def __init__(self, cfg: dict, cell: dict, inputs: dict, seed: int, dev):
        self.cfg, self.cell, self.inputs, self.seed = cfg, cell, inputs, int(seed)
        self.K = int(cell["traffic"]["chains"])
        if self.K != 1:
            raise ValueError("the sbrm entry runs one chain (run_s_chain)")
        thin = int(cell["traffic"]["thin"])
        method = cfg["method"]
        self.Pi, fold = mixture(cfg, thin)   # the iteration counts are the window's
        ld = TiledSparseLD(tile=cfg["tile"], m=cfg["m"],
                           col_idx=inputs["cols"].to(torch.int32).cpu().numpy(),
                           valid=inputs["valid"].cpu().numpy(), tiles=inputs["tiles"],
                           nnz_col=inputs["nnz_col"])
        ss = inputs["ss"]
        data, n_eff, vary, nvar0, seg_sizes, seg_real = SG.prepare_sgibbs_data(
            ss, ld, fold=fold, block=ld.tile, dtype=getattr(torch, cfg["dtype"]), device=dev)
        self.data = data
        sumvx = float(np.sum(np.asarray(ld.diag)))
        self.priors = G.resolve_priors(None, sumvx, float(self.Pi[0]), nr=0, vary=vary)
        pr = self.priors
        self.spec0 = G.GibbsSpec(
            model=method, n=n_eff, m=ss.shape[0], m_pad=int(sum(seg_sizes)), block=ld.tile,
            nc=0, nlevels=(), n_fold=len(self.Pi), niter=50, nburn=30, thin=thin,
            nvar0=nvar0, fixpi=False, dfvara=pr.dfvara, s2vara=pr.s2vara,
            dfvare=pr.dfvare, s2vare=pr.s2vare, s2varg=pr.s2varg,
            lambda_rate0=pr.lambda_rate0, vargl_strict_pos=True, real_excl_nvar0=True,
            reject_guard=True, vary=vary, seg_sizes=seg_sizes, seg_real=seg_real)

    def spec(self, niter: int, nburn: int, **kw):
        return dataclasses.replace(self.spec0, niter=niter, nburn=nburn, **kw)

    def run(self, spec):
        return SG.run_s_chain(spec, self.data, self.priors, self.Pi, seed=self.seed,
                              chunk_records=max(PRINTFREQ // spec.thin, 1))

    def free(self):
        self.data = None

    @staticmethod
    def params(state, K: int) -> dict:
        return dict(g=state.g[None], varg=state.varg[None], pi=state.pi[None],
                    vara=state.vara[None], vare=state.vare[None])

    @staticmethod
    def draws(state, K: int):
        return state.g[None], state.track[None]

    def records(self, state, m: int) -> dict:
        return {"pi": state.pi, "Vg": state.vara, "Ve": state.vare,
                "h2": state.vara / (state.vara + state.vare), "alpha": state.g[..., :m]}

    def reference(self, dtype, operands=None):
        return SbrmReference(self.cfg, self.inputs, dtype, operands)
