"""Port types from the JAX package's, given as numpy arrays.

``gibbs_data_from_numpy`` / ``chain_state_from_numpy`` (individual level)
and ``sgibbs_data_from_numpy`` / ``s_chain_state_from_numpy`` (summary
level) take a JAX ``GibbsData`` / ``ChainState`` / ``SGibbsData`` /
``SChainState`` (or any mapping or named tuple with the same field names)
whose leaves are numpy arrays, so that a test can start both packages from
the same state.  No JAX is imported here.
"""

from __future__ import annotations

import numpy as np
import torch

from .gibbs import ChainState, GibbsData
from .sgibbs import SChainState, SGibbsData


def _fields(obj) -> dict:
    return dict(obj._asdict()) if hasattr(obj, "_asdict") else dict(obj)


def _t(x, device, dtype=None):
    return torch.as_tensor(np.array(x), device=device, dtype=dtype)


def gibbs_data_from_numpy(data, device="cpu") -> GibbsData:
    f = _fields(data)
    for name in ("K", "Kval", "epsl_yJ", "epsl_LHS_A", "epsl_codes", "epsl_counts"):
        if name in f and np.asarray(f[name]).size:
            raise NotImplementedError(
                f"GibbsData.{name} is set: BSLMM and the single-step term are "
                "not ported yet (ROADMAP queue 1, items 9 and 12)")
    if f.get("epsl_sp") is not None:
        raise NotImplementedError("sparse single-step term not ported yet")
    return GibbsData(
        y=_t(f["y"], device),
        X_blocks=_t(f["X_blocks"], device),
        W_blocks=_t(f["W_blocks"], device),
        xpx=_t(f["xpx"], device),
        vx=_t(f["vx"], device),
        real=_t(f["real"], device, torch.bool),
        C=_t(f["C"], device),
        cpc=_t(f["cpc"], device),
        r_codes=tuple(_t(c, device, torch.int64) for c in f["r_codes"]),
        r_counts=tuple(_t(c, device) for c in f["r_counts"]),
        fold=_t(f["fold"], device),
        windindx0=_t(f["windindx0"], device, torch.int64),
    )


def chain_state_from_numpy(state, device="cpu") -> ChainState:
    f = _fields(state)
    kw = {name: _t(f[name], device) for name in ChainState._fields
          if name not in ("it", "estR", "track")}
    return ChainState(
        it=int(np.asarray(f["it"])),
        estR=tuple(_t(e, device) for e in f["estR"]),
        track=_t(f["track"], device, torch.int32),
        **kw,
    )


def sgibbs_data_from_numpy(data, device="cpu") -> SGibbsData:
    f = _fields(data)
    opt = {name: None if f.get(name) is None else _t(f[name], device, dt)
           for name, dt in (("ld_tiles", None), ("ld_cols", torch.int32),
                            ("ld_valid", torch.bool))}
    return SGibbsData(
        ld_segs=tuple(_t(s, device) for s in f["ld_segs"]),
        xy=_t(f["xy"], device),
        xpx=_t(f["xpx"], device),
        vx=_t(f["vx"], device),
        real=_t(f["real"], device, torch.bool),
        varediff=_t(f["varediff"], device),
        fold=_t(f["fold"], device),
        windindx0=_t(f["windindx0"], device, torch.int64),
        yy=_t(f["yy"], device),
        **opt,
    )


def s_chain_state_from_numpy(state, device="cpu") -> SChainState:
    f = _fields(state)
    kw = {name: _t(f[name], device) for name in SChainState._fields
          if name not in ("it", "track")}
    return SChainState(it=int(np.asarray(f["it"])),
                       track=_t(f["track"], device, torch.int32), **kw)
