"""Port types from the JAX package's, given as numpy arrays.

``gibbs_data_from_numpy`` and ``chain_state_from_numpy`` take a JAX
``GibbsData`` / ``ChainState`` (or any mapping or named tuple with the same
field names) whose leaves are numpy arrays, so that a test can start both
packages from the same state.  No JAX is imported here.
"""

from __future__ import annotations

import numpy as np
import torch

from .gibbs import ChainState, GibbsData


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
