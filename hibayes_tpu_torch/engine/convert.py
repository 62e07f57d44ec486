"""Port types from the JAX package's, given as numpy arrays.

``gibbs_data_from_numpy`` / ``chain_state_from_numpy`` (individual level)
and ``sgibbs_data_from_numpy`` / ``s_chain_state_from_numpy`` (summary
level) take a JAX ``GibbsData`` / ``ChainState`` / ``SGibbsData`` /
``SChainState`` (or any mapping or named tuple with the same field names)
whose leaves are numpy arrays, so that a test can start both packages from
the same state.  A state with a leading chain axis (a batch of the JAX
``run_chains``) converts to the port's batch: ``it`` is then one int, which
every chain must share.  ``epsl_sparse_from_numpy`` regroups a JAX ``EpslSparse``
into the port's layout; a JAX dense ``epsl_LHS_A`` (the direct path) is
packed into it as ``prepare_gibbs_data`` packs one, and the genotype is laid
out in the sub-blocks that ``prepare_gibbs_data`` lays it out in.  BSLMM's GRM
eigenbasis ``K``/``Kval`` is carried across as it is: eigenvectors are
unique only up to sign (and within a repeated eigenvalue up to a basis),
and the polygenic draw's noise term K (sqrt(lambda) z) depends on that
choice, so a parity test must share JAX's rather than recompute it.  No
JAX is imported here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.blockgibbs import cross_grams, sub_block_genotype
from .gibbs import (MAX_EPSL_TILE, ChainState, EpslSparse, GibbsData, _build_epsl_sparse,
                    _epsl_layout, genotype_layout, segments)
from .sgibbs import SChainState, SGibbsData


def _fields(obj) -> dict:
    return dict(obj._asdict()) if hasattr(obj, "_asdict") else dict(obj)


def _t(x, device, dtype=None):
    return torch.as_tensor(np.array(x), device=device, dtype=dtype)


def _iteration(it) -> int:
    """The one iteration count of a chain or a batch of chains."""
    its = np.asarray(it).reshape(-1)
    if its.size == 0 or (its != its[0]).any():
        raise ValueError(f"the chains of a batch must share the iteration, got {its}")
    return int(its[0])


def epsl_sparse_from_numpy(sp, device="cpu") -> EpslSparse:
    """The port's EpslSparse from a JAX one (numpy leaves): the same
    diagonal blocks, the padded per-block triplets without their padding
    (which has row 0, never a forward row), grouped by row."""
    f = _fields(sp)
    blocks = np.array(f["diag_blocks"])
    nbr, T, _ = blocks.shape
    rows, cols, vals = (np.array(f[k]) for k in ("blk_rows", "blk_cols", "blk_vals"))
    fwd = []
    for i in range(nbr):
        keep = rows[i] >= (i + 1) * T
        fwd.append((rows[i][keep], cols[i][keep], vals[i][keep]))
    coo = tuple(np.array(f[k]) for k in ("coo_rows", "coo_cols", "coo_vals"))
    return _epsl_layout(blocks, fwd, coo, nbr * T, torch.as_tensor(blocks).dtype, device)


def gibbs_data_from_numpy(data, device="cpu") -> GibbsData:
    f = _fields(data)
    dt = _t(f["y"], "cpu").dtype
    sp = f.get("epsl_sp")
    if sp is not None:
        sp = epsl_sparse_from_numpy(sp, device)
    elif np.asarray(f.get("epsl_LHS_A", ())).size:
        import scipy.sparse as sps

        tile = min(np.asarray(f["X_blocks"]).shape[2], MAX_EPSL_TILE)
        sp, _ = _build_epsl_sparse(sps.csr_matrix(np.array(f["epsl_LHS_A"])), tile, dt,
                                   device)
    empty = lambda shape, t=dt: torch.zeros(shape, dtype=t, device=device)
    opt = lambda name, shape, t=None: (_t(f[name], device, t) if name in f
                                       else empty(shape, t or dt))
    X, W = _t(f["X_blocks"], device), _t(f["W_blocks"], device)
    B = int(X.shape[2])
    X, W = sub_block_genotype(X, W, genotype_layout(B, int(X.shape[1]), X.element_size(),
                                                    int(np.asarray(f["fold"]).shape[0])))
    C = cross_grams(X, W.dtype)
    return GibbsData(
        y=_t(f["y"], device),
        X_blocks=X,
        W_blocks=W,
        C_blocks=C,
        xpx=_t(f["xpx"], device),
        vx=_t(f["vx"], device),
        real=_t(f["real"], device, torch.bool),
        C=_t(f["C"], device),
        cpc=_t(f["cpc"], device),
        r_codes=tuple(_t(c, device, torch.int64) for c in f["r_codes"]),
        r_counts=tuple(_t(c, device) for c in f["r_counts"]),
        r_segs=tuple(segments(c, np.asarray(k).shape[0], device)
                     for c, k in zip(f["r_codes"], f["r_counts"])),
        fold=_t(f["fold"], device),
        windindx0=_t(f["windindx0"], device, torch.int64),
        K=opt("K", (0, 0)),
        Kval=opt("Kval", (0,)),
        epsl_yJ=opt("epsl_yJ", (0,)),
        epsl_codes=opt("epsl_codes", (0,), torch.int64),
        epsl_counts=opt("epsl_counts", (0,)),
        epsl_segs=segments(f.get("epsl_codes", ()), np.asarray(f.get("epsl_counts", ())).shape[0],
                           device),
        block=B,
        epsl_sp=sp,
    )


def chain_state_from_numpy(state, device="cpu") -> ChainState:
    f = _fields(state)
    kw = {name: _t(f[name], device) for name in ChainState._fields
          if name not in ("it", "estR", "track")}
    return ChainState(
        it=_iteration(f["it"]),
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
    return SChainState(it=_iteration(f["it"]),
                       track=_t(f["track"], device, torch.int32), **kw)
