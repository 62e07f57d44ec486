"""Individual-level MCMC engine: exact blocked Gibbs for the Bayesian alphabet.

PyTorch port of hibayes_tpu/engine/gibbs.py for one device: one chain
(``run_chain``) or a batch of K chains (``run_chains``) with split R-hat.
The maths is the JAX engine's (reference: src/Bayes.cpp:477-917):

    for each block b of B SNPs:
        r0   = X_b' yadj
        for j in 0..B-1:  rhs_j = r_local[j] + xpx_j g_j; draw g_j';
                          r_local += (g_j - g_j') W_b[:, j]
        yadj += X_b (g_b - g_b')

with W_b = X_b' X_b precomputed.  The sweep runs in ops/blockgibbs.py:
the CUDA kernels for tensors on a GPU, their plain versions on the CPU.
The single-step model adds a J covariate and an imputation-error term
epsilon over the non-genotyped individuals, drawn site by site against
scale A-inverse(nn) + diag(counts) (``blocked_mme_gibbs_sparse``, the
CUDA epsilon sweep on a GPU).

Every random number of iteration ``it`` comes from an
:class:`~hibayes_tpu_torch.engine.rng.IterNoise` keyed by (seed, it, stream
id), the counterpart of the JAX engine's ``fold_in`` streams; chain k of a
batch has its own, keyed by (seed, k, it, stream id).  The loop is eager:
state lives on the device, and the host reads it only for progress rows
and at the end of the chain.

One iteration's functions take one chain's state, or a batch's: the same
fields with a leading chain axis (``it`` stays one Python int, shared by
all chains) and ``noise`` a list of one IterNoise per chain.  A batch's
tensor ops run over all chains at once; the one loop over chains draws
each chain's numbers from its own streams (:func:`_draw`).  The K chains
share each genotype block in the sweep (``blockgibbs.sweep_mc``).
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..math.solvers import segment_matmul
from ..ops import blockgibbs
from .rng import (STREAM_COV, STREAM_EPSL_CHI, STREAM_EPSL_J, STREAM_EPSL_Z,
                  STREAM_FACTOR, STREAM_LAMBDA, STREAM_MU, STREAM_PI,
                  STREAM_SNP_CHI, STREAM_SNP_U, STREAM_SNP_Z, STREAM_SNP_Z2,
                  STREAM_VARG, STREAM_VE, IterNoise)

MODEL_INDEX = {
    "BayesRR": 1,
    "BayesA": 2,
    "BayesB": 3,
    "BayesBpi": 3,
    "BayesC": 4,
    "BayesCpi": 4,
    "BSLMM": 4,
    "BayesL": 5,
    "BayesR": 6,
}


@dataclass(frozen=True)
class GibbsSpec:
    """Static configuration of one chain; the fields of the JAX engine's
    ``GibbsSpec``.  The port chooses kernel or plain sweep by the device of
    the data, so ``use_pallas`` is kept only for parity and read nowhere."""

    model: str
    n: int                  # array row count (== n_real unless row-padded)
    m: int                  # number of real SNPs
    m_pad: int              # padded to a multiple of block
    block: int
    nc: int                 # fixed covariates
    nlevels: tuple          # env random factor level counts
    n_fold: int
    niter: int
    nburn: int
    thin: int
    nvar0: int              # monomorphic SNP count (vx == 0 among real SNPs)
    nw: int = 0             # GWAS windows (0 = off)
    n_real: int = 0         # real individuals when rows are padded; 0 = n
    fixpi: bool = False
    dfvara: float = 4.0
    s2vara: float = 0.0
    dfvare: float = -2.0
    s2vare: float = 0.0
    dfr: float = -1.0
    s2r: float = 0.0
    s2varg: float = 0.0
    lambda_shape0: float = 1.1
    lambda_rate0: float = 0.0
    ne: int = 0
    qe: int = 0
    qe_pad: int = 0
    use_bslmm: bool = False
    vargl_strict_pos: bool = False
    real_excl_nvar0: bool = False
    reject_guard: bool = False
    vary: float = 1.0
    use_pallas: bool = False
    seg_sizes: tuple = ()
    seg_real: tuple = ()
    resync_every: int = 256  # periodic f32 drift resync of yadj/u
    shard_schedule: str = "turn"
    merge_rounds: int = 1
    emulate_shards: int = 0

    def __post_init__(self):
        if self.shard_schedule not in ("turn", "concurrent", "pipeline"):
            raise ValueError(
                f"shard_schedule must be 'turn', 'concurrent' or 'pipeline', "
                f"got {self.shard_schedule!r}")
        if self.merge_rounds < 1:
            raise ValueError("merge_rounds must be >= 1")

    @property
    def model_index(self) -> int:
        return MODEL_INDEX[self.model]

    @property
    def n_obs(self) -> int:
        return self.n_real or self.n

    @property
    def row_padded(self) -> bool:
        return bool(self.n_real) and self.n_real != self.n

    @property
    def nblocks(self) -> int:
        return self.m_pad // self.block

    @property
    def n_records(self) -> int:
        return (self.niter - self.nburn) // self.thin

    @property
    def niter_eff(self) -> int:
        # the reference stops once n_records samples are kept (src/Bayes.cpp:916)
        return self.nburn + self.n_records * self.thin


class ChainState(NamedTuple):
    """State of one chain.  ``it`` is a Python int; the rest are tensors on
    the chain's device.  (The BSLMM fields of the JAX ``ChainState`` arrive
    with that model.)"""

    it: int
    mu: torch.Tensor
    beta: torch.Tensor       # (nc,)
    estR: tuple              # per factor (nlev_i,)
    vrtmp: torch.Tensor      # (nr,)
    vr: torch.Tensor         # (nr,)
    yadj: torch.Tensor       # (n,)
    u: torch.Tensor          # (n,)
    g: torch.Tensor          # (m_pad,)
    varg: torch.Tensor
    vargL: torch.Tensor      # (m_pad,) BayesL local variances (size 0 otherwise)
    lambda2: torch.Tensor
    pi: torch.Tensor         # (n_fold,)
    vara_fold: torch.Tensor  # (n_fold,)
    vara: torch.Tensor
    vare: torch.Tensor
    track: torch.Tensor      # (m_pad,) int32 mixture component of the last sweep
    nzrate: torch.Tensor     # (m_pad,) PIP counters
    wppa: torch.Tensor       # (nw,) window counters
    # single-step epsilon term
    J_beta: torch.Tensor
    epsl_estR: torch.Tensor  # (qe_pad,)
    vepstmp: torch.Tensor
    veps: torch.Tensor


class EpslSparse(NamedTuple):
    """Sparse A-inverse(nn) of the single-step epsilon Gibbs (the JAX
    ``EpslSparse``, hibayes_tpu/engine/gibbs.py:257-273): dense (T, T)
    diagonal blocks for the in-block site draws; per block the triplets of
    A[rows below the block, block] (forward rows only: the sweep rebuilds
    its residual each call, so rows of swept blocks are never read again),
    grouped by target row for the kernel; and A row by row for the matvec.
    All O(nnz)."""

    diag_blocks: torch.Tensor  # (nbr, T, T)
    blk_ptr: torch.Tensor      # (nbr + 1,) int32: block i's rows are urow[blk_ptr[i]:blk_ptr[i+1]]
    urow: torch.Tensor         # (nu,) int32 global target row, ascending within a block
    row_ptr: torch.Tensor      # (nu + 1,) int32: row u's entries are ent_*[row_ptr[u]:row_ptr[u+1]]
    ent_col: torch.Tensor      # (nent,) int32 in-block column (0..T-1), ascending within a row
    ent_val: torch.Tensor      # (nent,)
    coo_cols: torch.Tensor     # (nnz,) int64, row-major order
    coo_vals: torch.Tensor     # (nnz,)
    coo_len: torch.Tensor      # (nbr * T,) int64 entries per row (0 on padded rows)


class GibbsData(NamedTuple):
    """Device-resident inputs.  X_blocks is the genotype in block layout.
    The single-step fields have size 0 when the term is off."""

    y: torch.Tensor            # (n,)
    X_blocks: torch.Tensor     # (nblocks, n, B) int8 or float
    W_blocks: torch.Tensor     # (nblocks, B, B) block Gram matrices
    xpx: torch.Tensor          # (m_pad,)
    vx: torch.Tensor           # (m_pad,)
    real: torch.Tensor         # (m_pad,) bool: real (non-padding) SNPs
    C: torch.Tensor            # (n, nc)
    cpc: torch.Tensor          # (nc,)
    r_codes: tuple             # per factor (n,) int64
    r_counts: tuple            # per factor (nlev_i,)
    fold: torch.Tensor         # (n_fold,)
    windindx0: torch.Tensor    # (m_pad,) int64 0-based window ids (pad -> nw)
    epsl_yJ: torch.Tensor      # (n,) J covariate
    epsl_codes: torch.Tensor   # (ne,) int64 level of each imputed individual
    epsl_counts: torch.Tensor  # (qe_pad,)
    # A-inverse(nn), sparse (the scale path) or dense (the direct path),
    # packed in diagonal blocks: the epsilon sweep's input
    epsl_sp: EpslSparse | None = None


# ---------------------------------------------------------------------------
# priors, data preparation, state
# ---------------------------------------------------------------------------


@dataclass
class Priors:
    """Resolved hyperparameters (reference defaulting: src/Bayes.cpp:319-363)."""

    vary: float
    vara: float
    vare: float
    dfvara: float
    s2vara: float
    dfvare: float
    s2vare: float
    varg: float
    s2varg: float
    dfr: float
    s2r: float
    vr_init: float
    lambda2: float
    lambda_rate0: float


def resolve_priors(
    y, sumvx, pi0, nr,
    vg=None, dfvg=None, s2vg=None, ve=None, dfve=None, s2ve=None,
    dfvr=None, s2vr=None, h2=0.5, shape0=1.1, vary=None,
) -> Priors:
    if vary is None:
        vary = float(np.var(np.asarray(y, dtype=np.float64), ddof=1))
    dfvara = 4.0 if dfvg is None else float(dfvg)
    if dfvara <= 2:
        raise ValueError("dfvg should not be less than 2.")
    vara = ((dfvara - 2.0) / dfvara) * vary * h2 if vg is None else float(vg)
    vare = vary * (1.0 - h2) / (nr + 1.0) if ve is None else float(ve)
    dfvare = -2.0 if dfve is None else float(dfve)
    s2vara = vara * (dfvara - 2.0) / dfvara if s2vg is None else float(s2vg)
    denom = (1.0 - pi0) * float(sumvx)
    varg = vara / denom
    s2varg = s2vara / denom
    s2vare = 0.0 if s2ve is None else float(s2ve)
    dfr = -1.0 if dfvr is None else float(dfvr)
    s2r = 0.0 if s2vr is None else float(s2vr)
    vr_init = vary * (1.0 - h2) / (nr + 1.0)
    R2 = (dfvara - 2.0) / dfvara
    lambda2 = 2.0 * (1.0 - R2) / R2 * float(sumvx)
    lambda_rate0 = (shape0 - 1.0) / lambda2
    return Priors(
        vary=vary, vara=vara, vare=vare, dfvara=dfvara, s2vara=s2vara,
        dfvare=dfvare, s2vare=s2vare, varg=varg, s2varg=s2varg,
        dfr=dfr, s2r=s2r, vr_init=vr_init,
        lambda2=lambda2, lambda_rate0=lambda_rate0,
    )


GRAM_BATCH_BYTES = 1 << 30  # f32 genotype blocks cast at once for the Gram
MAX_EPSL_TILE = 128         # sites per diagonal block of the epsilon system


def pad_to_block(m: int, block: int) -> int:
    return ((m + block - 1) // block) * block


def _columns(M, c0: int, c1: int, dtype, device) -> torch.Tensor:
    """Columns [c0, c1) of a numpy or torch genotype as a tensor on device."""
    if isinstance(M, torch.Tensor):
        return M[:, c0:c1].to(device=device, dtype=dtype)
    return torch.from_numpy(np.ascontiguousarray(M[:, c0:c1])).to(
        device=device, dtype=dtype)


def prepare_gibbs_data(
    y, M, *, C=None, r_codes=(), r_nlevels=(), fold=None, windindx=None, nw=0,
    epsl_yJ=None, epsl_A=None, epsl_codes=None, qe=0,
    block=64, dtype=torch.float32, geno_dtype=None, pad_n="auto",
    device="cpu",
) -> GibbsData:
    """Build the device-resident GibbsData (block layout, Gram matrices, stats).

    Port of ``prepare_gibbs_data`` (hibayes_tpu/engine/gibbs.py:1871-2052)
    without the BSLMM inputs.  ``M`` is an (n, m) numpy array or torch
    tensor on any device; it is copied block by block into ``X_blocks``
    (nblocks, n, B) on ``device``.

    The single-step term takes the J covariate ``epsl_yJ`` (n,), the
    A-inverse(nn) ``epsl_A`` (qe, qe), dense or scipy sparse, and the level
    ``epsl_codes`` (ne,) of the last ne rows.  Either is packed into
    :class:`EpslSparse` with blocks of min(block, 128) sites.  A sparse A
    (the scale path) pads the chain's qe sites to qe_pad; a dense one (the
    direct path) keeps qe unpadded for the chain, as JAX's dense sweep does.

    geno_dtype="int8" stores the genotype as int8.  Its Gram matrices are
    f32 products of integer codes, exact because every partial sum is an
    integer below 4n < 2^24 (TF32 is off), taken over batches of blocks of
    at most GRAM_BATCH_BYTES so that no f32 copy of the whole genotype
    exists; xpx and vx come exactly from diag(W) and the column sums.

    pad_n="auto" zero-pads the individual axis to a multiple of 512 for
    n > 4096, as the JAX engine does, so arrays and statistics match it;
    ``GibbsSpec.n`` is then the padded count and ``n_real`` the real one.
    """
    device = torch.device(device)
    y_np = np.asarray(y)
    n = int(y_np.shape[0])
    n_real = n
    epsilon = epsl_yJ is not None or epsl_A is not None
    if pad_n == "auto":
        pad_n = not epsilon and n > 4096 and n % 512 != 0
    if pad_n:
        if epsilon:
            raise ValueError("pad_n is not supported with BSLMM/epsilon terms")
        n = pad_to_block(n, 512)
    y_t = torch.zeros((n,), dtype=dtype, device=device)
    y_t[:n_real] = torch.as_tensor(y_np, dtype=dtype, device=device)
    use_int8 = geno_dtype in ("int8", torch.int8, np.int8)
    m = int(M.shape[1])
    block = int(min(block, pad_to_block(m, 8)))
    m_pad = pad_to_block(m, block)
    nblocks = m_pad // block

    epsl_sp, qe_pad = None, qe
    if epsl_A is not None and qe:
        import scipy.sparse as sps

        etile = int(min(block, MAX_EPSL_TILE))
        if sps.issparse(epsl_A):
            epsl_sp, qe_pad = _build_epsl_sparse(epsl_A, etile, dtype, device)
        else:
            dense = np.asarray(epsl_A.cpu() if isinstance(epsl_A, torch.Tensor)
                               else epsl_A, dtype=np.float64)
            epsl_sp, _ = _build_epsl_sparse(sps.csr_matrix(dense), etile, dtype, device)

    if use_int8:
        integer = (not M.dtype.is_floating_point if isinstance(M, torch.Tensor)
                   else np.issubdtype(M.dtype, np.integer))
        if not integer and not bool((M == M.round()).all()):
            raise ValueError("geno_dtype='int8' requires integer genotype codes")
        x_dtype = torch.int8
    else:
        x_dtype = dtype
    X_blocks = torch.zeros((nblocks, n, block), dtype=x_dtype, device=device)
    for b in range(nblocks):
        c0, c1 = b * block, min(m, (b + 1) * block)
        if c0 >= m:
            break
        X_blocks[b, :n_real, : c1 - c0] = _columns(M, c0, c1, x_dtype, device)

    gram_dt = torch.float32 if use_int8 else dtype
    W_blocks = torch.empty((nblocks, block, block), dtype=dtype, device=device)
    s1 = torch.empty((nblocks, block), dtype=gram_dt, device=device)
    xpx = torch.empty((nblocks, block), dtype=dtype, device=device)
    vx = torch.empty((nblocks, block), dtype=dtype, device=device)
    row_real = (torch.arange(n, device=device) < n_real)[None, :, None]
    per = max(1, GRAM_BATCH_BYTES // (n * block * gram_dt.itemsize))
    for b0 in range(0, nblocks, per):
        b1 = min(nblocks, b0 + per)
        Xf = X_blocks[b0:b1].to(gram_dt)
        W_blocks[b0:b1] = torch.bmm(Xf.transpose(1, 2), Xf).to(dtype)
        s1[b0:b1] = Xf.sum(dim=1)
        if not use_int8:
            # centred two-pass variance: exact 0 for monomorphic columns;
            # padded rows are left out of the centring
            xpx[b0:b1] = (Xf * Xf).sum(dim=1)
            Mc = torch.where(row_real, Xf - s1[b0:b1, None, :] / n_real, 0.0)
            vx[b0:b1] = (Mc * Mc).sum(dim=1) / (n_real - 1)
    if use_int8:
        # exact in float64: all integers < 2^53
        s2 = torch.diagonal(W_blocks, dim1=1, dim2=2).to(torch.float64)
        s1d = s1.to(torch.float64)
        xpx = s2.to(dtype)
        vx = ((s2 - s1d * s1d / n_real) / (n_real - 1)).to(dtype)
    xpx = xpx.reshape(m_pad)
    real = torch.arange(m_pad, device=device) < m
    vx = torch.where(real, vx.reshape(m_pad), 0.0)

    if C is None:
        C_t = torch.zeros((n, 0), dtype=dtype, device=device)
    else:
        C_t = torch.zeros((n, np.asarray(C).shape[1]), dtype=dtype, device=device)
        C_t[:n_real] = torch.as_tensor(np.asarray(C), dtype=dtype, device=device)
    cpc = (C_t * C_t).sum(dim=0)

    row_w = (torch.arange(n, device=device) < n_real).to(dtype)
    codes_t, counts_t = [], []
    for c, nl in zip(r_codes, r_nlevels):
        ct = torch.zeros((n,), dtype=torch.int64, device=device)
        ct[:n_real] = torch.as_tensor(np.asarray(c), dtype=torch.int64, device=device)
        codes_t.append(ct)
        # padded rows carry code 0 but must not inflate the level counts
        counts_t.append(torch.zeros((int(nl),), dtype=dtype, device=device)
                        .index_add_(0, ct, row_w))

    fold_t = (torch.zeros((2,), dtype=dtype, device=device) if fold is None
              else torch.as_tensor(np.asarray(fold), dtype=dtype, device=device))
    wind0 = torch.full((m_pad,), nw if windindx is not None and nw else 0,
                       dtype=torch.int64, device=device)
    if windindx is not None and nw:
        wind0[:m] = torch.as_tensor(np.asarray(windindx), dtype=torch.int64,
                                    device=device) - 1

    def tensor(a, dt, shape):
        return (torch.zeros(shape, dtype=dt, device=device) if a is None
                else torch.as_tensor(np.asarray(a), dtype=dt, device=device))

    codes_np = None if epsl_codes is None else np.asarray(epsl_codes, dtype=np.int64)
    return GibbsData(
        y=y_t, X_blocks=X_blocks, W_blocks=W_blocks, xpx=xpx, vx=vx,
        real=real, C=C_t, cpc=cpc, r_codes=tuple(codes_t),
        r_counts=tuple(counts_t), fold=fold_t, windindx0=wind0,
        epsl_yJ=tensor(None if epsl_yJ is None else np.asarray(epsl_yJ, np.float64),
                       dtype, (0,)),
        epsl_codes=tensor(codes_np, torch.int64, (0,)),
        epsl_counts=tensor(np.bincount(codes_np, minlength=qe_pad) if qe else None,
                           dtype, (0,)),
        epsl_sp=epsl_sp,
    )


def _epsl_layout(diag_blocks, fwd, coo, qe_pad, dtype, device) -> EpslSparse:
    """EpslSparse from host parts: ``diag_blocks`` (nbr, T, T); ``fwd`` per
    block the forward triplets (global rows, in-block cols, vals); ``coo``
    (rows, cols, vals) of the whole A in any order."""
    urow, cnts, ecol, evals, blk_ptr = [], [], [], [], [0]
    for r, c, v in fwd:
        order = np.lexsort((c, r))
        r, c, v = r[order], c[order], v[order]
        u, cnt = np.unique(r, return_counts=True)
        urow.append(u)
        cnts.append(cnt)
        ecol.append(c)
        evals.append(v)
        blk_ptr.append(blk_ptr[-1] + len(u))
    cat = lambda parts, dt: (np.concatenate(parts).astype(dt) if parts
                             else np.zeros((0,), dt))
    row_ptr = np.concatenate([[0], np.cumsum(cat(cnts, np.int64))])
    rows, cols, vals = (np.asarray(a) for a in coo)
    order = np.lexsort((cols, rows))
    as_t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)
    i32 = torch.int32
    return EpslSparse(
        diag_blocks=as_t(diag_blocks, dtype),
        blk_ptr=as_t(blk_ptr, i32), urow=as_t(cat(urow, np.int64), i32),
        row_ptr=as_t(row_ptr, i32), ent_col=as_t(cat(ecol, np.int64), i32),
        ent_val=as_t(cat(evals, np.float64), dtype),
        coo_cols=as_t(cols[order], torch.int64), coo_vals=as_t(vals[order], dtype),
        coo_len=as_t(np.bincount(rows, minlength=qe_pad), torch.int64),
    )


def _build_epsl_sparse(A, tile: int, dtype, device="cpu") -> tuple:
    """Pack a scipy sparse symmetric A into :class:`EpslSparse`: zero-padded
    (qe_pad = nbr * tile) dense diagonal blocks, the forward triplets of
    A[:, block] per block, and A row by row.  Port of ``_build_epsl_sparse``
    (hibayes_tpu/engine/gibbs.py:2055-2100): the same blocks and triplets,
    with the triplets grouped by row instead of padded to the largest
    block's count.  Returns (EpslSparse, qe_pad)."""
    import scipy.sparse as sps

    A = sps.csc_matrix(A)
    q = A.shape[0]
    nbr = -(-q // tile)
    qe_pad = nbr * tile
    diag_blocks = np.zeros((nbr, tile, tile), dtype=np.float64)
    fwd = []
    for i in range(nbr):
        c0, c1 = i * tile, min(q, (i + 1) * tile)
        blk = A[:, c0:c1].tocoo()
        keep = blk.row >= c1
        fwd.append((blk.row[keep], blk.col[keep], blk.data[keep]))
        d = A[c0:c1, c0:c1].toarray()
        diag_blocks[i, : d.shape[0], : d.shape[1]] = d
    coo = A.tocoo()
    return _epsl_layout(diag_blocks, fwd, (coo.row, coo.col, coo.data), qe_pad,
                        dtype, device), qe_pad


def init_state(spec: GibbsSpec, data: GibbsData, priors: Priors, pi_init) -> ChainState:
    dt = data.y.dtype
    dev = data.y.device
    n, m_pad = spec.n, spec.m_pad
    nr = len(spec.nlevels)

    def full(shape, v):
        return torch.full(shape, float(v), dtype=dt, device=dev)

    if spec.row_padded:
        mu0 = data.y.sum() / spec.n_obs
        yadj0 = torch.where(torch.arange(n, device=dev) < spec.n_obs,
                            data.y - mu0, 0.0)
    else:
        mu0 = data.y.mean()
        yadj0 = data.y - mu0
    vara_fold = (priors.varg * data.fold
                 if spec.n_fold > 2 or spec.model == "BayesR"
                 else full((spec.n_fold,), 1.0))
    return ChainState(
        it=0,
        mu=mu0,
        beta=full((spec.nc,), 0.0),
        estR=tuple(full((nl,), 0.0) for nl in spec.nlevels),
        vrtmp=full((nr,), priors.vr_init),
        vr=full((nr,), 0.0),
        yadj=yadj0,
        u=full((n,), 0.0),
        g=full((m_pad,), 0.0),
        varg=full((), priors.varg),
        vargL=full((m_pad,) if spec.model_index == 5 else (0,), priors.varg),
        lambda2=full((), priors.lambda2),
        pi=torch.as_tensor(np.asarray(pi_init), dtype=dt, device=dev),
        vara_fold=vara_fold,
        vara=full((), priors.vara),
        vare=full((), priors.vare),
        track=torch.zeros((m_pad,), dtype=torch.int32, device=dev),
        nzrate=full((m_pad,), 0.0),
        wppa=full((spec.nw,), 0.0),
        J_beta=full((), 0.0),
        epsl_estR=full((spec.qe_pad or spec.qe,), 0.0),
        vepstmp=full((), priors.vara),
        veps=full((), priors.vara),
    )


def _snapshot(spec: GibbsSpec, state: ChainState) -> dict:
    vt = state.vara + state.vare + state.vr.sum(-1)
    snap = {
        "mu": state.mu,
        "pi": state.pi,
        "Vg": state.vara,
        "Ve": state.vare,
        "h2": state.vara / vt,
        "alpha": state.g,
        "beta": state.beta,
        "Vr": state.vr,
        "r": (torch.cat(state.estR, dim=-1) if state.estR
              else torch.zeros(tuple(state.mu.shape) + (0,), dtype=state.g.dtype,
                               device=state.g.device)),
        "lambda": torch.sqrt(state.lambda2),
    }
    if spec.qe:
        snap["Veps"] = state.veps
        snap["J"] = state.J_beta
        snap["epsilon"] = state.epsl_estR[: spec.qe]
    return snap


def genotype_matmul(X_blocks, G, dtype) -> torch.Tensor:
    """X @ G for X in block layout and G (nblocks * B, r), block by block, so
    that no copy of the whole genotype in ``dtype`` ever exists."""
    nblocks, n, B = X_blocks.shape
    out = torch.zeros((n, G.shape[1]), dtype=dtype, device=X_blocks.device)
    G = G.to(dtype)
    for b in range(nblocks):
        out.addmm_(X_blocks[b].to(dtype), G[b * B:(b + 1) * B])
    return out


# ---------------------------------------------------------------------------
# one MCMC iteration, of one chain or a batch (draws and reductions over the
# last axis)
# ---------------------------------------------------------------------------


def chain_noise(seed: int, it: int, nchains: int, device, dtype) -> list:
    """The IterNoise of iteration ``it`` of chains 0 .. nchains - 1."""
    return [IterNoise(seed, it, device, dtype, chain=k) for k in range(nchains)]


def _draw(noise, draw, *per_chain):
    """``draw(noise, *per_chain)`` for one chain.  For a batch (``noise`` a
    list of IterNoise), each chain's draw from its own streams with its own
    row of each ``per_chain`` tensor, stacked on a leading chain axis."""
    if isinstance(noise, (list, tuple)):
        return torch.stack([draw(nz, *(a[k] for a in per_chain))
                            for k, nz in enumerate(noise)])
    return draw(noise, *per_chain)


def _dot(a, b):
    """a . b over the last axis.  One chain: ``torch.dot``.  A batch: an
    elementwise product and a sum over the last axis, which torch may still
    order by K (in f32 on the CPU, K=5 against K=2, for short rows), so a batch's
    chain matches another batch size's to rounding, not always bit for bit."""
    if a.dim() == 1 and b.dim() == 1:
        return torch.dot(a, b)
    return (a * b).sum(-1)


def _var(x):
    """Sample variance over the last axis (correction 1), chain by chain."""
    if x.dim() == 1:
        return torch.var(x, correction=1)
    c = x - x.mean(-1, keepdim=True)
    return (c * c).sum(-1) / (x.shape[-1] - 1)


def alphabet_global_updates(spec: GibbsSpec, noise, g, track, real, fold,
                            vargi_acc, vargR_acc, vargL, varg, pi, vara_fold,
                            lambda2):
    """Post-sweep model-level updates: marker variance, mixture proportions,
    BayesL lambda (``alphabet_global_updates``, hibayes_tpu/engine/gibbs.py:455-516),
    for one chain or a batch."""
    mi = spec.model_index
    dt = g.dtype
    m_real, nvar0 = spec.m, spec.nvar0
    s2varg_df = spec.s2varg * spec.dfvara

    if mi == 1:
        chi = _draw(noise, lambda nz: nz.chisq(STREAM_VARG, spec.dfvara + m_real - nvar0))
        varg = (_dot(g, g) + s2varg_df) / chi
    elif mi in (3, 4):
        nnz = ((track == 1) & real).sum(-1).to(dt)
        if mi == 4:
            chi = _draw(noise, lambda nz, k: nz.chisq(STREAM_VARG, spec.dfvara + k), nnz)
            varg = (vargi_acc + s2varg_df) / chi
        if not spec.fixpi:
            pi = _draw(noise, lambda nz, k: nz.dirichlet(
                STREAM_PI, torch.stack([m_real - nvar0 - k, k]) + 1.0), nnz)
    elif mi == 5:
        rate = spec.lambda_rate0 + torch.where(real, vargL, 0.0).sum(-1) / 2.0
        lambda2 = _draw(noise, lambda nz: nz.gamma(
            STREAM_LAMBDA, spec.lambda_shape0 + m_real - nvar0)) / rate
    elif mi == 6:
        fold_num = torch.stack([((track == f) & real).sum(-1).to(dt)
                                for f in range(spec.n_fold)], dim=-1)
        # reference semantics (Bayes.cpp:443-455): NnzSnp = m - #(track == 0
        # over all m); pi counts subtract nvar0 from the zero fold
        zero_all = fold_num[..., 0] + (nvar0 if spec.real_excl_nvar0 else 0)
        chi = _draw(noise, lambda nz, z: nz.chisq(STREAM_VARG, spec.dfvara + (m_real - z)),
                    zero_all)
        varg = (vargR_acc + s2varg_df) / chi
        vara_fold = varg[..., None] * fold
        if not spec.real_excl_nvar0:
            fold_num = torch.cat([fold_num[..., :1] - nvar0, fold_num[..., 1:]], dim=-1)
        if not spec.fixpi:
            pi = _draw(noise, lambda nz, f: nz.dirichlet(
                STREAM_PI, torch.clamp_min(f, 0.0) + 1.0), fold_num)
    return varg, pi, vara_fold, lambda2


def pip_counters(spec: GibbsSpec, data, state, track):
    """PIP / WPPA counters after burn-in (src/Bayes.cpp:826-845); ``data``
    and ``state`` of either engine, one chain or a batch."""
    nzrate, wppa = state.nzrate, state.wppa
    if state.it >= spec.nburn:
        nz = (track > 0) & data.real
        nzrate = nzrate + nz.to(nzrate.dtype)
        if spec.nw:
            lead = tuple(track.shape[:-1])
            win_any = torch.zeros(lead + (spec.nw + 1,), dtype=torch.int32,
                                  device=track.device)
            win_any.scatter_reduce_(-1, data.windindx0.expand(lead + data.windindx0.shape),
                                    nz.to(torch.int32), reduce="amax")
            wppa = wppa + win_any[..., : spec.nw].to(wppa.dtype)
    return nzrate, wppa


def _segment_sum(values, codes, lengths):
    """Per-level sums of ``values`` over its last axis, added in a fixed
    order.  index_add_ adds with atomics on a GPU, in an order that changes
    from run to run; a chain must be reproducible for its seed.  ``lengths``
    (int64) counts every row of each level, padded rows included."""
    order = torch.argsort(codes, stable=True)
    if values.dim() == 1:
        return torch.segment_reduce(values[order], "sum", lengths=lengths)
    return torch.segment_reduce(values[:, order].T, "sum", lengths=lengths).T


# ---------------------------------------------------------------------------
# blocked single-site Gibbs for the single-step epsilon term
# ---------------------------------------------------------------------------


def _epsl_matvec(sp: EpslSparse, x):
    """A @ x for the sparse A-inverse(nn), row by row (no atomics)."""
    return segment_matmul(sp.coo_len, sp.coo_cols, sp.coo_vals, x)


def blocked_mme_gibbs_sparse(sp: EpslSparse, counts, scale, x, b, ve, z):
    """Single-site Gibbs sweep over LHS = scale A + diag(counts) for A in
    the packed layout (``blocked_mme_gibbs_sparse``,
    hibayes_tpu/engine/gibbs.py:576-654): per diagonal block, T in-block
    draws (TPU kernel 10), then the block's forward triplets into the
    residual.  The sweep is ``blockgibbs.mme_sweep``: one CUDA launch on a
    GPU, its plain version on the CPU.  Zero-padded sites stay frozen.
    Returns (x_new, A @ x_new); the matvec feeds the Veps quadratic form."""
    res = b - scale * _epsl_matvec(sp, x) - counts * x
    x_new, _ = blockgibbs.mme_sweep(sp, counts, scale, ve, z, x, res)
    return x_new, _epsl_matvec(sp, x_new)


def _epsilon_draw(spec: GibbsSpec, data: GibbsData, noise, J_beta, epsl_estR,
                  vepstmp, yadj, u, ve):
    """The single-step imputation-error term (hibayes_tpu/engine/gibbs.py:900-949,
    src/Bayes.cpp:554-584): the J covariate, then epsilon | rest by
    single-site Gibbs on (Z'Z + A-inverse(nn) ve / veps), then Veps.
    Returns (J_beta, epsl_estR, vepstmp, yadj, u)."""
    dev = yadj.device
    n, ne, qe = spec.n, spec.ne, spec.qe
    yJ = data.epsl_yJ
    JtJ = torch.dot(yJ, yJ)
    rhs = torch.dot(yJ, yadj) + JtJ * J_beta
    J_new = rhs / JtJ + torch.sqrt(ve / JtJ) * noise.normal(STREAM_EPSL_J, ())
    yadj = yadj + (J_beta - J_new) * yJ
    u = u - (J_beta - J_new) * yJ
    qe_p = spec.qe_pad or qe
    lengths = data.epsl_counts.to(torch.int64)
    rhs_e = (_segment_sum(yadj[n - ne:], data.epsl_codes, lengths)
             + data.epsl_counts * epsl_estR)
    scale = ve / vepstmp
    # qe normals on the direct path, qe_pad with the padding frozen on the
    # scale path (JAX's noise shapes); the layout pads a dense A's qe sites
    # to whole blocks, where they stay frozen too
    ze = noise.normal(STREAM_EPSL_Z, (qe_p,))
    ze = torch.where(torch.arange(qe_p, device=dev) < qe, ze, 0.0)
    sp = data.epsl_sp
    pad = lambda v: torch.nn.functional.pad(v, (0, sp.coo_len.shape[0] - qe_p))
    new_e, Ae = blocked_mme_gibbs_sparse(sp, pad(data.epsl_counts), scale, pad(epsl_estR),
                                         pad(rhs_e), ve, pad(ze))
    new_e = new_e[:qe_p]
    quad = torch.dot(new_e, Ae[:qe_p])
    diff_e = (epsl_estR - new_e)[data.epsl_codes]
    yadj = torch.cat([yadj[: n - ne], yadj[n - ne:] + diff_e])
    u = torch.cat([u[: n - ne], u[n - ne:] - diff_e])
    chi = noise.chisq(STREAM_EPSL_CHI, spec.dfvara + qe)
    vepstmp = (quad + spec.s2vara * spec.dfvara) / chi
    return J_new, new_e, vepstmp, yadj, u


def _sweep_noise(spec: GibbsSpec, noise, lead: tuple, dt, dev) -> tuple:
    """The sweep's random numbers (z, u, chi, z2), each ``lead + (m_pad,)``
    (BayesR's u ``lead + (m_pad, n_fold)``); an unused stream is never
    drawn."""
    m_pad = spec.m_pad
    mi = spec.model_index
    full = lambda v: torch.full(lead + (m_pad,), v, dtype=dt, device=dev)
    z_snp = _draw(noise, lambda nz: nz.normal(STREAM_SNP_Z, (m_pad,)))
    if mi == 6:  # BayesR Gumbel-max fold selection: n_fold uniforms per SNP
        u_snp = _draw(noise, lambda nz: nz.uniform(STREAM_SNP_U, (m_pad, spec.n_fold)))
    elif mi in (3, 4, 5):
        u_snp = _draw(noise, lambda nz: nz.uniform(STREAM_SNP_U, (m_pad,)))
    else:
        u_snp = full(0.5)
    if mi in (2, 3):
        chi_snp = _draw(noise, lambda nz: nz.chisq(STREAM_SNP_CHI, spec.dfvara + 1.0, (m_pad,)))
    else:
        chi_snp = full(1.0)
    if mi == 5:
        z2_snp = _draw(noise, lambda nz: nz.normal(STREAM_SNP_Z2, (m_pad,)))
    else:
        z2_snp = full(0.0)
    return z_snp, u_snp, chi_snp, z2_snp


def _pre_sweep(spec: GibbsSpec, data: GibbsData, noise, state: ChainState) -> dict:
    """Intercept, sequential covariates, environmental random effects, the
    single-step epsilon term, and the sweep's constants and random numbers
    (hibayes_tpu/engine/gibbs.py:817-875, 900-1004), for one chain or a
    batch.  Every draw comes from ``noise``."""
    dt = data.y.dtype
    dev = data.y.device
    n, n_obs = spec.n, spec.n_obs
    mu, beta, yadj, u = state.mu, state.beta, state.yadj, state.u
    ve = state.vare
    lead = tuple(mu.shape)   # () for one chain, (K,) for a batch
    row_real = torch.arange(n, device=dev) < n_obs if spec.row_padded else None

    # --- intercept (src/Bayes.cpp:480-482) ---
    z = _draw(noise, lambda nz: nz.normal(STREAM_MU, ()))
    delta = yadj.sum(-1) / n_obs + torch.sqrt(ve / n_obs) * z
    mu = mu + delta
    # padded rows stay exactly zero (they feed sum(yadj) and yadj.yadj)
    yadj = yadj - (torch.where(row_real, delta[..., None], 0.0) if spec.row_padded
                   else delta[..., None])

    # --- fixed covariates, sequential (src/Bayes.cpp:484-494) ---
    if spec.nc:
        z_cov = _draw(noise, lambda nz: nz.normal(STREAM_COV, (spec.nc,)))
        new_beta = []
        for i in range(spec.nc):
            ci, cpci, bi_old = data.C[:, i], data.cpc[i], beta[..., i]
            rhs = _dot(ci, yadj) + cpci * bi_old
            bi = rhs / cpci + torch.sqrt(ve / cpci) * z_cov[..., i]
            yadj = yadj + (bi_old - bi)[..., None] * ci
            new_beta.append(bi)
        beta = torch.stack(new_beta, dim=-1)

    # --- environmental random effects per factor (src/Bayes.cpp:496-516) ---
    estR = []
    vrtmp, vr = state.vrtmp.clone(), state.vr.clone()
    for i, nlev in enumerate(spec.nlevels):
        codes, counts, old = data.r_codes[i], data.r_counts[i], state.estR[i]
        # padded rows carry code 0 (and yadj 0) but are not in the counts
        lengths = counts.to(torch.int64)
        if spec.row_padded:
            lengths = torch.cat([lengths[:1] + (n - n_obs), lengths[1:]])
        rhs = _segment_sum(yadj, codes, lengths) + counts * old
        lhs = counts + ve[..., None] / vrtmp[..., i, None]
        zr = _draw(noise, lambda nz: nz.normal(STREAM_FACTOR + 2 * i, (nlev,)))
        new = rhs / lhs + torch.sqrt(ve[..., None] / lhs) * zr
        upd = (old - new)[..., codes]
        yadj = yadj + (torch.where(row_real, upd, 0.0) if spec.row_padded else upd)
        chi = _draw(noise, lambda nz: nz.chisq(STREAM_FACTOR + 2 * i + 1, nlev + spec.dfr))
        vrtmp[..., i] = (_dot(new, new) + spec.s2r * spec.dfr) / chi
        vr[..., i] = _var(new)
        estR.append(new)

    # --- single-step imputation-error term (src/Bayes.cpp:554-584) ---
    J_beta, epsl_estR, vepstmp, veps = (state.J_beta, state.epsl_estR,
                                        state.vepstmp, state.veps)
    if spec.qe:
        J_beta, epsl_estR, vepstmp, yadj, u = _epsilon_draw(
            spec, data, noise, J_beta, epsl_estR, vepstmp, yadj, u, ve)
        veps = vepstmp

    # --- the sweep's random numbers and constants ---
    m_pad = spec.m_pad
    consts = {
        "varg": state.varg,
        "s2varg_df": torch.full(lead, spec.s2varg * spec.dfvara, dtype=dt, device=dev),
        "logpi": torch.log(state.pi),
        "lambda2": state.lambda2,
        "vara_fold": state.vara_fold,
        "fold": data.fold.expand(lead + tuple(data.fold.shape)),
    }
    return {
        "mu": mu, "beta": beta, "estR": tuple(estR), "vrtmp": vrtmp, "vr": vr,
        "yadj": yadj, "u": u,
        "J_beta": J_beta, "epsl_estR": epsl_estR, "vepstmp": vepstmp, "veps": veps,
        "consts": consts,
        "vei": ve[..., None].expand(lead + (m_pad,)),
        "vargL_in": (state.vargL if state.vargL.numel()
                     else torch.zeros(lead + (m_pad,), dtype=dt, device=dev)),
        "rnd": _sweep_noise(spec, noise, lead, dt, dev),
    }


def _run_sweep_k1(spec: GibbsSpec, data: GibbsData, pre: dict, g):
    """Run the K-chain sweep as one chain (add and strip the K = 1 axis)."""
    consts_b = {k: v.reshape((1,) + tuple(v.shape)) for k, v in pre["consts"].items()}
    out = blockgibbs.sweep_mc(
        spec, consts_b, data.X_blocks, data.W_blocks, data.xpx, data.vx,
        pre["vei"][None], g[None], *(r[None] for r in pre["rnd"]),
        pre["vargL_in"][None], pre["yadj"][None], pre["u"][None],
    )
    return tuple(o[0] for o in out)


def _recompute_residuals(spec: GibbsSpec, data: GibbsData, mu, beta, estR, g,
                         J_beta=None, epsl_estR=None):
    """Exact recompute of (yadj, u) from the current effects: the periodic
    f32 drift correction (hibayes_tpu/engine/gibbs.py:1674-1704), for one
    chain or a batch.  ``u`` carries the J and epsilon terms too, as in the
    JAX engine."""
    dt = data.y.dtype
    n = spec.n
    pred = torch.zeros(tuple(mu.shape) + (n,), dtype=dt, device=data.y.device) + mu[..., None]
    if spec.nc:
        pred = pred + (data.C @ beta if beta.dim() == 1 else beta @ data.C.T)
    for i in range(len(spec.nlevels)):
        pred = pred + estR[i][..., data.r_codes[i]]
    if g.dim() == 1:
        u_new = genotype_matmul(data.X_blocks, g[:, None], dt)[:, 0]
    else:
        u_new = genotype_matmul(data.X_blocks, g.T, dt).T
    if spec.qe:
        u_new = u_new + J_beta * data.epsl_yJ
        u_new[n - spec.ne:] += epsl_estR[data.epsl_codes]
    yadj_new = data.y - (pred + u_new)
    if spec.row_padded:
        yadj_new = torch.where(torch.arange(n, device=data.y.device) < spec.n_obs,
                               yadj_new, 0.0)
    return yadj_new, u_new


def _post_sweep(spec: GibbsSpec, data: GibbsData, noise, state: ChainState,
                pre: dict, sweep_out) -> ChainState:
    """Model-level updates, Vg/Ve draws, PIP/WPPA counters, drift resync,
    state assembly (hibayes_tpu/engine/gibbs.py:1707-1806), for one chain or
    a batch (``_post_sweep_batch``, :2442-2469): every chain shares the
    iteration counter, so the resync is one predicate for all of them."""
    dt = data.y.dtype
    g, track, vargL_new, yadj, u, vargi_acc, vargR_acc = sweep_out
    vargL = vargL_new if state.vargL.numel() else state.vargL
    varg, pi, vara_fold, lambda2 = alphabet_global_updates(
        spec, noise, g, track, data.real, data.fold, vargi_acc, vargR_acc,
        vargL, state.varg, state.pi, state.vara_fold, state.lambda2,
    )

    # --- genetic + residual variances (src/Bayes.cpp:819-823) ---
    if spec.row_padded:
        su = u.sum(-1)
        vara = (_dot(u, u) - su * su / spec.n_obs) / (spec.n_obs - 1)
    else:
        vara = _var(u)
    chi_e = _draw(noise, lambda nz: nz.chisq(STREAM_VE, spec.n_obs + spec.dfvare))
    vare = (_dot(yadj, yadj) + spec.s2vare * spec.dfvare) / chi_e

    nzrate, wppa = pip_counters(spec, data, state, track)

    mu, beta, estR = pre["mu"], pre["beta"], pre["estR"]
    # --- periodic drift resync (f32 only; exact recompute of yadj and u) ---
    if (spec.resync_every and dt == torch.float32
            and state.it % spec.resync_every == spec.resync_every - 1):
        yadj, u = _recompute_residuals(spec, data, mu, beta, estR, g,
                                       pre["J_beta"], pre["epsl_estR"])

    return ChainState(
        it=state.it + 1, mu=mu, beta=beta, estR=estR, vrtmp=pre["vrtmp"],
        vr=pre["vr"], yadj=yadj, u=u, g=g, varg=varg, vargL=vargL,
        lambda2=lambda2, pi=pi, vara_fold=vara_fold, vara=vara, vare=vare,
        track=track, nzrate=nzrate, wppa=wppa, J_beta=pre["J_beta"],
        epsl_estR=pre["epsl_estR"], vepstmp=pre["vepstmp"], veps=pre["veps"],
    )


def _check_ported(spec: GibbsSpec, mesh, nchains: int = 1) -> None:
    """Raise for the configurations whose code paths are still to be ported
    (ROADMAP.md, queue 1)."""
    if mesh is not None or spec.emulate_shards > 1 or spec.shard_schedule != "turn":
        raise NotImplementedError(
            "meshes and shard schedules are not ported yet (ROADMAP queue 1, "
            "items 13-14: multi-GPU and the concurrent schedule)")
    if spec.use_bslmm:
        raise NotImplementedError("BSLMM is not ported yet (ROADMAP queue 1, item 9)")
    if spec.reject_guard or spec.seg_sizes:
        raise NotImplementedError(
            "the summary-level engine is not ported yet (ROADMAP queue 1, items 10-11)")
    if nchains > 1 and spec.qe:
        raise NotImplementedError(
            "single-step chains in a batch are not ported yet: the epsilon sweep "
            "(mme_sweep) runs one chain (ROADMAP queue 1, item 6)")


def one_iteration(spec: GibbsSpec, data: GibbsData, seed: int,
                  state: ChainState, noise=None, mesh=None) -> ChainState:
    """One MCMC iteration of one chain on one device: pre-sweep effects, the
    SNP sweep at K = 1, global updates.  ``noise`` defaults to the port's
    own streams for (seed, state.it)."""
    _check_ported(spec, mesh)
    if noise is None:
        noise = IterNoise(seed, state.it, data.y.device, data.y.dtype)
    pre = _pre_sweep(spec, data, noise, state)
    sweep_out = _run_sweep_k1(spec, data, pre, state.g)
    return _post_sweep(spec, data, noise, state, pre, sweep_out)


def one_iteration_batch(spec: GibbsSpec, data: GibbsData, seed: int,
                        states: ChainState, noise=None, mesh=None) -> ChainState:
    """One iteration of K chains (``one_iteration_batch``,
    hibayes_tpu/engine/gibbs.py:2382-2439, without a mesh): ``states`` holds
    a leading chain axis.  The pre- and post-sweep run as tensor ops over
    all chains; the sweep is ``blockgibbs.sweep_mc`` over the K chains,
    which share each genotype block.  ``noise`` defaults to each chain's
    own streams (:func:`chain_noise`); a test may pass any list of K."""
    K = int(states.mu.shape[0])
    _check_ported(spec, mesh, K)
    if noise is None:
        noise = chain_noise(seed, states.it, K, data.y.device, data.y.dtype)
    pre = _pre_sweep(spec, data, noise, states)
    sweep_out = blockgibbs.sweep_mc(
        spec, pre["consts"], data.X_blocks, data.W_blocks, data.xpx, data.vx,
        pre["vei"], states.g, *pre["rnd"], pre["vargL_in"], pre["yadj"], pre["u"])
    return _post_sweep(spec, data, noise, states, pre, sweep_out)


# ---------------------------------------------------------------------------
# running a chain or a batch of chains
# ---------------------------------------------------------------------------


def _print_progress(spec: GibbsSpec, state: ChainState, eta_str: str) -> None:
    # one host read per row: everything the row shows, stacked on the device
    dt = state.vara.dtype
    vals = torch.cat([(state.track > 0).sum().to(dt).reshape(1),
                      state.vara.reshape(1), state.vare.reshape(1),
                      state.pi.to(dt)]).tolist()
    nnz = spec.m - spec.nvar0 if spec.model_index in (1, 2, 5) else int(vals[0])
    vara, vare, pi = vals[1], vals[2], vals[3:]
    pi_str = " ".join(f"{p:.4f}" for p in pi)
    print(f" {state.it:>6d}  {nnz:>6d}  {pi_str}  Vg {vara:.4f}  Ve {vare:.4f}  "
          f"h2 {vara / max(vara + vare, 1e-30):.4f}  {eta_str}")


def stack_state(state, nchains: int):
    """``nchains`` copies of one chain's state (either engine's) on a
    leading chain axis; ``it`` stays one int."""
    rep = lambda t: t.expand((nchains,) + tuple(t.shape)).clone()
    return state._replace(**{
        name: tuple(rep(e) for e in v) if isinstance(v, tuple) else rep(v)
        for name, v in state._asdict().items() if name != "it"})


def run_loop(spec, state, step, snapshot, progress=False, chunk_records=0):
    """Burn-in, thinning and records of one chain or a batch (either
    engine): ``state = step(state)`` niter_eff times, ``snapshot(state)``
    kept every ``thin`` iterations after burn-in.  With ``progress``, a
    reference-style row (iter / NnzSnp / pi / Vg / Ve / h2 / time left,
    src/Bayes.cpp:884-914) every ``chunk_records`` records (a tenth of the
    chain by default).  Returns (state, samples, seconds): numpy samples
    with a leading records axis, and the wall time once the device has
    finished."""
    if chunk_records <= 0:
        chunk_records = max(spec.n_records // 10, 1)
    every = chunk_records * spec.thin
    total = spec.niter_eff
    snaps = []
    t0 = time.time()
    for done in range(1, total + 1):
        state = step(state)
        if done > spec.nburn and (done - spec.nburn) % spec.thin == 0:
            snaps.append(snapshot(state))
        if progress and (done % every == 0 or done == total):
            sec = int((time.time() - t0) / done * (total - done))
            _print_progress(spec, state,
                            f"{sec // 3600:02d}h{sec % 3600 // 60:02d}m{sec % 60:02d}s")
    if state.vare.is_cuda:
        torch.cuda.synchronize(state.vare.device)
    seconds = time.time() - t0
    samples = ({k: torch.stack([s[k] for s in snaps]).cpu().numpy() for k in snaps[0]}
               if snaps else {})
    return state, samples, seconds


def posterior_rates(spec: GibbsSpec, state):
    """PIP and WPPA from the final counters (one chain or a batch): PIP == 1
    clamped to (nzct - 1) / nzct (src/Bayes.cpp:1030), 1 for the models
    without a mixture.  Returns (pip, wppa, nzct)."""
    nzct = spec.n_records * spec.thin
    pip = state.nzrate / nzct
    pip = torch.where(pip >= 1.0, (nzct - 1.0) / nzct, pip)
    if spec.model_index in (1, 2, 5):
        pip = torch.ones_like(pip)
    wppa = state.wppa / nzct
    wppa = torch.where(wppa >= 1.0, (nzct - 1.0) / nzct, wppa)
    return pip, wppa, nzct


def run_chain(spec: GibbsSpec, data: GibbsData, priors: Priors, pi_init,
              seed=666666, progress=False, chunk_records=0):
    """Run the full chain; returns (final_state, samples dict, summaries dict).
    The summaries hold pip, wppa, nzct and the chain's wall ``seconds``, taken
    once the device has finished its iterations.

    Samples are numpy arrays with a leading axis of n_records; alpha is cut
    to the real m.  With ``progress``, a reference-style row is printed
    every ``chunk_records`` records (:func:`run_loop`)."""
    state, samples, seconds = run_loop(
        spec, init_state(spec, data, priors, pi_init),
        lambda st: one_iteration(spec, data, seed, st), lambda st: _snapshot(spec, st),
        progress, chunk_records)
    if not bool(torch.isfinite(state.vare)):
        warnings.warn("chain diverged: residual variance is non-finite at the "
                      "final iteration", UserWarning, stacklevel=2)
    pip, wppa, nzct = posterior_rates(spec, state)
    if samples:
        samples["alpha"] = samples["alpha"][:, : spec.m]
    extras = {"pip": pip[: spec.m].cpu().numpy(), "wppa": wppa.cpu().numpy(),
              "nzct": nzct, "seconds": seconds}
    return state, samples, extras


def check_chain_options(nchains: int, mesh, checkpoint_path, progress) -> None:
    """Raise for the options of a chain batch that are still to be ported."""
    if nchains < 1:
        raise ValueError(f"nchains must be at least 1, got {nchains}")
    if mesh is not None:
        raise NotImplementedError(
            "a mesh is not ported yet (ROADMAP queue 1, item 13: multi-GPU)")
    if checkpoint_path is not None or progress:
        raise NotImplementedError(
            "checkpoints and progress rows of a chain batch (its segmented "
            "run) are not ported yet (ROADMAP queue 1, item 7)")


def batch_results(spec, states, samples, extras_real, seconds):
    """The summaries of a chain batch: divergence warning, records per
    chain (nchains, n_records, ...), PIP and WPPA averaged over chains, the
    split R-hat of every sampled parameter.  ``extras_real`` (a numpy index
    of the real SNPs, or a slice) cuts the per-SNP arrays."""
    bad = ~torch.isfinite(states.vare)
    if bool(bad.any()):
        warnings.warn(f"{int(bad.sum())}/{bad.numel()} chains diverged (non-finite "
                      "residual variance at the final iteration)", UserWarning,
                      stacklevel=3)
    samples = {k: np.swapaxes(v, 0, 1) for k, v in samples.items()}
    samples["alpha"] = samples["alpha"][:, :, extras_real]
    pip, wppa, nzct = posterior_rates(spec, states)
    extras = {"pip": pip.mean(0).cpu().numpy()[extras_real],
              "wppa": wppa.mean(0).cpu().numpy(), "nzct": nzct,
              "rhat": rhat_diagnostics(samples), "seconds": seconds}
    return samples, extras


def run_chains(spec: GibbsSpec, data: GibbsData, priors: Priors, pi_init,
               seed=666666, nchains=4, mesh=None, checkpoint_path=None,
               progress=False, chunk_records=0):
    """Run ``nchains`` independent chains (chain k on the streams of (seed,
    k), identical data and priors) as one batch; the counterpart of
    ``run_chains`` (hibayes_tpu/engine/gibbs.py:2512-2590) on one device.
    Returns (states, samples, extras): samples with leading axes (nchains,
    n_records, ...); extras with pip and wppa averaged over chains, nzct,
    the split R-hat of every sampled parameter (``rhat``) and the wall
    ``seconds`` once the device has finished.  One chain runs
    :func:`run_chain` (chain 0's streams are the single chain's), with the
    chain axis added."""
    check_chain_options(nchains, mesh, checkpoint_path, progress)
    if nchains == 1:
        state, samples, extras = run_chain(spec, data, priors, pi_init, seed=seed)
        samples = {k: v[None] for k, v in samples.items()}
        return (stack_state(state, 1), samples,
                {**extras, "rhat": rhat_diagnostics(samples)})
    _check_ported(spec, mesh, nchains)
    states, samples, seconds = run_loop(
        spec, stack_state(init_state(spec, data, priors, pi_init), nchains),
        lambda ss: one_iteration_batch(spec, data, seed, ss),
        lambda ss: _snapshot(spec, ss))
    samples, extras = batch_results(spec, states, samples, slice(0, spec.m), seconds)
    return states, samples, extras


def rhat_diagnostics(samples, max_entries=256) -> dict:
    """Split-R-hat per sampled parameter (``rhat_diagnostics``,
    hibayes_tpu/engine/gibbs.py:2593-2614): scalars directly, vector
    parameters (alpha, GEBV-like traces) as the MAX split-R-hat over
    ``max_entries`` evenly-subsampled entries.  ``samples`` holds numpy
    arrays of shape (nchains, n_records, ...)."""
    out = {}
    for k, v in samples.items():
        nd = getattr(v, "ndim", 0)
        if nd == 2:
            out[k] = gelman_rubin(np.asarray(v))
        elif nd == 3 and v.shape[2] > 0 and v.shape[1] >= 4:
            idx = np.unique(
                np.linspace(0, v.shape[2] - 1, min(v.shape[2], max_entries))
                .astype(int)
            )
            sub = np.asarray(v[:, :, idx], dtype=np.float64)
            vals = [gelman_rubin(sub[:, :, j]) for j in range(sub.shape[2])]
            vals = [r for r in vals if np.isfinite(r)]
            out[k] = float(max(vals)) if vals else float("nan")
    return out


def gelman_rubin(chains: np.ndarray) -> float:
    """Split-R-hat over (nchains, n_records) scalar samples (``gelman_rubin``,
    hibayes_tpu/engine/gibbs.py:2617-2630)."""
    x = np.asarray(chains, dtype=np.float64)
    if x.ndim != 2 or x.shape[1] < 4:
        return float("nan")
    half = x.shape[1] // 2
    splits = np.concatenate([x[:, :half], x[:, half: 2 * half]], axis=0)
    k, n_ = splits.shape
    means = splits.mean(axis=1)
    w = splits.var(axis=1, ddof=1).mean()
    b = n_ * means.var(ddof=1)
    if w <= 0:
        return float("nan")
    var_plus = (n_ - 1) / n_ * w + b / n_
    return float(np.sqrt(var_plus / w))
