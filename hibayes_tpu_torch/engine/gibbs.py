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
from ..parallel.distributed import all_gather, axis_sum, barrier, broadcast, ring_hop
from ..parallel.mesh import SnpShard, snp_blocks
from ..utils.profiling import span, spanned
from . import checkpoint
from .rng import (STREAM_BSLMM_CHI, STREAM_BSLMM_Z, STREAM_COV, STREAM_EPSL_CHI,
                  STREAM_EPSL_J, STREAM_EPSL_Z, STREAM_FACTOR, STREAM_LAMBDA, STREAM_MU,
                  STREAM_PI, STREAM_SNP_CHI, STREAM_SNP_U, STREAM_SNP_Z, STREAM_SNP_Z2,
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
        # individual-level engine only (seg_sizes marks a summary-LD spec,
        # where cross-shard coupling is bounded by the LD tile overlap, not
        # by the X'X rank deficiency)
        if (self.shard_schedule == "concurrent" and self.m > self.n_obs
                and not self.seg_sizes):
            warnings.warn(
                f"shard_schedule='concurrent' with m ({self.m}) > n "
                f"({self.n_obs}): the relaxed kernel is a block-Jacobi "
                "splitting whose iteration operator can exceed spectral "
                "radius 1 in this rank-deficient regime — measured Vg "
                "deflation ~30% / Ve inflation ~50% at n=4096 x m=65536, "
                "and divergence (NaN) at high shard x merge-round counts.  "
                "Use shard_schedule='pipeline' (exact, all shards busy, "
                "nchains a multiple of the shard count) or 'turn' (exact).",
                UserWarning, stacklevel=2)

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
    """State of one chain, the fields of the JAX ``ChainState`` in its
    order.  ``it`` is a Python int; the rest are tensors on the chain's
    device."""

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
    # BSLMM polygenic term
    k_estR: torch.Tensor     # (n,) polygenic effects in data space (size 0 off)
    vbtmp: torch.Tensor
    va: torch.Tensor
    vb: torch.Tensor
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


class Segments(NamedTuple):
    """The rows of each level of a vector of codes, for sums by level
    (:func:`_segment_sum`): ``order`` the codes' stable sort order,
    ``offsets`` (nlev + 1,) int64 where each level's rows start in it.
    Made once, where the codes are (:func:`segments`)."""

    order: torch.Tensor
    offsets: torch.Tensor


class GibbsData(NamedTuple):
    """Device-resident inputs.  X_blocks is the genotype in blocks of B =
    ``block``, each laid out as the S sub-blocks of W SNPs that the sweeps
    take (:func:`genotype_layout`, ``blockgibbs.SubBlocks.of(block, W)``;
    S = 1 and W = B where they take B as it is).  The BSLMM and single-step
    fields have size 0 when the term is off."""

    y: torch.Tensor            # (n,)
    X_blocks: torch.Tensor     # (nblocks S, n, W) int8 or float, pad columns 0
    W_blocks: torch.Tensor     # (nblocks S, W, W) each sub-block's Gram matrix
    C_blocks: torch.Tensor     # (nblocks S, W, W) X_k' X_{k-1}, consecutive sub-blocks (0 first)
    xpx: torch.Tensor          # (m_pad,)
    vx: torch.Tensor           # (m_pad,)
    real: torch.Tensor         # (m_pad,) bool: real (non-padding) SNPs
    C: torch.Tensor            # (n, nc)
    cpc: torch.Tensor          # (nc,)
    r_codes: tuple             # per factor (n,) int64
    r_counts: tuple            # per factor (nlev_i,)
    r_segs: tuple              # per factor Segments of r_codes (padded rows in level 0)
    fold: torch.Tensor         # (n_fold,)
    windindx0: torch.Tensor    # (m_pad,) int64 0-based window ids (pad -> nw)
    K: torch.Tensor            # (n, n) eigenvectors of the GRM (BSLMM)
    Kval: torch.Tensor         # (n,) its eigenvalues
    epsl_yJ: torch.Tensor      # (n,) J covariate
    epsl_codes: torch.Tensor   # (ne,) int64 level of each imputed individual
    epsl_counts: torch.Tensor  # (qe_pad,)
    epsl_segs: Segments        # of the epsl_codes of the rows held, over qe_pad levels
    block: int                 # B: SNPs a block (spec.block)
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


def checked_lengths(ids, nseg: int, what: str) -> np.ndarray:
    """Entries per segment (nseg,) of the segment ids ``ids`` (numpy).  The
    one check of the lengths, made where they are made: an id outside
    [0, nseg) is refused, so no length is negative and they sum to the ids
    held.  The iteration's sums then reduce without a check (a check reads
    the lengths back to the host)."""
    ids = np.asarray(ids, dtype=np.int64)
    if ids.size and (ids.min() < 0 or ids.max() >= nseg):
        raise ValueError(f"{what} must lie in [0, {nseg}); they span "
                         f"[{ids.min()}, {ids.max()}]")
    return np.bincount(ids, minlength=nseg)


def segments(codes, nlev: int, device) -> Segments:
    """:class:`Segments` of ``codes`` (numpy or a tensor, every row held,
    padded rows included) over ``nlev`` levels, made on the host."""
    c = np.asarray(codes.cpu() if isinstance(codes, torch.Tensor) else codes, np.int64)
    lengths = checked_lengths(c, nlev, "level codes")
    as_t = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)
    return Segments(as_t(np.argsort(c, kind="stable")),
                    as_t(np.concatenate([[0], np.cumsum(lengths)])))


def pad_to_block(m: int, block: int) -> int:
    return ((m + block - 1) // block) * block


def _columns(M, c0: int, c1: int, dtype, device) -> torch.Tensor:
    """Columns [c0, c1) of a numpy or torch genotype as a tensor on device."""
    if isinstance(M, torch.Tensor):
        return M[:, c0:c1].to(device=device, dtype=dtype)
    return torch.from_numpy(np.ascontiguousarray(M[:, c0:c1])).to(
        device=device, dtype=dtype)


@spanned("model.prepare")
def prepare_gibbs_data(
    y, M, *, C=None, r_codes=(), r_nlevels=(), fold=None, windindx=None, nw=0,
    K=None, Kval=None, epsl_yJ=None, epsl_A=None, epsl_codes=None, qe=0,
    block=64, dtype=torch.float32, geno_dtype=None, pad_n="auto",
    device="cpu", nblocks_multiple=1, mesh=None,
) -> GibbsData:
    """Build the device-resident GibbsData (block layout, Gram matrices, stats).

    Port of ``prepare_gibbs_data`` (hibayes_tpu/engine/gibbs.py:1871-2052).
    ``M`` is an (n, m) numpy array or torch tensor on any device; it is
    copied block by block into ``X_blocks`` on ``device``, each block of B
    as the sub-blocks the sweeps take (:func:`genotype_layout`), and the
    Gram matrices are those of the sub-blocks.

    BSLMM takes the GRM's eigenvectors ``K`` (n, n) and eigenvalues
    ``Kval`` (n,) (:func:`~hibayes_tpu_torch.math.grm.make_grm` with
    eigen=True), numpy arrays or tensors, stored in ``dtype``.

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
    ``C_blocks`` holds the cross-Grams X_k' X_{k-1} of consecutive kernel
    blocks (entry 0 zero; a shard's first block too), formed in the same
    cast batches and dtype as the Gram blocks: a batch is one block smaller
    than GRAM_BATCH_BYTES allows, since it is formed with the block before
    it (the one-chain sweep's lookahead reads them).

    pad_n="auto" zero-pads the individual axis to a multiple of 512 for
    n > 4096, as the JAX engine does, so arrays and statistics match it;
    ``GibbsSpec.n`` is then the padded count and ``n_real`` the real one.

    ``nblocks_multiple`` pads the block count to a multiple of it with
    all-zero blocks (vx 0: never active), as a SNP-sharded mesh or the
    pipeline emulation needs the shards to divide the blocks.

    ``M`` may be a :class:`~hibayes_tpu_torch.parallel.mesh.SnpShard`, this
    rank's columns over the ``snp`` axis of ``mesh`` (a genotype larger
    than one device, which no rank holds whole): the columns of
    ``mesh.snp_range(m, block, nblocks_multiple)``, the block count padded
    to a multiple of the axis too.  ``X_blocks`` and ``W_blocks`` then hold
    this rank's blocks alone (``shard_gibbs_data`` keeps them), and ``xpx``,
    ``vx`` and ``real`` the whole m_pad, gathered over ``snp`` (span
    ``model.shard_stats``): every rank's, bit for bit the whole genotype's.
    Every rank calls it alike.
    """
    device = torch.device(device)
    y_np = np.asarray(y)
    n = int(y_np.shape[0])
    n_real = n
    dense_term = K is not None or epsl_yJ is not None or epsl_A is not None
    if pad_n == "auto":
        pad_n = not dense_term and n > 4096 and n % 512 != 0
    if pad_n:
        if dense_term:
            raise ValueError("pad_n is not supported with BSLMM/epsilon terms")
        n = pad_to_block(n, 512)
    y_t = torch.zeros((n,), dtype=dtype, device=device)
    y_t[:n_real] = torch.as_tensor(y_np, dtype=dtype, device=device)
    use_int8 = geno_dtype in ("int8", torch.int8, np.int8)
    shard = M if isinstance(M, SnpShard) else None
    S = 1
    if shard is not None:
        M, m = shard.values, int(shard.m)
        S = mesh.size("snp") if mesh is not None else 1
        if S <= 1:
            raise ValueError("prepare_gibbs_data: a SnpShard needs a mesh with an snp axis")
        want = mesh.snp_range(m, block, nblocks_multiple)
        if (int(shard.start), int(M.shape[1])) != want:
            raise ValueError(f"prepare_gibbs_data: this rank holds columns (start, count) = "
                             f"{want} of the {m} SNPs (Mesh.snp_range), not "
                             f"({shard.start}, {M.shape[1]})")
    else:
        m = int(M.shape[1])
    block, nblocks = snp_blocks(m, block, S, nblocks_multiple)
    m_pad = nblocks * block
    nbl = nblocks // S   # the blocks this rank holds, from column c_off
    c_off = (mesh.index("snp") * nbl if shard is not None else 0) * block

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
    sb = genotype_layout(block, n, x_dtype.itemsize, 2 if fold is None else len(fold))
    nbk, W = nbl * sb.S, sb.W
    with span("model.layout"):
        X_blocks = torch.zeros((nbk, n, W), dtype=x_dtype, device=device)
        for k in range(nbk):
            c0 = c_off + (k // sb.S) * block + (k % sb.S) * W
            c1 = min(m, c_off + (k // sb.S) * block + min(block, (k % sb.S + 1) * W))
            if c0 < c1:
                X_blocks[k, :n_real, : c1 - c0] = _columns(M, c0 - c_off, c1 - c_off,
                                                           x_dtype, device)

    gram_dt = torch.float32 if use_int8 else dtype
    W_blocks = torch.empty((nbk, W, W), dtype=dtype, device=device)
    C_blocks = torch.empty((nbk, W, W), dtype=dtype, device=device)
    s1 = torch.empty((nbk, W), dtype=gram_dt, device=device)
    xpx = torch.empty((nbk, W), dtype=dtype, device=device)
    vx = torch.empty((nbk, W), dtype=dtype, device=device)
    row_real = (torch.arange(n, device=device) < n_real)[None, :, None]
    # a batch is formed with the block before it: one block fewer
    per = max(1, GRAM_BATCH_BYTES // (n * W * gram_dt.itemsize) - 1)
    prev = None
    with span("model.gram"):
        for b0 in range(0, nbk, per):
            b1 = min(nbk, b0 + per)
            Xf = X_blocks[b0:b1].to(gram_dt)
            W_blocks[b0:b1] = torch.bmm(Xf.transpose(1, 2), Xf).to(dtype)
            C_blocks[b0:b1] = blockgibbs.cross_gram_batch(Xf, prev).to(dtype)
            prev = Xf[-1]
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
    xpx = sb.gather(xpx.reshape(nbk * W))
    vx = sb.gather(vx.reshape(nbk * W))
    if shard is not None:
        with span("model.shard_stats"):
            xpx = all_gather(xpx, mesh, "snp", dim=0)
            vx = all_gather(vx, mesh, "snp", dim=0)
    real = torch.arange(m_pad, device=device) < m
    vx = torch.where(real, vx, 0.0)

    if C is None:
        C_t = torch.zeros((n, 0), dtype=dtype, device=device)
    else:
        C_t = torch.zeros((n, np.asarray(C).shape[1]), dtype=dtype, device=device)
        C_t[:n_real] = torch.as_tensor(np.asarray(C), dtype=dtype, device=device)
    cpc = (C_t * C_t).sum(dim=0)

    row_w = (torch.arange(n, device=device) < n_real).to(dtype)
    codes_t, counts_t, segs_t = [], [], []
    for c, nl in zip(r_codes, r_nlevels):
        c_np = np.zeros((n,), dtype=np.int64)
        c_np[:n_real] = np.asarray(c)
        segs_t.append(segments(c_np, int(nl), device))
        ct = torch.as_tensor(c_np, device=device)
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
                else torch.as_tensor(a, dtype=dt, device=device))

    codes_np = None if epsl_codes is None else np.asarray(epsl_codes, dtype=np.int64)
    epsl_segs = segments(codes_np if qe else (), qe_pad, device)
    return GibbsData(
        y=y_t, X_blocks=X_blocks, W_blocks=W_blocks, C_blocks=C_blocks, xpx=xpx, vx=vx,
        real=real, C=C_t, cpc=cpc, r_codes=tuple(codes_t),
        r_counts=tuple(counts_t), r_segs=tuple(segs_t), fold=fold_t, windindx0=wind0,
        K=tensor(K, dtype, (0, 0)), Kval=tensor(Kval, dtype, (0,)),
        epsl_yJ=tensor(None if epsl_yJ is None else np.asarray(epsl_yJ, np.float64),
                       dtype, (0,)),
        epsl_codes=tensor(codes_np, torch.int64, (0,)),
        epsl_counts=tensor(np.bincount(codes_np, minlength=qe_pad) if qe else None,
                           dtype, (0,)),
        epsl_segs=epsl_segs,
        block=block,
        epsl_sp=epsl_sp,
    )


def genotype_layout(block: int, n: int, xbytes: int, n_fold: int):
    """The sub-blocks (ops/blockgibbs.py:SubBlocks) in which a genotype of n
    rows of ``xbytes`` bytes in blocks of ``block`` is laid out: those the
    sweeps take at the most packed rows a SNP of any model with ``n_fold``
    folds (:func:`~hibayes_tpu_torch.ops.blockgibbs.genotype_rows`), so
    that one layout serves every model.  The same on every device."""
    return blockgibbs.mc_sub_blocks(blockgibbs.genotype_rows(n_fold), n, block, xbytes)


def _epsl_layout(diag_blocks, fwd, coo, qe_pad, dtype, device) -> EpslSparse:
    """EpslSparse from host parts: ``diag_blocks`` (nbr, T, T); ``fwd`` per
    block the forward triplets (global rows, in-block cols, vals); ``coo``
    (rows, cols, vals) of the whole A in any order.  ``coo_len`` is checked
    here, once (:func:`checked_lengths`): the matvecs reduce without a check."""
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
        coo_len=as_t(checked_lengths(rows, qe_pad, "A's row indices"), torch.int64),
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


def rows_cut(spec: GibbsSpec, data: GibbsData) -> bool:
    """Whether ``data`` holds a part of the individuals (this rank's, on an
    ind mesh: parallel/mesh.py:shard_gibbs_data)."""
    return int(data.y.shape[0]) != spec.n


def local_rows(spec: GibbsSpec, data: GibbsData, mesh=None) -> tuple:
    """(first row, rows) of the individuals ``data`` holds: all of them, or
    this rank's part on ``mesh``."""
    if not rows_cut(spec, data):
        return 0, spec.n
    return mesh.row_range(spec.n)


def epsl_part(n: int, ne: int, r0: int, nr: int) -> tuple:
    """(t0, c0): of local rows [r0, r0 + nr) of n, the non-genotyped ones
    (the last ne) start at local row t0, and their codes at epsl_codes[c0]."""
    t0 = min(max(n - ne - r0, 0), nr)
    return t0, r0 + t0 - (n - ne)


def local_blocks(spec: GibbsSpec, data: GibbsData, mesh=None) -> tuple:
    """(first block, blocks) of the SNP blocks ``data`` holds: all of them,
    or this rank's part on a snp mesh."""
    S = blockgibbs.SubBlocks.of(spec.block, data.X_blocks.shape[2]).S
    nbl = int(data.X_blocks.shape[0]) // S
    if nbl == spec.nblocks:
        return 0, nbl
    return mesh.index("snp") * nbl, nbl


def init_state(spec: GibbsSpec, data: GibbsData, priors: Priors, pi_init,
               mesh=None) -> ChainState:
    """The initial state; on a mesh (``data`` this rank's part, ``mesh``
    its mesh) this rank's part of it."""
    dt = data.y.dtype
    dev = data.y.device
    m_pad = spec.m_pad
    r0, n = local_rows(spec, data, mesh)
    nr = len(spec.nlevels)

    def full(shape, v):
        return torch.full(shape, float(v), dtype=dt, device=dev)

    if rows_cut(spec, data):
        mu0 = axis_sum(data.y.sum(), mesh, "ind") / spec.n_obs
        yadj0 = torch.where(torch.arange(r0, r0 + n, device=dev) < spec.n_obs,
                            data.y - mu0, 0.0)
    elif spec.row_padded:
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
        k_estR=full((n,) if spec.use_bslmm else (0,), 0.0),
        vbtmp=full((), priors.vara),
        va=full((), priors.varg),
        vb=full((), priors.vara),
        J_beta=full((), 0.0),
        epsl_estR=full((spec.qe_pad or spec.qe,), 0.0),
        vepstmp=full((), priors.vara),
        veps=full((), priors.vara),
    )


def _snapshot(spec: GibbsSpec, state: ChainState, mesh=None) -> dict:
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
    if spec.use_bslmm:
        snap["Va"] = state.va
        snap["Vb"] = state.vb
        snap["k_estR"] = (state.k_estR if mesh is None
                          else all_gather(state.k_estR, mesh, "ind", total=spec.n))
    if spec.qe:
        snap["Veps"] = state.veps
        snap["J"] = state.J_beta
        snap["epsilon"] = state.epsl_estR[..., : spec.qe]
    return snap


def genotype_rmatmul(X_blocks, w, dtype, block: int) -> torch.Tensor:
    """X' w (nblocks * B,) for X in the layout of ``prepare_gibbs_data``
    (blocks of ``block``) and w (n,), block by block, so that no copy of the
    whole genotype in ``dtype`` ever exists."""
    nbk, n, W = X_blocks.shape
    out = torch.empty((nbk, W), dtype=dtype, device=X_blocks.device)
    w = w.to(dtype)
    for b in range(nbk):
        out[b] = X_blocks[b].to(dtype).T @ w
    return blockgibbs.SubBlocks.of(block, W).gather(out.reshape(nbk * W))


def genotype_matmul(X_blocks, G, dtype, block: int, out=None) -> torch.Tensor:
    """X @ G for X in the layout of ``prepare_gibbs_data`` (blocks of
    ``block``) and G (nblocks * B, r), block by block, so that no copy of
    the whole genotype in ``dtype`` ever exists.  ``out`` (n, r), where
    given, is the sum to add onto, in place (zeros otherwise)."""
    nbk, n, W = X_blocks.shape
    if out is None:
        out = torch.zeros((n, G.shape[1]), dtype=dtype, device=X_blocks.device)
    G = blockgibbs.SubBlocks.of(block, W).spread(G.to(dtype).T).T
    for b in range(nbk):
        out.addmm_(X_blocks[b].to(dtype), G[b * W:(b + 1) * W])
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


def _segment_sum(values, seg: Segments):
    """Per-level sums of ``values`` over its last axis, added in a fixed
    order: its rows in ``seg.order``, each level's summed by segment_reduce.
    index_add_ adds with atomics on a GPU, in an order that changes from run
    to run; a chain must be reproducible for its seed.  The offsets were
    checked where they were made (:func:`segments`), so nothing here reads
    back to the host."""
    if values.dim() == 1:
        return torch.segment_reduce(values[seg.order], "sum", offsets=seg.offsets,
                                    unsafe=True)
    return torch.segment_reduce(values[:, seg.order].T, "sum", offsets=seg.offsets,
                                unsafe=True).T


# ---------------------------------------------------------------------------
# blocked single-site Gibbs for the single-step epsilon term
# ---------------------------------------------------------------------------


def _epsl_matvec(sp: EpslSparse, x):
    """A @ x for the sparse A-inverse(nn), row by row (no atomics), for one
    chain's x (q,) or a batch's (K, q).  ``coo_len`` was checked where
    :func:`_epsl_layout` made it, so the sums read nothing back to the host."""
    mm = lambda v: segment_matmul(sp.coo_len, sp.coo_cols, sp.coo_vals, v, checked=False)
    return mm(x) if x.dim() == 1 else mm(x.T).T


def blocked_mme_gibbs_sparse(sp: EpslSparse, counts, scale, x, b, ve, z):
    """Single-site Gibbs sweep over LHS = scale A + diag(counts) for A in
    the packed layout (``blocked_mme_gibbs_sparse``,
    hibayes_tpu/engine/gibbs.py:576-654): per diagonal block, T in-block
    draws (TPU kernel 10), then the block's forward triplets into the
    residual.  The sweep is ``blockgibbs.mme_sweep``: one CUDA launch on a
    GPU, its plain version on the CPU.  Zero-padded sites stay frozen.
    One chain, or a batch (x, b, z (K, q); scale, ve (K,)).
    Returns (x_new, A @ x_new); the matvec feeds the Veps quadratic form."""
    res = b - scale[..., None] * _epsl_matvec(sp, x) - counts * x
    x_new, _ = blockgibbs.mme_sweep(sp, counts, scale, ve, z, x, res)
    return x_new, _epsl_matvec(sp, x_new)


def _epsilon_draw(spec: GibbsSpec, data: GibbsData, noise, J_beta, epsl_estR,
                  vepstmp, yadj, u, ve, mesh=None):
    """The single-step imputation-error term (hibayes_tpu/engine/gibbs.py:900-949,
    src/Bayes.cpp:554-584): the J covariate, then epsilon | rest by
    single-site Gibbs on (Z'Z + A-inverse(nn) ve / veps), then Veps, for one
    chain or a batch (each chain's draws from its own streams; the epsilon
    sweep over all chains at once).  On an ind mesh J's sums and the per-site
    sums of the non-genotyped rows (the last ne) are summed over the axis and
    the sweep runs replicated.  Returns (J_beta, epsl_estR, vepstmp, yadj, u)."""
    dev = yadj.device
    n, ne, qe = spec.n, spec.ne, spec.qe
    r0, nr = local_rows(spec, data, mesh)
    isum = lambda x: axis_sum(x, mesh, "ind")
    yJ = data.epsl_yJ
    JtJ = isum(torch.dot(yJ, yJ))
    rhs = isum(_dot(yJ, yadj)) + JtJ * J_beta
    J_new = rhs / JtJ + torch.sqrt(ve / JtJ) * _draw(
        noise, lambda nz: nz.normal(STREAM_EPSL_J, ()))
    yadj = yadj + (J_beta - J_new)[..., None] * yJ
    u = u - (J_beta - J_new)[..., None] * yJ
    qe_p = spec.qe_pad or qe
    t0, c0 = epsl_part(n, ne, r0, nr)
    codes = data.epsl_codes[c0:c0 + nr - t0]
    rhs_e = (isum(_segment_sum(yadj[..., t0:], data.epsl_segs))
             + data.epsl_counts * epsl_estR)
    scale = ve / vepstmp
    # qe normals on the direct path, qe_pad with the padding frozen on the
    # scale path (JAX's noise shapes); the layout pads a dense A's qe sites
    # to whole blocks, where they stay frozen too
    ze = _draw(noise, lambda nz: nz.normal(STREAM_EPSL_Z, (qe_p,)))
    ze = torch.where(torch.arange(qe_p, device=dev) < qe, ze, 0.0)
    sp = data.epsl_sp
    pad = lambda v: torch.nn.functional.pad(v, (0, sp.coo_len.shape[0] - qe_p))
    new_e, Ae = blocked_mme_gibbs_sparse(sp, pad(data.epsl_counts), scale, pad(epsl_estR),
                                         pad(rhs_e), ve, pad(ze))
    new_e = new_e[..., :qe_p]
    quad = _dot(new_e, Ae[..., :qe_p])
    diff_e = (epsl_estR - new_e)[..., codes]
    yadj = torch.cat([yadj[..., :t0], yadj[..., t0:] + diff_e], dim=-1)
    u = torch.cat([u[..., :t0], u[..., t0:] - diff_e], dim=-1)
    chi = _draw(noise, lambda nz: nz.chisq(STREAM_EPSL_CHI, spec.dfvara + qe))
    vepstmp = (quad + spec.s2vara * spec.dfvara) / chi
    return J_new, new_e, vepstmp, yadj, u


def _bslmm_draw(spec: GibbsSpec, data: GibbsData, noise, k_estR, vbtmp, yadj, u, ve,
                mesh=None):
    """BSLMM's polygenic term k | rest in the eigenbasis K diag(Kval) K' of
    the GRM, then its variance (hibayes_tpu/engine/gibbs.py:876-898), for
    one chain or a batch: a row vector times K (or K') is one product over
    the chain axis.  The GRM products stay library products, as XLA's are
    in the JAX package.  On an ind mesh a rank holds K's rows of its
    individuals, and the products over individuals are summed over the
    axis.  Returns (k_estR, vbtmp, yadj, u)."""
    n = spec.n
    isum = lambda x: axis_sum(x, mesh, "ind")
    vec = ve[..., None]
    eigval = torch.clamp_min((data.Kval * vec) / (data.Kval + vec / vbtmp[..., None]), 0.0)
    proj = isum((yadj + k_estR) @ data.K)           # K' (yadj + k), per chain
    zk = _draw(noise, lambda nz: nz.normal(STREAM_BSLMM_Z, (n,)))
    k_new = ((eigval / vec) * proj + torch.sqrt(eigval) * zk) @ data.K.T
    diff = k_estR - k_new
    Kg = isum(k_new @ data.K)
    quad = _dot(Kg, Kg / data.Kval)
    chi = _draw(noise, lambda nz: nz.chisq(STREAM_BSLMM_CHI, spec.dfvara + n))
    vbtmp = (quad + spec.s2vara * spec.dfvara) / chi
    return k_new, vbtmp, yadj + diff, u - diff


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


def _pre_sweep(spec: GibbsSpec, data: GibbsData, noise, state: ChainState,
               mesh=None) -> dict:
    """Intercept, sequential covariates, environmental random effects, the
    single-step epsilon term, and the sweep's constants and random numbers
    (hibayes_tpu/engine/gibbs.py:817-875, 900-1004), for one chain or a
    batch.  Every draw comes from ``noise``.  On an ind mesh every sum over
    individuals is summed over the axis."""
    dt = data.y.dtype
    dev = data.y.device
    n_obs = spec.n_obs
    r0, n = local_rows(spec, data, mesh)
    isum = lambda x: axis_sum(x, mesh, "ind")
    mu, beta, yadj, u = state.mu, state.beta, state.yadj, state.u
    ve = state.vare
    lead = tuple(mu.shape)   # () for one chain, (K,) for a batch
    cut = rows_cut(spec, data)
    padded = spec.row_padded or cut
    row_real = torch.arange(r0, r0 + n, device=dev) < n_obs if padded else None

    # --- intercept (src/Bayes.cpp:480-482) ---
    z = _draw(noise, lambda nz: nz.normal(STREAM_MU, ()))
    delta = isum(yadj.sum(-1)) / n_obs + torch.sqrt(ve / n_obs) * z
    mu = mu + delta
    # padded rows stay exactly zero (they feed sum(yadj) and yadj.yadj)
    yadj = yadj - (torch.where(row_real, delta[..., None], 0.0) if padded
                   else delta[..., None])

    # --- fixed covariates, sequential (src/Bayes.cpp:484-494) ---
    if spec.nc:
        z_cov = _draw(noise, lambda nz: nz.normal(STREAM_COV, (spec.nc,)))
        new_beta = []
        for i in range(spec.nc):
            ci, cpci, bi_old = data.C[:, i], data.cpc[i], beta[..., i]
            rhs = isum(_dot(ci, yadj)) + cpci * bi_old
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
        rhs = isum(_segment_sum(yadj, data.r_segs[i])) + counts * old
        lhs = counts + ve[..., None] / vrtmp[..., i, None]
        zr = _draw(noise, lambda nz: nz.normal(STREAM_FACTOR + 2 * i, (nlev,)))
        new = rhs / lhs + torch.sqrt(ve[..., None] / lhs) * zr
        upd = (old - new)[..., codes]
        yadj = yadj + (torch.where(row_real, upd, 0.0) if padded else upd)
        chi = _draw(noise, lambda nz: nz.chisq(STREAM_FACTOR + 2 * i + 1, nlev + spec.dfr))
        vrtmp[..., i] = (_dot(new, new) + spec.s2r * spec.dfr) / chi
        vr[..., i] = _var(new)
        estR.append(new)

    # --- BSLMM polygenic block draw in the GRM eigenbasis (src/Bayes.cpp:518-552) ---
    k_estR, vbtmp, va, vb = state.k_estR, state.vbtmp, state.va, state.vb
    if spec.use_bslmm:
        k_estR, vbtmp, yadj, u = _bslmm_draw(spec, data, noise, k_estR, vbtmp, yadj, u, ve,
                                             mesh)
        vb = vbtmp

    # --- single-step imputation-error term (src/Bayes.cpp:554-584) ---
    J_beta, epsl_estR, vepstmp, veps = (state.J_beta, state.epsl_estR,
                                        state.vepstmp, state.veps)
    if spec.qe:
        J_beta, epsl_estR, vepstmp, yadj, u = _epsilon_draw(
            spec, data, noise, J_beta, epsl_estR, vepstmp, yadj, u, ve, mesh)
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
        "k_estR": k_estR, "vbtmp": vbtmp, "va": va, "vb": vb,
        "J_beta": J_beta, "epsl_estR": epsl_estR, "vepstmp": vepstmp, "veps": veps,
        "consts": consts,
        "vei": ve[..., None].expand(lead + (m_pad,)),
        "vargL_in": (state.vargL if state.vargL.numel()
                     else torch.zeros(lead + (m_pad,), dtype=dt, device=dev)),
        "rnd": _sweep_noise(spec, noise, lead, dt, dev),
    }


# ---------------------------------------------------------------------------
# the sweep of one iteration, on one device or on a mesh
# ---------------------------------------------------------------------------


def snp_shard_count(nblocks: int, mesh) -> int:
    """Shards of the SNP-block axis a mesh provides (1 = not sharded)."""
    if mesh is None:
        return 1
    s = mesh.size("snp")
    return s if s > 1 and nblocks % s == 0 else 1


def ind_shard_count(mesh) -> int:
    """Shards of the individual axis a mesh provides (1 = not sharded)."""
    return 1 if mesh is None else mesh.size("ind")


def hybrid_draws_supported(spec: GibbsSpec, dt) -> bool:
    """Whether the draws kernel (``blockgibbs.block_draws``, TPU kernel 7)
    takes the blocks of the ind-sharded sweep on the card: float32 and no
    rejection guard (any block: it runs wider ones as sub-blocks).  The
    sweep calls ``block_draws`` whatever this says: on CPU tensors that is
    the plain version, and on the card it refuses what the kernel does not
    take, as the one-device sweep does."""
    return dt == torch.float32 and not spec.reject_guard


def _sweep_ind_hybrid_mc(spec: GibbsSpec, consts_b, X_blocks, W_blocks, xpx, vx, vei_b,
                         g_b, z_b, u_b, chi_b, z2_b, vargL_b, yadj_b, u_vec_b, *, mesh,
                         block_range=None):
    """K-chain sweep on an ind-sharded mesh (``_sweep_ind_hybrid_mc``,
    hibayes_tpu/engine/gibbs.py:1063-1136): ``blockgibbs.sweep_blocks``
    with, per kernel (sub-)block, this rank's r0 = X_b' yadj (a library
    product, as XLA's in the JAX package) summed over ``ind``, the B draws
    by ``block_draws`` (TPU kernel 7) replicated on every rank of the axis,
    and this rank's yadj += X_b dg.  ``block_range`` as in ``sweep_mc``.
    Returns sweep_mc's outputs."""
    logpi_row = consts_b["logpi"][:, :1].T.to(yadj_b.dtype)
    return blockgibbs.sweep_blocks(
        spec, consts_b, X_blocks, W_blocks, xpx, vx, vei_b, g_b, z_b, u_b, chi_b, z2_b,
        vargL_b, yadj_b, u_vec_b,
        lambda P, W, r: (None, *blockgibbs.block_draws(spec, logpi_row, P, W, r)),
        block_range, lambda r: axis_sum(r, mesh, "ind"))


def _sweep_local_blocks(spec, consts_b, X, W, xpx, vx, per_chain, yadj, u, mesh,
                        block_range=None, C=None):
    """Sweep the SNP blocks this rank holds (or ``block_range`` of them) for
    K chains against (yadj, u): the unit of the turn, pipeline and
    concurrent schedules (``_sweep_local_blocks``,
    hibayes_tpu/engine/gibbs.py:1139).
    ``per_chain`` = (vei, g, z, u, chi, z2, vargL), each (K, m_loc[, nf]).
    ``sweep_mc`` (TPU kernels 1-5, 8 at K = 1, with the cross-Grams ``C``;
    kernel 2 at K >= 2), or the ind hybrid on a 2-D mesh."""
    if ind_shard_count(mesh) > 1:
        return _sweep_ind_hybrid_mc(spec, consts_b, X, W, xpx, vx, *per_chain, yadj, u,
                                    mesh=mesh, block_range=block_range)
    return blockgibbs.sweep_mc(spec, consts_b, X, W, xpx, vx, *per_chain, yadj, u,
                               block_range=block_range, C_blocks=C)


def _rows_of(consts_b, rsel):
    return {k: v[rsel] for k, v in consts_b.items()}


def _sweep_pipeline_emu_mc(spec: GibbsSpec, consts_b, X_blocks, W_blocks, xpx, vx, vei_b,
                           g_b, z_b, u_b, chi_b, z2_b, vargL_b, yadj_b, u_vec_b, C_blocks=None):
    """One-device emulation of the ring-pipeline schedule
    (``_sweep_pipeline_emu_mc``, hibayes_tpu/engine/gibbs.py:1347-1431):
    chain group c (batch rows [c Kg, (c + 1) Kg)) sweeps the S =
    ``spec.emulate_shards`` shards' block ranges in the order c, c + 1, ...,
    c + S - 1 with its residual carried on, per chain exactly the
    distributed ring.  Each range is ``sweep_mc(..., block_range=(b0,
    nbg))`` on the whole genotype, which the sweep's capability flag
    ``block_range_in_place`` says it takes without a copy of X (where the
    JAX engine tests the kernel function's identity).  Group 0 runs the
    blocks in their order: its draws and residuals are the one-device
    sweep's."""
    nb = spec.nblocks
    K = yadj_b.shape[0]
    S = spec.emulate_shards
    if K % S:
        raise ValueError(f"pipeline emulation needs nchains ({K}) to be a multiple of "
                         f"emulate_shards ({S})")
    if nb % S:
        raise ValueError(f"emulate_shards ({S}) must divide the {nb} SNP blocks "
                         "(prepare_gibbs_data(nblocks_multiple=...))")
    dt = yadj_b.dtype
    Kg, nbg = K // S, nb // S
    mg = nbg * spec.block
    sweep = blockgibbs.sweep_mc
    if not getattr(sweep, "block_range_in_place", False):
        raise TypeError("the pipeline emulation needs a sweep that takes block_range in place")
    outs = []
    for c in range(S):
        rsel = slice(c * Kg, (c + 1) * Kg)
        consts_c = _rows_of(consts_b, rsel)
        ya, uu = yadj_b[rsel], u_vec_b[rsel]
        vi = torch.zeros((Kg,), dtype=dt, device=ya.device)
        vR = torch.zeros((Kg,), dtype=dt, device=ya.device)
        pieces = [None] * S
        for t in range(S):
            sblk = (c + t) % S
            sl = slice(sblk * mg, (sblk + 1) * mg)
            per = tuple(a[rsel, sl] for a in (vei_b, g_b, z_b, u_b, chi_b, z2_b, vargL_b))
            gn, tr, vl, ya, uu, vi_s, vR_s = sweep(
                spec, consts_c, X_blocks, W_blocks, xpx[sl], vx[sl], *per, ya, uu,
                block_range=(sblk * nbg, nbg), C_blocks=C_blocks)
            vi = vi + vi_s.to(dt)
            vR = vR + vR_s.to(dt)
            pieces[sblk] = (gn.to(dt), tr.to(torch.int32), vl.to(dt))
        outs.append(tuple(torch.cat([p[i] for p in pieces], dim=1) for i in range(3))
                    + (ya, uu, vi, vR))
    return tuple(torch.cat([o[i] for o in outs], dim=0) for i in range(7))


def _sweep_concurrent_emu_mc(spec: GibbsSpec, consts_b, X_blocks, W_blocks, xpx, vx,
                             vei_b, g_b, z_b, u_b, chi_b, z2_b, vargL_b, yadj_b, u_vec_b,
                             C_blocks=None):
    """One-device emulation of the concurrent schedule
    (``_sweep_concurrent_emu_mc``, hibayes_tpu/engine/gibbs.py:1255-1332)
    with S = ``spec.emulate_shards`` virtual shards and Rm =
    ``spec.merge_rounds`` merge rounds: the Markov kernel of the mesh run
    (:func:`_sweep_snp_sharded_mc`), its shards swept one after another.
    Group (s, r) owns blocks [(s Rm + r) nbg, + nbg) (shard-major, as the
    mesh splits the blocks).  In round r the groups (0, r) .. (S - 1, r)
    each sweep from the round-start (yadj, u) by ``sweep_mc(...,
    block_range=)`` on the whole genotype (no copy of X), and their deltas
    are summed in group order and added: ya + (0 + d_0 + ... + d_{S-1}),
    the JAX package's association (at S = 2 the mesh's a + (d_0 + d_1)
    bit for bit).  The group sweeps run in order on one stream."""
    nb = spec.nblocks
    S, Rm = spec.emulate_shards, spec.merge_rounds
    if nb % (S * Rm):
        raise ValueError(f"emulate_shards*merge_rounds ({S}x{Rm}) must divide the {nb} SNP "
                         "blocks (prepare_gibbs_data(nblocks_multiple=...))")
    dt = yadj_b.dtype
    K = yadj_b.shape[0]
    nbg = nb // (S * Rm)
    mg = nbg * spec.block
    ya, uu = yadj_b, u_vec_b.to(dt)
    vi = torch.zeros((K,), dtype=dt, device=ya.device)
    vR = torch.zeros((K,), dtype=dt, device=ya.device)
    groups = [None] * (S * Rm)
    for r in range(Rm):
        dya, du = torch.zeros_like(ya), torch.zeros_like(uu)
        for s in range(S):
            gi = s * Rm + r
            sl = slice(gi * mg, (gi + 1) * mg)
            per = tuple(a[:, sl] for a in (vei_b, g_b, z_b, u_b, chi_b, z2_b, vargL_b))
            gn, tr, vl, ya2, u2, vi_s, vR_s = blockgibbs.sweep_mc(
                spec, consts_b, X_blocks, W_blocks, xpx[sl], vx[sl], *per, ya, uu,
                block_range=(gi * nbg, nbg), C_blocks=C_blocks)
            dya = dya + (ya2 - ya)
            du = du + (u2 - uu)
            vi = vi + vi_s.to(dt)
            vR = vR + vR_s.to(dt)
            groups[gi] = (gn.to(dt), tr.to(torch.int32), vl.to(dt))
        ya = ya + dya
        uu = uu + du
    cat = lambda i: torch.cat([grp[i] for grp in groups], dim=1)
    return cat(0), cat(1), cat(2), ya, uu, vi, vR


def _sweep_snp_sharded_mc(spec: GibbsSpec, data: GibbsData, consts_b, rnd_b, vei_b, g_b,
                          vargL_b, yadj_b, u_vec_b, mesh):
    """The SNP-sharded sweep for K chains (``_sweep_snp_sharded_mc``,
    hibayes_tpu/engine/gibbs.py:1434-1671): the exact turn and ring-pipeline
    schedules and the relaxed concurrent one.  Rank s of the ``snp`` axis
    holds SNP blocks [s nb/S, (s + 1) nb/S) of X and W (``shard_gibbs_data``).

    turn: in turn t the rank of snp index t sweeps its blocks for all K
    chains (:func:`_sweep_local_blocks`), the others wait; then (yadj, u)
    reach every rank of the axis by a broadcast from that rank.  The JAX
    package merges with ya + psum(ya2 - ya); the broadcast is one
    collective of the same size and hands every rank the owner's values bit
    for bit, so every rank's residual is the one-device sweep's.

    pipeline: chain group c (rows [c Kg, (c + 1) Kg), Kg = K / S) homes at
    rank c; in each of S turns every rank sweeps the group it holds over
    its own blocks, then the group's rows (yadj, u, the variance sums) take
    one hop of the ring to the next rank; after S hops each is home.  All
    ranks work every turn; a chain visits the shards in the order c, c +
    1, ... (group 0 in the blocks' own order).  It does not compose with an
    ind axis, and K must be a multiple of S (the JAX package's refusals).

    concurrent (relaxed, :class:`GibbsSpec`'s warning): in each of Rm =
    ``spec.merge_rounds`` rounds every rank sweeps its next nb/(S Rm) local
    blocks at once from the round-start (yadj, u) (a ``block_range`` of its
    X; on an ind axis the hybrid), and the ranks merge by ya + axis_sum(ya2
    - ya) (hibayes_tpu/engine/gibbs.py:1512-1549), the Markov kernel of
    :func:`_sweep_concurrent_emu_mc`; the variance sums add over the rounds,
    then over the axis.

    g, track and vargL of the shards are then gathered over the axis on
    every rank.  Returns sweep_mc's outputs for the K chains."""
    S = mesh.size("snp")
    s = mesh.index("snp")
    K = yadj_b.shape[0]
    dt = yadj_b.dtype
    m_loc = spec.m_pad // S
    sl = slice(s * m_loc, (s + 1) * m_loc)
    per = tuple(a[:, sl] for a in (vei_b, g_b) + tuple(rnd_b) + (vargL_b,))
    xpx, vx = data.xpx[sl], data.vx[sl]
    if spec.shard_schedule == "pipeline":
        if ind_shard_count(mesh) > 1:
            raise ValueError("shard_schedule='pipeline' does not compose with an "
                             "ind-sharded mesh; use a pure m-MP mesh (1, S)")
        if K % S:
            raise ValueError(f"shard_schedule='pipeline' needs nchains ({K}) to be a "
                             f"multiple of the {S} SNP shards (chains ring-rotate in "
                             f"groups of nchains/S)")
        Kg = K // S
        home = slice(s * Kg, (s + 1) * Kg)
        ya, uu = yadj_b[home], u_vec_b[home]
        vi = torch.zeros((Kg,), dtype=dt, device=ya.device)
        vR = torch.zeros((Kg,), dtype=dt, device=ya.device)
        g_cur = per[1].to(dt).clone()
        tr_cur = torch.zeros((K, m_loc), dtype=torch.int32, device=ya.device)
        vl_cur = per[6].to(dt).clone()
        for t in range(S):
            c = (s - t) % S   # the group this rank holds in turn t
            rsel = slice(c * Kg, (c + 1) * Kg)
            gn, tr, vl, ya, uu, vi_s, vR_s = blockgibbs.sweep_mc(
                spec, _rows_of(consts_b, rsel), data.X_blocks, data.W_blocks, xpx, vx,
                *(a[rsel] for a in per), ya, uu, C_blocks=data.C_blocks)
            g_cur[rsel], tr_cur[rsel], vl_cur[rsel] = gn.to(dt), tr, vl.to(dt)
            vi, vR = vi + vi_s.to(dt), vR + vR_s.to(dt)
            ya, uu, vi, vR = ring_hop((ya, uu, vi, vR), mesh, "snp")
        gat = lambda x, d: all_gather(x, mesh, "snp", dim=d)
        return (gat(g_cur, 1), gat(tr_cur, 1), gat(vl_cur, 1), gat(ya, 0), gat(uu, 0),
                gat(vi, 0), gat(vR, 0))
    if spec.shard_schedule == "concurrent":
        Rm = spec.merge_rounds
        nb_loc = spec.nblocks // S
        if nb_loc % Rm:
            raise ValueError(f"merge_rounds ({Rm}) must divide the {nb_loc} local SNP blocks "
                             "(prepare_gibbs_data(nblocks_multiple=...))")
        nbg = nb_loc // Rm
        mg = nbg * spec.block
        ya, uu = yadj_b, u_vec_b.to(dt)
        vi = torch.zeros((K,), dtype=dt, device=ya.device)
        vR = torch.zeros((K,), dtype=dt, device=ya.device)
        parts = []
        for r in range(Rm):
            rs = slice(r * mg, (r + 1) * mg)
            gn, tr, vl, ya2, u2, vi_s, vR_s = _sweep_local_blocks(
                spec, consts_b, data.X_blocks, data.W_blocks, xpx[rs], vx[rs],
                tuple(a[:, rs] for a in per), ya, uu, mesh, block_range=(r * nbg, nbg),
                C=data.C_blocks)
            ya = ya + axis_sum(ya2 - ya, mesh, "snp")
            uu = uu + axis_sum(u2 - uu, mesh, "snp")
            vi, vR = vi + vi_s.to(dt), vR + vR_s.to(dt)
            parts.append((gn.to(dt), tr, vl.to(dt)))
        gat = lambda i: all_gather(torch.cat([p[i] for p in parts], dim=1), mesh, "snp", dim=1)
        return (gat(0), gat(1), gat(2), ya, uu, axis_sum(vi, mesh, "snp"),
                axis_sum(vR, mesh, "snp"))
    ya, uu = yadj_b, u_vec_b.to(dt)
    for t in range(S):
        if t == s:
            gn, tr, vl, ya, uu, vi, vR = _sweep_local_blocks(
                spec, consts_b, data.X_blocks, data.W_blocks, xpx, vx, per, ya, uu, mesh,
                C=data.C_blocks)
        ya = broadcast(ya, mesh, "snp", t)
        uu = broadcast(uu, mesh, "snp", t)
    gat = lambda x: all_gather(x, mesh, "snp", dim=1)
    return (gat(gn.to(dt)), gat(tr), gat(vl.to(dt)), ya, uu,
            axis_sum(vi.to(dt), mesh, "snp"), axis_sum(vR.to(dt), mesh, "snp"))


def _sweep(spec: GibbsSpec, data: GibbsData, pre: dict, g, mesh=None):
    """The SNP sweep of a batch of K chains (``pre`` and ``g`` with a
    leading chain axis), by the mesh and the spec's schedule: the SNP-sharded
    turn, ring pipeline or concurrent rounds, the one-device pipeline or
    concurrent emulation (``emulate_shards``), the ind-sharded hybrid, or
    ``sweep_mc`` (also "concurrent" with neither shards nor emulation, as in
    the JAX package: the exact chain)."""
    args = (spec, pre["consts"], data.X_blocks, data.W_blocks, data.xpx, data.vx,
            pre["vei"], g, *pre["rnd"], pre["vargL_in"], pre["yadj"], pre["u"])
    if snp_shard_count(spec.nblocks, mesh) > 1:
        return _sweep_snp_sharded_mc(spec, data, pre["consts"], pre["rnd"], pre["vei"], g,
                                     pre["vargL_in"], pre["yadj"], pre["u"], mesh)
    if spec.shard_schedule == "pipeline" and spec.emulate_shards > 1:
        if ind_shard_count(mesh) > 1:
            raise ValueError("shard_schedule='pipeline' does not compose with an "
                             "ind-sharded mesh")
        return _sweep_pipeline_emu_mc(*args, C_blocks=data.C_blocks)
    if (spec.shard_schedule == "concurrent" and spec.emulate_shards > 1
            and ind_shard_count(mesh) <= 1):
        return _sweep_concurrent_emu_mc(*args, C_blocks=data.C_blocks)
    if ind_shard_count(mesh) > 1:
        return _sweep_ind_hybrid_mc(*args, mesh=mesh)
    return blockgibbs.sweep_mc(*args, C_blocks=data.C_blocks)


def _run_sweep_k1(spec: GibbsSpec, data: GibbsData, pre: dict, g, mesh=None):
    """Run the K-chain sweep as one chain (add and strip the K = 1 axis)."""
    if spec.shard_schedule == "pipeline" and spec.emulate_shards > 1 \
            and snp_shard_count(spec.nblocks, mesh) <= 1:
        raise ValueError(
            "shard_schedule='pipeline' needs a multi-chain batch (run_chains with "
            "nchains a multiple of the shard count); a single chain has no chain "
            "groups to rotate")
    one = lambda v: v.reshape((1,) + tuple(v.shape))
    pre_b = dict(pre, consts={k: one(v) for k, v in pre["consts"].items()},
                 vei=one(pre["vei"]), rnd=tuple(one(r) for r in pre["rnd"]),
                 vargL_in=one(pre["vargL_in"]), yadj=one(pre["yadj"]), u=one(pre["u"]))
    return tuple(o[0] for o in _sweep(spec, data, pre_b, one(g), mesh))


def _recompute_residuals(spec: GibbsSpec, data: GibbsData, mu, beta, estR, g,
                         J_beta=None, epsl_estR=None, k_estR=None, mesh=None):
    """Exact recompute of (yadj, u) from the current effects: the periodic
    f32 drift correction (hibayes_tpu/engine/gibbs.py:1674-1704), for one
    chain or a batch.  ``u`` carries the polygenic, J and epsilon terms
    too, as in the JAX engine.  On a mesh each rank forms its rows, X g
    over its SNP blocks summed over ``snp``."""
    dt = data.y.dtype
    n = spec.n
    r0, nr = local_rows(spec, data, mesh)
    dev = data.y.device
    pred = torch.zeros(tuple(mu.shape) + (nr,), dtype=dt, device=dev) + mu[..., None]
    if spec.nc:
        pred = pred + (data.C @ beta if beta.dim() == 1 else beta @ data.C.T)
    for i in range(len(spec.nlevels)):
        pred = pred + estR[i][..., data.r_codes[i]]
    gl = g
    b0, nbl = local_blocks(spec, data, mesh)
    if nbl != spec.nblocks:
        gl = g[..., b0 * data.block:(b0 + nbl) * data.block]
    if gl.dim() == 1:
        u_new = genotype_matmul(data.X_blocks, gl[:, None], dt, data.block)[:, 0]
    else:
        u_new = genotype_matmul(data.X_blocks, gl.T, dt, data.block).T
    if gl is not g:
        u_new = axis_sum(u_new.contiguous(), mesh, "snp")
    if spec.use_bslmm:
        u_new = u_new + k_estR
    if spec.qe:
        u_new = u_new + J_beta[..., None] * data.epsl_yJ
        t0, c0 = epsl_part(n, spec.ne, r0, nr)
        u_new[..., t0:] += epsl_estR[..., data.epsl_codes[c0:c0 + nr - t0]]
    yadj_new = data.y - (pred + u_new)
    if spec.row_padded:
        yadj_new = torch.where(torch.arange(r0, r0 + nr, device=dev) < spec.n_obs,
                               yadj_new, 0.0)
    return yadj_new, u_new


def _post_sweep(spec: GibbsSpec, data: GibbsData, noise, state: ChainState,
                pre: dict, sweep_out, mesh=None) -> ChainState:
    """Model-level updates, Vg/Ve draws, PIP/WPPA counters, drift resync,
    state assembly (hibayes_tpu/engine/gibbs.py:1707-1806), for one chain or
    a batch (``_post_sweep_batch``, :2442-2469): every chain shares the
    iteration counter, so the resync is one predicate for all of them.  On
    an ind mesh the sums over individuals are summed over the axis."""
    dt = data.y.dtype
    isum = lambda x: axis_sum(x, mesh, "ind")
    g, track, vargL_new, yadj, u, vargi_acc, vargR_acc = sweep_out
    vargL = vargL_new if state.vargL.numel() else state.vargL
    varg, pi, vara_fold, lambda2 = alphabet_global_updates(
        spec, noise, g, track, data.real, data.fold, vargi_acc, vargR_acc,
        vargL, state.varg, state.pi, state.vara_fold, state.lambda2,
    )
    va = varg if spec.model_index == 4 and spec.use_bslmm else pre["va"]

    # --- genetic + residual variances (src/Bayes.cpp:819-823) ---
    if spec.row_padded:
        su = isum(u.sum(-1))
        vara = (isum(_dot(u, u)) - su * su / spec.n_obs) / (spec.n_obs - 1)
    elif rows_cut(spec, data):
        c = u - (isum(u.sum(-1)) / spec.n)[..., None]
        vara = isum((c * c).sum(-1)) / (spec.n - 1)
    else:
        vara = _var(u)
    chi_e = _draw(noise, lambda nz: nz.chisq(STREAM_VE, spec.n_obs + spec.dfvare))
    vare = (isum(_dot(yadj, yadj)) + spec.s2vare * spec.dfvare) / chi_e

    nzrate, wppa = pip_counters(spec, data, state, track)

    mu, beta, estR = pre["mu"], pre["beta"], pre["estR"]
    # --- periodic drift resync (f32 only; exact recompute of yadj and u) ---
    if (spec.resync_every and dt == torch.float32
            and state.it % spec.resync_every == spec.resync_every - 1):
        with span("engine.resync"):
            yadj, u = _recompute_residuals(spec, data, mu, beta, estR, g, pre["J_beta"],
                                           pre["epsl_estR"], pre["k_estR"], mesh)

    return contiguous_state(ChainState(
        it=state.it + 1, mu=mu, beta=beta, estR=estR, vrtmp=pre["vrtmp"],
        vr=pre["vr"], yadj=yadj, u=u, g=g, varg=varg, vargL=vargL,
        lambda2=lambda2, pi=pi, vara_fold=vara_fold, vara=vara, vare=vare,
        track=track, nzrate=nzrate, wppa=wppa, k_estR=pre["k_estR"],
        vbtmp=pre["vbtmp"], va=va, vb=pre["vb"], J_beta=pre["J_beta"],
        epsl_estR=pre["epsl_estR"], vepstmp=pre["vepstmp"], veps=pre["veps"],
    ))


def contiguous_state(state):
    """The state (either engine's) with every tensor contiguous.  A batch's
    transposed products (the resync's, the factors' per-level sums) leave
    some fields strided, and torch may order a reduction by the layout; a
    state reloaded from a checkpoint is contiguous, so the chain keeps
    every state contiguous to resume bit for bit."""
    return state._replace(**{
        name: tuple(e.contiguous() for e in v) if isinstance(v, tuple) else v.contiguous()
        for name, v in state._asdict().items() if name != "it"})


def _check_ported(spec: GibbsSpec, mesh=None) -> None:
    """Raise for the configurations that belong to the summary engine."""
    if spec.reject_guard or spec.seg_sizes:
        raise NotImplementedError(
            "a summary-level spec (reject_guard or seg_sizes) runs on the summary "
            "engine, engine/sgibbs.py (run_s_chain / run_s_chains), not on the "
            "individual-level one")


def _on_mesh(spec: GibbsSpec, data: GibbsData, state, mesh):
    """``data`` and ``state`` as this rank's parts of the mesh (cut here
    where they are whole), and the mesh (None where it has one rank: the
    one-device chain)."""
    if mesh is None or mesh.world == 1:
        return data, state, None
    from ..parallel.mesh import shard_gibbs_data, shard_state

    state = None if state is None else shard_state(state, mesh, spec.n)
    return shard_gibbs_data(data, mesh, spec), state, mesh


def one_iteration(spec: GibbsSpec, data: GibbsData, seed: int,
                  state: ChainState, noise=None, mesh=None) -> ChainState:
    """One MCMC iteration of one chain: pre-sweep effects, the SNP sweep at
    K = 1, global updates.  ``noise`` defaults to the port's own streams
    for (seed, state.it).  On a mesh (parallel/mesh.py) ``data`` and
    ``state`` are this rank's parts (``shard_gibbs_data``,
    ``shard_state``; whole data is cut here) and every rank of the mesh
    calls it alike."""
    _check_ported(spec, mesh)
    with span("engine.iteration", it=state.it):
        data, state, mesh = _on_mesh(spec, data, state, mesh)
        if noise is None:
            noise = IterNoise(seed, state.it, data.y.device, data.y.dtype)
        with span("engine.pre_sweep"):
            pre = _pre_sweep(spec, data, noise, state, mesh)
        with span("engine.sweep"):
            sweep_out = _run_sweep_k1(spec, data, pre, state.g, mesh)
        with span("engine.post_sweep"):
            return _post_sweep(spec, data, noise, state, pre, sweep_out, mesh)


def one_iteration_batch(spec: GibbsSpec, data: GibbsData, seed: int,
                        states: ChainState, noise=None, mesh=None) -> ChainState:
    """One iteration of K chains (``one_iteration_batch``,
    hibayes_tpu/engine/gibbs.py:2382-2439): ``states`` holds a leading
    chain axis.  The pre- and post-sweep run as tensor ops over all chains;
    the sweep is ``blockgibbs.sweep_mc`` over the K chains, which share each
    genotype block (on a mesh, or with ``emulate_shards``, the schedule of
    :func:`_sweep`), and the single-step epsilon term's sweep one
    ``blockgibbs.mme_sweep`` over them.  ``noise`` defaults to each chain's
    own streams (:func:`chain_noise`); a test may pass any list of K."""
    K = int(states.mu.shape[0])
    _check_ported(spec, mesh)
    with span("engine.iteration", it=states.it):
        data, states, mesh = _on_mesh(spec, data, states, mesh)
        if noise is None:
            noise = chain_noise(seed, states.it, K, data.y.device, data.y.dtype)
        with span("engine.pre_sweep"):
            pre = _pre_sweep(spec, data, noise, states, mesh)
        with span("engine.sweep"):
            sweep_out = _sweep(spec, data, pre, states.g, mesh)
        with span("engine.post_sweep"):
            return _post_sweep(spec, data, noise, states, pre, sweep_out, mesh)


# ---------------------------------------------------------------------------
# running a chain or a batch of chains
# ---------------------------------------------------------------------------


def _print_progress(spec: GibbsSpec, state, eta_str: str) -> None:
    """One reference-style row of one chain, or of chain 0 of a batch (as
    the JAX engine's ``_print_progress``, hibayes_tpu/engine/gibbs.py:2290-2308);
    one host read, everything the row shows stacked on the device."""
    batched = state.vara.dim() > 0
    first = (lambda t: t[0]) if batched else (lambda t: t)
    dt = state.vara.dtype
    vals = torch.cat([(first(state.track) > 0).sum().to(dt).reshape(1),
                      first(state.vara).reshape(1), first(state.vare).reshape(1),
                      first(state.pi).to(dt)]).tolist()
    nnz = spec.m - spec.nvar0 if spec.model_index in (1, 2, 5) else int(vals[0])
    vara, vare, pi = vals[1], vals[2], vals[3:]
    pi_str = " ".join(f"{p:.4f}" for p in pi)
    tag = f"  [chain 1/{state.vara.shape[0]}]" if batched else ""
    print(f" {state.it:>6d}  {nnz:>6d}  {pi_str}  Vg {vara:.4f}  Ve {vare:.4f}  "
          f"h2 {vara / max(vara + vare, 1e-30):.4f}  {eta_str}{tag}")


def stack_state(state, nchains: int):
    """``nchains`` copies of one chain's state (either engine's) on a
    leading chain axis; ``it`` stays one int."""
    rep = lambda t: t.expand((nchains,) + tuple(t.shape)).clone()
    return state._replace(**{
        name: tuple(rep(e) for e in v) if isinstance(v, tuple) else rep(v)
        for name, v in state._asdict().items() if name != "it"})


def _concat_records(parts: list) -> dict:
    if not parts:
        return {}
    return {k: np.concatenate([p[k] for p in parts], axis=0) for k in parts[0]}


def run_loop(spec, state, step, snapshot, progress=False, chunk_records=0,
             checkpoint_path=None, carry=None, mesh=None):
    """Burn-in, thinning and records of one chain or a batch (either
    engine), in chunks as the JAX engine's ``_run_segmented``
    (hibayes_tpu/engine/gibbs.py:2216-2280): ``state = step(state)`` until
    ``spec.nburn`` in chunks of ``chunk_records * thin`` iterations, then
    ``chunk_records`` records a chunk, ``snapshot(state)`` kept every
    ``thin`` iterations (``chunk_records`` a tenth of the records by
    default).  After each chunk, with ``progress``, a reference-style row
    (iter / NnzSnp / pi / Vg / Ve / h2 / time left, src/Bayes.cpp:884-914);
    with ``checkpoint_path``, a checkpoint (engine/checkpoint.py) of the
    state, the tensors of ``carry`` (name -> tensor that ``step`` updates
    in place, such as the summary guard's tally) and the records so far.
    A checkpoint found there is resumed from its iteration, bit for bit
    the uninterrupted chain.  On a mesh (``state`` this rank's part of
    it) the file holds the whole state (the fields over individuals
    gathered), rank 0 writes it and every rank reads it and keeps its part;
    rank 0 alone prints.  Returns (state, samples, seconds): numpy samples
    with a leading records axis, and this call's wall time once the device
    has finished."""
    if chunk_records <= 0:
        chunk_records = max(spec.n_records // 10, 1)
    parts, pending = [], []
    n_done = 0
    held = lambda st: (st, carry) if carry else st
    whole, part, lead = lambda st: st, lambda st: st, True
    if mesh is not None:
        from ..parallel.mesh import gather_state, shard_state

        whole = lambda st: gather_state(st, mesh, spec.n)
        part = lambda st: shard_state(st, mesh, spec.n)
        lead = mesh.rank == 0
        progress = progress and lead
    if checkpoint_path:
        loaded = checkpoint.load_checkpoint(checkpoint_path, held(whole(state)))
        if loaded is not None:
            got, prev = loaded
            if carry:
                state, got_carry = got
                for k, t in carry.items():
                    t.copy_(got_carry[k])
            else:
                state = got
            state = part(state)
            if prev:
                parts.append(prev)
                n_done = len(next(iter(prev.values())))
            if progress:
                print(f"resumed from iteration {state.it} ({n_done} records collected)")

    def flush():
        # the device records of the chunks so far, to one numpy part
        if pending:
            with span("engine.flush"):
                parts.append({k: torch.stack([r[k] for r in pending]).cpu().numpy()
                              for k in pending[0]})
                pending.clear()

    t0, it0, total = time.time(), state.it, spec.niter_eff

    def chunk_done(state):
        if checkpoint_path:
            flush()
            with span("engine.checkpoint"):
                full = whole(state)
                if lead:
                    checkpoint.save_checkpoint(checkpoint_path, held(full),
                                               _concat_records(parts))
                if mesh is not None:
                    barrier(mesh)
        if progress:
            sec = int((time.time() - t0) / max(state.it - it0, 1) * (total - state.it))
            _print_progress(spec, state,
                            f"{sec // 3600:02d}h{sec % 3600 // 60:02d}m{sec % 60:02d}s")

    while state.it < spec.nburn:
        for _ in range(min(chunk_records * spec.thin, spec.nburn - state.it)):
            state = step(state)
        chunk_done(state)
    while n_done < spec.n_records:
        k = min(chunk_records, spec.n_records - n_done)
        for _ in range(k):
            for _ in range(spec.thin):
                state = step(state)
            with span("engine.record"):
                pending.append(snapshot(state))
        n_done += k
        chunk_done(state)
    if state.vare.is_cuda:
        torch.cuda.synchronize(state.vare.device)
    seconds = time.time() - t0
    flush()
    return state, _concat_records(parts), seconds


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
              seed=666666, progress=False, chunk_records=0, checkpoint_path=None,
              mesh=None):
    """Run the full chain; returns (final_state, samples dict, summaries dict).
    The summaries hold pip, wppa, nzct and the chain's wall ``seconds``, taken
    once the device has finished its iterations.

    Samples are numpy arrays with a leading axis of n_records; alpha is cut
    to the real m.  With ``progress``, a reference-style row is printed
    every ``chunk_records`` records; with ``checkpoint_path``, the chain is
    saved there as often and resumed from there (:func:`run_loop`).  On a
    mesh every rank calls it alike with the whole data (or its part): each
    runs its part of the chain and returns the whole final state and the
    same records."""
    _check_ported(spec, mesh)
    data, _, mesh = _on_mesh(spec, data, None, mesh)
    state, samples, seconds = run_loop(
        spec, init_state(spec, data, priors, pi_init, mesh),
        lambda st: one_iteration(spec, data, seed, st, mesh=mesh),
        lambda st: _snapshot(spec, st, mesh),
        progress, chunk_records, checkpoint_path, mesh=mesh)
    if mesh is not None:
        from ..parallel.mesh import gather_state

        state = gather_state(state, mesh, spec.n)
    if not bool(torch.isfinite(state.vare)):
        warnings.warn("chain diverged: residual variance is non-finite at the "
                      "final iteration" + concurrent_note(spec), UserWarning, stacklevel=2)
    pip, wppa, nzct = posterior_rates(spec, state)
    if samples:
        samples["alpha"] = samples["alpha"][:, : spec.m]
    extras = {"pip": pip[: spec.m].cpu().numpy(), "wppa": wppa.cpu().numpy(),
              "nzct": nzct, "seconds": seconds}
    return state, samples, extras


def concurrent_note(spec) -> str:
    """The divergence warning's suffix under the relaxed concurrent schedule
    (hibayes_tpu/engine/gibbs.py:2355-2358); empty for the others."""
    if spec.shard_schedule != "concurrent" or spec.seg_sizes:
        return ""
    return (" — the relaxed shard_schedule='concurrent' kernel is a known divergence "
            "source in the m > n regime; rerun with 'pipeline' or 'turn'")


def check_chain_options(nchains: int, mesh=None) -> None:
    """Raise for the options of a chain batch that no engine takes."""
    if nchains < 1:
        raise ValueError(f"nchains must be at least 1, got {nchains}")


def batch_results(spec, states, samples, extras_real, seconds):
    """The summaries of a chain batch: divergence warning, records per
    chain (nchains, n_records, ...), PIP and WPPA averaged over chains, the
    split R-hat of every sampled parameter.  ``extras_real`` (a numpy index
    of the real SNPs, or a slice) cuts the per-SNP arrays."""
    bad = ~torch.isfinite(states.vare)
    if bool(bad.any()):
        warnings.warn(f"{int(bad.sum())}/{bad.numel()} chains diverged (non-finite "
                      "residual variance at the final iteration)" + concurrent_note(spec),
                      UserWarning, stacklevel=3)
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
    ``seconds`` once the device has finished.  ``checkpoint_path`` saves
    and resumes the batch (its leading chain axis), ``progress`` prints
    chain 0's rows (:func:`run_loop`).  One chain runs :func:`run_chain`
    (chain 0's streams are the single chain's), with the chain axis
    added.  ``mesh`` as in :func:`run_chain`."""
    check_chain_options(nchains, mesh)
    if nchains == 1:
        state, samples, extras = run_chain(spec, data, priors, pi_init, seed=seed,
                                           progress=progress, chunk_records=chunk_records,
                                           checkpoint_path=checkpoint_path, mesh=mesh)
        samples = {k: v[None] for k, v in samples.items()}
        return (stack_state(state, 1), samples,
                {**extras, "rhat": rhat_diagnostics(samples)})
    _check_ported(spec, mesh)
    data, _, mesh = _on_mesh(spec, data, None, mesh)
    states, samples, seconds = run_loop(
        spec, stack_state(init_state(spec, data, priors, pi_init, mesh), nchains),
        lambda ss: one_iteration_batch(spec, data, seed, ss, mesh=mesh),
        lambda ss: _snapshot(spec, ss, mesh), progress, chunk_records, checkpoint_path,
        mesh=mesh)
    if mesh is not None:
        from ..parallel.mesh import gather_state

        states = gather_state(states, mesh, spec.n)
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
