"""LD (tXX) variance-covariance matrices: the three layouts `sbrm` takes,
and ``ldmat``, which builds them from genotypes on the card.

Counterparts of hibayes_tpu/data/ld.py (reference: src/tXXmat.cpp:101-840,
return types R/ldm.r:86-111):

* ``DenseLD``     — m x m dense: SBayesD semantics in `sbrm`;
* ``SparseLD``    — chi-square-pruned, dense storage with explicit zeros and
                    the per-column nonzero counts (SBayesS's varediff);
* ``BlockDiagLD`` — per-chromosome dense blocks.

The covariance is one centred Gram matrix, (X'X - s s'/n)/n.  For int8
genotypes X'X is formed exactly in int32 by ``torch._int_mm`` (the int8
tensor-core product; entries at most 4n stay exact), a library product
outside any kernel of the port, as the JAX package leaves its int8
``dot_general`` to XLA; the centring and the chi-square mask are
elementwise float64 operations, so the values equal the JAX package's bit
for bit.  Values may be numpy arrays or torch tensors on any device
(``ldmat`` leaves them on the device it ran on), so that a matrix made on
the card is not copied through the host.  ``diag`` and ``nnz_per_col`` are
numpy float64 / int64; ``matvec`` takes and returns numpy.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


def as_numpy(x) -> np.ndarray:
    """A numpy array or a torch tensor (any device) as a numpy array."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _diag(values) -> np.ndarray:
    """The diagonal of a numpy or torch (any device) matrix, numpy float64."""
    d = (torch.diagonal(values) if isinstance(values, torch.Tensor)
         else np.diag(values))
    return as_numpy(d).astype(np.float64)


def dense_matvec(values, v) -> np.ndarray:
    """values @ v in float64 for numpy or torch ``values``; numpy out."""
    if isinstance(values, torch.Tensor):
        vt = torch.as_tensor(np.asarray(v, np.float64), device=values.device)
        return (values.to(torch.float64) @ vt).cpu().numpy()
    return values @ v


@dataclass
class DenseLD:
    values: np.ndarray  # (m, m) numpy array or torch tensor

    @property
    def m(self):
        return self.values.shape[0]

    @property
    def diag(self):
        return _diag(self.values)

    def nnz_per_col(self):
        return np.full(self.m, self.m, dtype=np.int64)

    def matvec(self, v):
        return dense_matvec(self.values, v)


@dataclass
class SparseLD:
    """Chi-square-pruned LD.  Dense storage with explicit zeros plus the
    sparsity pattern; triggers SBayesS semantics in `sbrm`."""

    values: np.ndarray       # (m, m) with zeros outside the pattern, numpy or torch
    nnz_col: np.ndarray      # (m,) nonzeros per column (for varediff)

    @property
    def m(self):
        return self.values.shape[0]

    @property
    def diag(self):
        return _diag(self.values)

    def nnz_per_col(self):
        return self.nnz_col

    def matvec(self, v):
        return dense_matvec(self.values, v)

    @classmethod
    def from_scipy(cls, mat):
        import scipy.sparse as sp

        csc = sp.csc_matrix(mat)
        nnz = np.diff(csc.indptr).astype(np.int64)
        return cls(values=np.asarray(csc.todense()), nnz_col=nnz)


@dataclass
class BlockDiagLD:
    """Per-chromosome dense blocks.  SNPs must be grouped contiguously by
    chromosome."""

    blocks: list                    # list of (m_c, m_c) numpy arrays or torch tensors
    sizes: list = field(default_factory=list)
    nnz_col: np.ndarray | None = None  # set when chi-square-pruned

    @property
    def m(self):
        return int(sum(self.sizes))

    @property
    def diag(self):
        return np.concatenate([_diag(b) for b in self.blocks])

    def nnz_per_col(self):
        if self.nnz_col is not None:
            return self.nnz_col
        return np.concatenate(
            [np.full(s, s, dtype=np.int64) for s in self.sizes]
        )

    def matvec(self, v):
        out = np.empty_like(v)
        off = 0
        for b, s in zip(self.blocks, self.sizes):
            out[off : off + s] = dense_matvec(b, v[off : off + s])
            off += s
        return out


# ---------------------------------------------------------------------------
# ldmat: LD construction (hibayes_tpu/data/ld.py:33-310)
# ---------------------------------------------------------------------------


def _geno_tensor(geno, device) -> torch.Tensor:
    """A genotype (GenoMatrix, numpy array or memmap, or torch tensor) as a
    tensor on ``device``, in its own dtype (int8 stays int8)."""
    X = geno if isinstance(geno, torch.Tensor) else getattr(geno, "values", geno)
    if not isinstance(X, torch.Tensor):
        X = torch.from_numpy(np.ascontiguousarray(X))
    return X.to(device)


def _is_int8(X) -> bool:
    return X.dtype in (torch.int8, torch.uint8)


def _int_mm(A: torch.Tensor, Bt: torch.Tensor) -> torch.Tensor:
    """A B for int8 A (p, k) and Bt = B^T (q, k), both row-major: the exact
    int32 product by ``torch._int_mm`` (cuBLAS int8 -> int32 on the card).
    The shapes the library takes are reached by zero padding, which changes
    no sum: k to a multiple of 8, p and q to a multiple of 8 above 16."""
    p, k = A.shape
    q = Bt.shape[0]
    up = lambda x: max(24, -(-x // 8) * 8)
    kp = -(-k // 8) * 8

    def pad(M, rows):
        if M.shape == (rows, kp):
            return M.contiguous()
        out = torch.zeros((rows, kp), dtype=torch.int8, device=M.device)
        out[: M.shape[0], :k] = M
        return out

    same = A.data_ptr() == Bt.data_ptr() and A.shape == Bt.shape
    Ap = pad(A, up(p))
    Bp = Ap if same else pad(Bt, up(q))
    return torch._int_mm(Ap, Bp.t())[:p, :q]


def _quot(a: torch.Tensor, n) -> torch.Tensor:
    """a / n, the IEEE quotient on every device.  PyTorch's CUDA division by
    a Python scalar multiplies by its reciprocal (one rounding more), so n
    goes in as a 0-d tensor on a's device."""
    return a / torch.full((), n, dtype=a.dtype, device=a.device)


def int_gram(Xi: torch.Tensor, Xj: torch.Tensor | None = None):
    """Exact Xi'Xj of int8 genotypes (n, p) and (n, q) (Xj = Xi when None)
    and their column sums, all int64 on the genotypes' device; the port of
    ``_int_gram`` / ``_int_cross_gram`` (hibayes_tpu/data/ld.py:44-53,
    data/sparse_ld.py:39-47).  The product is ``torch._int_mm`` of the
    transposed genotypes."""
    Ti = Xi.t().contiguous()
    Tj = Ti if Xj is None else Xj.t().contiguous()
    S = _int_mm(Ti, Tj).to(torch.int64)
    si = Xi.sum(0, dtype=torch.int64)
    sj = si if Xj is None else Xj.sum(0, dtype=torch.int64)
    return S, si, sj


def _cov_gram(X: torch.Tensor) -> torch.Tensor:
    """(Xc' Xc) / n in float32 with Xc column-centred: the JAX package's
    float path (``_cov_gram``, float32 at HIGHEST precision), as float64."""
    X = X.to(torch.float32)
    Xc = X - X.mean(0, keepdim=True)
    return (Xc.t() @ Xc / X.shape[0]).to(torch.float64)


def _cov_dense(X: torch.Tensor) -> torch.Tensor:
    """Dense covariance block, float64 on X's device (``_cov_dense_np``,
    hibayes_tpu/data/ld.py:56-68): int8 genotypes through the exact
    integer Gram, the centring (S - s s'/n)/n in float64."""
    nn = X.shape[0]
    if _is_int8(X):
        S, s, _ = int_gram(X)
        s = s.to(torch.float64)
        return _quot(S.to(torch.float64) - _quot(torch.outer(s, s), nn), nn)
    return _cov_gram(X)


def _chisq_mask(G: torch.Tensor, n: int, chisq: float):
    """Zero entries with r^2 n <= chisq, keep the diagonal (``_chisq_mask``,
    hibayes_tpu/data/ld.py:71-78), in G's dtype.  Returns (masked G, keep)."""
    d = torch.sqrt(torch.clamp_min(torch.diagonal(G), 1e-30))
    r = G / torch.outer(d, d)
    keep = (r * r * n) > chisq
    keep |= torch.eye(G.shape[0], dtype=torch.bool, device=G.device)
    return torch.where(keep, G, torch.zeros((), dtype=G.dtype, device=G.device)), keep


def _map_col(map_, name: str, col: int) -> np.ndarray:
    return np.asarray(map_[name] if isinstance(map_, dict) else map_[:, col]).astype(str)


def ldmat(
    geno,
    map=None,
    gwas_geno=None,
    gwas_map=None,
    chisq=None,
    ldchr=False,
    dtype=torch.float32,
    threads=0,
    tiled=False,
    tile=64,
    stripe=4096,
    progress=False,
    device=None,
):
    """LD matrix construction (reference API: R/ldm.r:31-112; the JAX
    package's ``ldmat``, hibayes_tpu/data/ld.py:181-310), on ``device``
    (default "cuda"; without a card only device="cpu" runs).

    geno: (n, m) genotype (GenoMatrix, array or tensor).  chisq=None ->
    DenseLD; chisq > 0 -> SparseLD (entries with r^2 n <= chisq zeroed, the
    diagonal kept); ldchr=False with a map of several chromosomes ->
    BlockDiagLD, one block a chromosome (SNPs grouped by chromosome);
    gwas_geno/gwas_map overlay the GWAS panel's own LD for the SNPs in both
    panels (tXXmat_*_gwas, tXXmat.cpp:314-502).  tiled=True -> a
    TiledSparseLD built by streaming column stripes (``build_tiled_ld``;
    needs chisq and/or a per-chromosome map), in ``dtype``.  The values are
    float64 tensors on ``device`` (tiled: the tile store).  ``threads`` is
    accepted for the reference's signature and unused."""
    from ..model.ibrm import resolve_device

    device = resolve_device(device)
    X = _geno_tensor(geno, device)
    n, m = X.shape
    if chisq is not None and chisq < 0:
        chisq = None
    if tiled:
        from .sparse_ld import build_tiled_ld

        chrom_arg = _map_col(map, "Chr", 1) if map is not None and not ldchr else None
        gwas_X = gwas_pos = None
        if gwas_geno is not None:
            if map is None or gwas_map is None:
                raise ValueError("map information for both panels should be provided.")
            ref_ids, gw_ids = _map_col(map, "SNP", 0), _map_col(gwas_map, "SNP", 0)
            shared = np.isin(gw_ids, ref_ids)
            if shared.sum() == 0:
                raise ValueError("No shared SNPs between 'geno' and 'gwas.geno'.")
            gwas_X = _geno_tensor(gwas_geno, device)[:, torch.from_numpy(
                np.flatnonzero(shared)).to(device)]
            ref_pos = {s: i for i, s in enumerate(ref_ids)}
            gwas_pos = np.array([ref_pos[s] for s in gw_ids[shared]])
        return build_tiled_ld(
            X, chisq=chisq, chrom=chrom_arg, tile=tile, stripe=stripe,
            dtype=np.float32 if dtype == torch.float32 else np.float64,
            progress=progress, gwas_geno=gwas_X, gwas_pos=gwas_pos, device=device,
        )
    if map is None:
        ldchr = True
    else:
        chroms = _map_col(map, "Chr", 1)
        if len(np.unique(chroms)) == 1:
            ldchr = True

    def index(idx):
        return torch.from_numpy(np.asarray(idx, dtype=np.int64)).to(device)

    def patch(G, pos, Xg):
        """G[pos, pos] = the GWAS panel's covariance (tXXmat.cpp:388-416)."""
        p = index(pos)
        G[p[:, None], p[None, :]] = _cov_dense(Xg)
        return G

    if ldchr:
        G = _cov_dense(X)
        if gwas_geno is not None:
            if map is None or gwas_map is None:
                raise ValueError("map information for both panels should be provided.")
            ref_ids, gw_ids = _map_col(map, "SNP", 0), _map_col(gwas_map, "SNP", 0)
            shared = np.isin(gw_ids, ref_ids)
            if shared.sum() == 0:
                raise ValueError("No shared SNPs between 'geno' and 'gwas.geno'.")
            Xg = _geno_tensor(gwas_geno, device)[:, index(np.flatnonzero(shared))]
            pos = [np.flatnonzero(ref_ids == s)[0] for s in gw_ids[shared]]
            G = patch(G, pos, Xg)
        if chisq is None:
            return DenseLD(values=G)
        Gm, keep = _chisq_mask(G, n, chisq)
        return SparseLD(values=Gm, nnz_col=as_numpy(keep.sum(0)).astype(np.int64))

    # per-chromosome blocks (tXXmat_Chr / tXXmat_Chr_gwas, tXXmat.cpp:504-840)
    if gwas_geno is not None:
        if gwas_map is None:
            raise ValueError("map information for gwas sample should be provided.")
        ref_ids, gw_ids = _map_col(map, "SNP", 0), _map_col(gwas_map, "SNP", 0)
        Xg_all = _geno_tensor(gwas_geno, device)
    blocks, sizes, nnzs, order = [], [], [], []
    for c in dict.fromkeys(chroms):  # stable unique order
        idx = np.flatnonzero(chroms == c)
        order.append(idx)
        Gc = _cov_dense(X[:, index(idx)])
        if gwas_geno is not None:
            chr_ids = ref_ids[idx]
            shared = np.isin(gw_ids, chr_ids)
            if shared.sum():
                pos = [np.flatnonzero(chr_ids == s)[0] for s in gw_ids[shared]]
                Gc = patch(Gc, pos, Xg_all[:, index(np.flatnonzero(shared))])
        if chisq is not None:
            Gc, keep = _chisq_mask(Gc, n, chisq)
            nnzs.append(as_numpy(keep.sum(0)).astype(np.int64))
        blocks.append(Gc)
        sizes.append(len(idx))
    order = np.concatenate(order)
    if not np.array_equal(order, np.arange(m)):
        raise ValueError(
            "SNPs must be ordered contiguously by chromosome for block LD; "
            "sort the genotype columns by the map first.")
    return BlockDiagLD(blocks=blocks, sizes=sizes,
                       nnz_col=np.concatenate(nnzs) if nnzs else None)
