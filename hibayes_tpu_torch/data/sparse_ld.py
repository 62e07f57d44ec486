"""Tiled (block-sparse-row) LD storage with O(nnz) memory.

Counterpart of ``TiledSparseLD`` and ``_tiled_matvec`` of
hibayes_tpu/data/sparse_ld.py.  The pruned LD matrix is stored as fixed-size
T x T tiles (reference: the arma::sp_mat CSC of src/tXXmat.cpp:147-152):

* only tiles holding at least one surviving entry are stored;
* per block row, tiles sit in a padded (K_max) list with the DIAGONAL TILE
  FIRST — the sweep draws block i against n * tiles[i, 0];
* both triangles are stored, so block row i's update of r_hat touches
  exactly its own tiles: r_hat[block cols[i, k]] += n * tiles[i, k]^T dg.

Invalid slots point at their own row with ``valid == False``.

``tiles`` may be a numpy array or a torch tensor already on the card (a
2.3 GB store at m = 500,000 is then not copied through the host); ``col_idx``
and ``valid`` are numpy arrays or tensors.

``build_tiled_ld`` makes the store from genotypes by streaming column
stripes, never the m x m matrix (``build_tiled_ld``,
hibayes_tpu/data/sparse_ld.py:255-496): a float64 host path (and the one
that takes a GWAS overlay panel), and the device path for int8 genotypes
and a float32 store, where per stripe pair the exact integer Gram, the keep
mask, the per-tile reduction and the gather of the surviving tiles all run
on the device and the store is assembled there: only tile counts and
indices cross to the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .ld import _geno_tensor, _int_mm, _is_int8, _quot, as_numpy, int_gram


def _tensor(x, device=None, dtype=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t.to(device=device if device is not None else t.device,
                dtype=dtype if dtype is not None else t.dtype)


@dataclass
class TiledSparseLD:
    """Chi-square-pruned LD in block-sparse tiles (see module docstring)."""

    tile: int
    m: int                 # real SNPs (m_pad = col_idx.shape[0] * tile)
    col_idx: np.ndarray    # (nbr, K_max) int32, block-column of each tile
    valid: np.ndarray      # (nbr, K_max) bool
    tiles: np.ndarray      # (nbr, K_max, T, T), numpy or torch
    nnz_col: np.ndarray    # (m,) surviving entries per column

    @property
    def nbr(self) -> int:
        return self.col_idx.shape[0]

    @property
    def k_max(self) -> int:
        return self.col_idx.shape[1]

    @property
    def m_pad(self) -> int:
        return self.nbr * self.tile

    @property
    def diag(self) -> np.ndarray:
        if isinstance(self.tiles, torch.Tensor):
            d = torch.diagonal(self.tiles[:, 0], dim1=1, dim2=2).reshape(-1)
        else:
            d = np.einsum("itt->it", self.tiles[:, 0]).reshape(-1)
        return as_numpy(d)[: self.m].astype(np.float64)

    def nnz_per_col(self) -> np.ndarray:
        return self.nnz_col

    @property
    def n_tiles(self) -> int:
        return int(as_numpy(self.valid).sum())

    def matvec(self, v) -> np.ndarray:
        """LD @ v with O(nnz) work, in the tile storage dtype, on the tiles'
        device; numpy in and out."""
        tiles = _tensor(self.tiles)
        vpad = torch.zeros(self.m_pad, dtype=tiles.dtype, device=tiles.device)
        vpad[: self.m] = torch.as_tensor(np.asarray(v, np.float64), dtype=tiles.dtype,
                                         device=tiles.device)
        out = _tiled_matvec(tiles, _tensor(self.col_idx, tiles.device),
                            _tensor(self.valid, tiles.device), vpad)
        return out[: self.m].to(torch.float64).cpu().numpy()

    def to_dense(self) -> np.ndarray:
        """Materialise (tests / small m only)."""
        T = self.tile
        tiles, cols, valid = (as_numpy(x) for x in (self.tiles, self.col_idx, self.valid))
        G = np.zeros((self.m_pad, self.m_pad))
        for i in range(self.nbr):
            for k in range(self.k_max):
                if valid[i, k]:
                    j = int(cols[i, k])
                    G[i * T : (i + 1) * T, j * T : (j + 1) * T] = tiles[i, k]
        return G[: self.m, : self.m]

    @classmethod
    def from_dense(cls, G, tile=64, dtype=np.float64) -> "TiledSparseLD":
        """Pack an (already pruned) dense symmetric matrix into tiles."""
        G = np.asarray(G)
        m = G.shape[0]
        nbr = -(-m // tile)
        m_pad = nbr * tile
        Gp = np.zeros((m_pad, m_pad))
        Gp[:m, :m] = G
        nz = Gp.reshape(nbr, tile, nbr, tile).any(axis=(1, 3))
        nnz_col = (G != 0).sum(axis=0).astype(np.int64)
        return cls._assemble(Gp, nz, tile, m, nnz_col, dtype)

    @classmethod
    def _assemble(cls, Gp, nz, tile, m, nnz_col, dtype):
        nbr = nz.shape[0]
        np.fill_diagonal(nz, True)  # diagonal tile always stored
        k_max = int(nz.sum(axis=1).max())
        col_idx = np.tile(np.arange(nbr, dtype=np.int32)[:, None], (1, k_max))
        valid = np.zeros((nbr, k_max), dtype=bool)
        tiles = np.zeros((nbr, k_max, tile, tile), dtype=dtype)
        for i in range(nbr):
            js = np.flatnonzero(nz[i])
            js = np.concatenate([[i], js[js != i]])  # diagonal first
            col_idx[i, : len(js)] = js
            valid[i, : len(js)] = True
            for k, j in enumerate(js):
                tiles[i, k] = Gp[i * tile : (i + 1) * tile, j * tile : (j + 1) * tile]
        return cls(tile=tile, m=m, col_idx=col_idx, valid=valid, tiles=tiles,
                   nnz_col=nnz_col)

    @classmethod
    def from_scipy(cls, mat, tile=64, dtype=np.float64) -> "TiledSparseLD":
        import scipy.sparse as sp

        csr = sp.csr_matrix(mat)
        m = csr.shape[0]
        nbr = -(-m // tile)
        # tile-level pattern without densifying: block any-nonzero
        coo = csr.tocoo()
        nz = np.zeros((nbr, nbr), dtype=bool)
        nz[coo.row // tile, coo.col // tile] = True
        nnz_col = np.asarray((csr != 0).sum(axis=0)).ravel().astype(np.int64)
        np.fill_diagonal(nz, True)
        k_max = int(nz.sum(axis=1).max())
        col_idx = np.tile(np.arange(nbr, dtype=np.int32)[:, None], (1, k_max))
        valid = np.zeros((nbr, k_max), dtype=bool)
        tiles = np.zeros((nbr, k_max, tile, tile), dtype=dtype)
        for i in range(nbr):
            js = np.flatnonzero(nz[i])
            js = np.concatenate([[i], js[js != i]])
            col_idx[i, : len(js)] = js
            valid[i, : len(js)] = True
            rows = csr[i * tile : min((i + 1) * tile, m)]
            for k, j in enumerate(js):
                blk = rows[:, j * tile : min((j + 1) * tile, m)].toarray()
                tiles[i, k, : blk.shape[0], : blk.shape[1]] = blk
        return cls(tile=tile, m=m, col_idx=col_idx, valid=valid, tiles=tiles,
                   nnz_col=nnz_col)


def _tiled_matvec(tiles, col_idx, valid, v) -> torch.Tensor:
    """LD @ v over the stored tiles: tiles (nbr, K, T, T), col_idx/valid
    (nbr, K), v (nbr * T,), all tensors on one device."""
    nbr, k_max, T, _ = tiles.shape
    segs = v.reshape(nbr, T)[col_idx.long()]                 # (nbr, K, T)
    prods = torch.einsum("ikab,ikb->ika", tiles, segs)       # (nbr, K, T)
    return torch.where(valid.bool()[..., None], prods, 0.0).sum(dim=1).reshape(-1)


# ---------------------------------------------------------------------------
# build_tiled_ld: streaming construction (hibayes_tpu/data/sparse_ld.py:255-496)
# ---------------------------------------------------------------------------


def _cross_cov(Xi: torch.Tensor, Xj: torch.Tensor) -> np.ndarray:
    """cov(Xi, Xj) = (Xi'Xj - si sj'/n)/n as float64 numpy (``_cross_cov``,
    hibayes_tpu/data/sparse_ld.py:50-66): int8 genotypes through the exact
    integer Gram on their device, the centring on the host."""
    n = Xi.shape[0]
    if _is_int8(Xi) and _is_int8(Xj):
        S, si, sj = (as_numpy(t) for t in int_gram(Xi, Xj))
        return (S.astype(np.float64)
                - np.outer(si.astype(np.float64), sj.astype(np.float64)) / n) / n
    Xi, Xj = (as_numpy(t).astype(np.float64) for t in (Xi, Xj))
    return (Xi - Xi.mean(0)).T @ (Xj - Xj.mean(0)) / n


def build_tiled_ld(
    geno,
    chisq=None,
    chrom=None,
    tile: int = 64,
    stripe: int = 4096,
    dtype=np.float32,
    progress: bool = False,
    gwas_geno=None,
    gwas_pos=None,
    device=None,
) -> TiledSparseLD:
    """Stream genotype column stripes through the exact Gram and keep only
    the LD tiles with surviving entries, never materialising the m x m
    matrix (the JAX package's ``build_tiled_ld``; reference keep rule
    r^2 n > chisq, src/tXXmat.cpp:147-152, the diagonal always kept; with
    ``chrom`` entries across chromosomes are dropped; chisq=None with chrom
    gives the block diagonal by chromosome).  gwas_geno/gwas_pos overlay
    the GWAS panel's own LD for the SNPs in both panels (gwas_pos: the
    reference positions of its columns), under the same rule with its own n.

    ``device`` (default: the genotype's, or the CPU) runs the Gram.  An
    int8 genotype with a float32 store and no overlay takes the device path
    (:func:`_build_tiled_device`: tiles selected and assembled on the
    device, the store a tensor there); anything else the host path (float64
    numpy, the store in ``dtype``)."""
    if device is None:
        device = geno.device if isinstance(geno, torch.Tensor) else "cpu"
    X = _geno_tensor(geno, device)
    n, m = X.shape
    stripe = max(tile, (stripe // tile) * tile)
    nbr = -(-m // tile)
    if chisq is None and chrom is None:
        raise ValueError("build_tiled_ld needs chisq and/or chrom (else use dense ldmat)")
    chrom_id = None
    if chrom is not None:
        chrom = np.asarray(chrom).astype(str)
        if chrom.shape[0] != m:
            raise ValueError("chrom must have one entry per SNP")
        _, chrom_id = np.unique(chrom, return_inverse=True)

    if gwas_geno is None and np.dtype(dtype) == np.float32 and _is_int8(X):
        return _build_tiled_device(X, chisq, chrom_id, tile, stripe, progress)

    # pass 1: per-column sd for the r^2 threshold, on the host in float64
    var = np.empty(m)
    for c0 in range(0, m, stripe):
        c1 = min(m, c0 + stripe)
        var[c0:c1] = as_numpy(X[:, c0:c1]).astype(np.float64).var(axis=0)
    sd = np.sqrt(np.maximum(var, 1e-30))

    ov_idx = None
    if gwas_geno is not None:
        if gwas_pos is None:
            raise ValueError("gwas_pos (reference positions of the overlay "
                             "panel's SNPs) is required with gwas_geno")
        Xg = _geno_tensor(gwas_geno, device)
        gwas_pos = np.asarray(gwas_pos, dtype=np.int64)
        if gwas_pos.shape[0] != Xg.shape[1]:
            raise ValueError("gwas_pos must have one entry per overlay SNP")
        ng = Xg.shape[0]
        ov_idx = np.full(m, -1, dtype=np.int64)
        ov_idx[gwas_pos] = np.arange(len(gwas_pos))
        g_var = as_numpy(Xg).astype(np.float64).var(axis=0)
        g_sd = np.sqrt(np.maximum(g_var, 1e-30))

    row_tiles = [dict() for _ in range(nbr)]
    nnz_col = np.zeros(m, dtype=np.int64)
    nstripes = -(-m // stripe)
    total_pairs = nstripes * (nstripes + 1) // 2
    done = 0

    def keep_mask(G, i0, i1, j0, j1):
        r2n = (G / np.outer(sd[i0:i1], sd[j0:j1])) ** 2 * n
        keep = np.ones_like(G, dtype=bool) if chisq is None else (r2n > chisq)
        if chrom_id is not None:
            keep &= chrom_id[i0:i1, None] == chrom_id[None, j0:j1]
        if i0 == j0:
            ii = np.arange(i1 - i0)
            keep[ii, ii] = True  # diagonal always kept
        return keep

    def harvest(Gm, keep, i0, j0):
        """The masked stripe block's nonzero T x T tiles into the block rows'
        stores, each mirrored into the other row; in a diagonal stripe pair
        only the upper tile triangle (the lower is its transpose)."""
        si, sj = Gm.shape
        gi0, gj0 = i0 // tile, j0 // tile
        Pi = -(-si // tile) * tile
        Pj = -(-sj // tile) * tile
        if (Pi, Pj) != Gm.shape:
            Gp = np.zeros((Pi, Pj), dtype=np.float64)
            Kp = np.zeros((Pi, Pj), dtype=bool)
            Gp[:si, :sj] = Gm
            Kp[:si, :sj] = keep
        else:
            Gp, Kp = Gm, keep
        tb = Kp.reshape(Pi // tile, tile, Pj // tile, tile).any(axis=(1, 3))
        for bi, bj in zip(*np.nonzero(tb)):
            gi, gj = gi0 + bi, gj0 + bj
            if gj < gi:
                continue
            t = Gp[bi * tile : (bi + 1) * tile, bj * tile : (bj + 1) * tile]
            row_tiles[gi][gj] = t.copy()
            if gi != gj:
                row_tiles[gj][gi] = t.T.copy()

    for a in range(nstripes):
        i0, i1 = a * stripe, min(m, (a + 1) * stripe)
        Xi = X[:, i0:i1]
        for b in range(a, nstripes):
            j0, j1 = b * stripe, min(m, (b + 1) * stripe)
            G = _cross_cov(Xi, Xi if b == a else X[:, j0:j1])
            keep = keep_mask(G, i0, i1, j0, j1)
            if ov_idx is not None:
                # the overlay panel's own covariance where both SNPs are in
                # it, under the same rule (tXXmat.cpp:388-416)
                mi_loc = np.flatnonzero(ov_idx[i0:i1] >= 0)
                mj_loc = np.flatnonzero(ov_idx[j0:j1] >= 0)
                if mi_loc.size and mj_loc.size:
                    ci = ov_idx[i0:i1][mi_loc]
                    cj = ov_idx[j0:j1][mj_loc]
                    sel = lambda c: Xg[:, torch.from_numpy(c).to(Xg.device)]
                    Gg = _cross_cov(sel(ci), sel(cj))
                    if chisq is None:
                        keep_g = np.ones_like(Gg, dtype=bool)
                    else:
                        keep_g = (Gg / np.outer(g_sd[ci], g_sd[cj])) ** 2 * ng > chisq
                    if chrom_id is not None:
                        keep_g &= (chrom_id[i0 + mi_loc][:, None]
                                   == chrom_id[j0 + mj_loc][None, :])
                    keep_g |= (i0 + mi_loc)[:, None] == (j0 + mj_loc)[None, :]
                    G[np.ix_(mi_loc, mj_loc)] = Gg
                    keep[np.ix_(mi_loc, mj_loc)] = keep_g
            Gm = np.where(keep, G, 0.0)
            nnz_col[j0:j1] += keep.sum(axis=0)
            if b != a:
                nnz_col[i0:i1] += keep.sum(axis=1)
            harvest(Gm, keep, i0, j0)
            done += 1
            if progress:
                print(f"\rLD tiles: {100 * done // total_pairs}% "
                      f"({done}/{total_pairs} stripe pairs)", end="", flush=True)
    if progress:
        print()
    return _assemble_row_tiles(row_tiles, nbr, tile, m, nnz_col, dtype)


def _assemble_row_tiles(row_tiles, nbr, tile, m, nnz_col, dtype) -> TiledSparseLD:
    """The store from per-row dicts {block column: tile}: the diagonal tile
    first (zeros where none survived), then the others by column
    (``_assemble_row_tiles``, hibayes_tpu/data/sparse_ld.py:419-433)."""
    for i in range(nbr):
        row_tiles[i].setdefault(i, np.zeros((tile, tile)))
    k_max = max(len(d) for d in row_tiles)
    col_idx = np.tile(np.arange(nbr, dtype=np.int32)[:, None], (1, k_max))
    valid = np.zeros((nbr, k_max), dtype=bool)
    tiles = np.zeros((nbr, k_max, tile, tile), dtype=dtype)
    for i, d in enumerate(row_tiles):
        js = sorted(d.keys())
        js = [i] + [j for j in js if j != i]
        col_idx[i, : len(js)] = js
        valid[i, : len(js)] = True
        for k, j in enumerate(js):
            tiles[i, k] = d[j]
    return TiledSparseLD(tile=tile, m=m, col_idx=col_idx, valid=valid,
                         tiles=tiles, nnz_col=nnz_col)


def _device_tile_select(XT, sd, ch, i0: int, j0: int, n: int, SW: int, T: int, chisq):
    """One stripe pair on the device (``_device_tile_select``,
    hibayes_tpu/data/sparse_ld.py:69-110): the exact int8 cross-Gram of
    the transposed genotype's stripes, the float32 covariance, the
    per-entry keep mask (chisq, chromosome, the forced diagonal), the
    per-tile any-reduction and the gather of the surviving tiles.  Returns
    (flat tile indices (k,), tiles (k, T, T), keep counts per column and
    per row), all on the device."""
    dev = XT.device
    Ti, Tj = XT[i0:i0 + SW], XT[j0:j0 + SW]
    S = _int_mm(Ti, Tj)
    # S is exact in float32 (entries <= 4n < 2^24); the row sums are divided
    # by n before the outer product, as the JAX package does
    si = _quot(Ti.sum(1, dtype=torch.int32).to(torch.float32), n)
    sj = Tj.sum(1, dtype=torch.int32).to(torch.float32)
    G = _quot(S.to(torch.float32) - torch.outer(si, sj), n)
    r = G / torch.outer(sd[i0:i0 + SW], sd[j0:j0 + SW])
    keep = (torch.ones_like(G, dtype=torch.bool) if chisq is None
            else (r * r * n) > chisq)
    keep &= ch[i0:i0 + SW, None] == ch[None, j0:j0 + SW]
    ar = torch.arange(SW, device=dev)
    keep |= (i0 + ar)[:, None] == (j0 + ar)[None, :]
    nt = SW // T
    Gm = torch.where(keep, G, torch.zeros((), dtype=G.dtype, device=dev))
    tb = keep.reshape(nt, T, nt, T).any(dim=3).any(dim=1)
    idx = torch.nonzero(tb.reshape(-1)).reshape(-1)
    G4 = Gm.reshape(nt, T, nt, T).permute(0, 2, 1, 3).reshape(nt * nt, T, T)
    return idx, G4[idx], keep.sum(0), keep.sum(1)


def _build_tiled_device(X, chisq, chrom_id, tile, stripe, progress) -> TiledSparseLD:
    """The device path of :func:`build_tiled_ld` (int8 genotype, float32
    store; ``_build_tiled_device``, hibayes_tpu/data/sparse_ld.py:436-496):
    the genotype is transposed once on its device, per stripe pair the
    tiles are selected there (:func:`_device_tile_select`), and the store
    is assembled there by one gather of the surviving tiles (each mirrored
    tile transposed): only each pair's tile indices cross to the host."""
    dev = X.device
    n, m = X.shape
    SW = stripe
    ns = -(-m // SW)
    m_pad_s = ns * SW
    # rows padded with zeros to a multiple of 8 (the int8 product's depth)
    XT = torch.zeros((m_pad_s, -(-n // 8) * 8), dtype=torch.int8, device=dev)
    XT[:m, :n] = X.t()
    # per-column sd in float64 on the device (the JAX package: on the host)
    var = torch.empty(m, dtype=torch.float64, device=dev)
    for c0 in range(0, m, SW):
        var[c0:c0 + SW] = XT[c0:min(m, c0 + SW), :n].to(torch.float64).var(1, unbiased=False)
    sd = torch.ones(m_pad_s, dtype=torch.float32, device=dev)
    sd[:m] = torch.sqrt(torch.clamp_min(var, 1e-30)).clamp_min(1e-15).to(torch.float32)
    ch = torch.full((m_pad_s,), -1, dtype=torch.int32, device=dev)
    ch[:m] = (torch.from_numpy(chrom_id.astype(np.int32)).to(dev)
              if chrom_id is not None else 0)

    nbr = -(-m // tile)
    nt = SW // tile
    nnz = torch.zeros(m_pad_s, dtype=torch.int64, device=dev)
    sels, src_gi, src_gj, base = [], [], [], 0
    total, done = ns * (ns + 1) // 2, 0
    for a in range(ns):
        i0 = a * SW
        for b in range(a, ns):
            j0 = b * SW
            idx, sel, colc, rowc = _device_tile_select(XT, sd, ch, i0, j0, n, SW, tile, chisq)
            nnz[j0:j0 + SW] += colc
            if b != a:
                nnz[i0:i0 + SW] += rowc
            idx = idx.cpu().numpy()
            gi = i0 // tile + idx // nt
            gj = j0 // tile + idx % nt
            ok = (gi < nbr) & (gj < nbr) & ((b != a) | (gj >= gi))
            if ok.any():
                sels.append(sel[torch.from_numpy(np.flatnonzero(ok)).to(dev)])
                src_gi.append(gi[ok])
                src_gj.append(gj[ok])
            done += 1
            if progress:
                print(f"\rLD tiles: {100 * done // total}% "
                      f"({done}/{total} stripe pairs)", end="", flush=True)
    if progress:
        print()
    gi = np.concatenate(src_gi) if src_gi else np.zeros(0, np.int64)
    gj = np.concatenate(src_gj) if src_gj else np.zeros(0, np.int64)
    src = torch.cat(sels) if sels else torch.zeros((0, tile, tile), device=dev)
    # every stored tile: (row, column, source, transposed), the mirrors of
    # the off-diagonal ones transposed; a diagonal tile that did not survive
    # is stored as zeros (source -1)
    off = gi != gj
    rows = np.concatenate([gi, gj[off]])
    cols = np.concatenate([gj, gi[off]])
    srcs = np.concatenate([np.arange(gi.size), np.flatnonzero(off)])
    trans = np.concatenate([np.zeros(gi.size, bool), np.ones(int(off.sum()), bool)])
    has_diag = np.zeros(nbr, bool)
    has_diag[rows[rows == cols]] = True
    miss = np.flatnonzero(~has_diag)
    rows = np.concatenate([rows, miss])
    cols = np.concatenate([cols, miss])
    srcs = np.concatenate([srcs, np.full(miss.size, -1)])
    trans = np.concatenate([trans, np.zeros(miss.size, bool)])
    # slot of each tile in its row: the diagonal first, then by column
    order = np.lexsort((cols, rows != cols, rows))
    rows, cols, srcs, trans = rows[order], cols[order], srcs[order], trans[order]
    starts = np.searchsorted(rows, np.arange(nbr))
    slot = np.arange(rows.size) - starts[rows]
    k_max = int(slot.max()) + 1
    col_idx = np.tile(np.arange(nbr, dtype=np.int32)[:, None], (1, k_max))
    valid = np.zeros((nbr, k_max), dtype=bool)
    col_idx[rows, slot] = cols
    valid[rows, slot] = True
    tiles = torch.zeros((nbr * k_max, tile, tile), dtype=torch.float32, device=dev)
    for tr in (False, True):
        pick = (trans == tr) & (srcs >= 0)
        if pick.any():
            t = src[torch.from_numpy(srcs[pick]).to(dev)]
            tiles[torch.from_numpy(rows[pick] * k_max + slot[pick]).to(dev)] = (
                t.transpose(1, 2) if tr else t)
    return TiledSparseLD(tile=tile, m=m, col_idx=col_idx, valid=valid,
                         tiles=tiles.reshape(nbr, k_max, tile, tile),
                         nnz_col=nnz[:m].cpu().numpy())
