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
and ``valid`` are numpy arrays or tensors.  Building tiles from genotypes
(``build_tiled_ld``) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .ld import as_numpy


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
