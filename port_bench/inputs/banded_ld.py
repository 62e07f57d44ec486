"""Summary statistics against a tiled LD band, made on the card from a seed.

Frozen copies of ``banded_ld`` and ``summary_stats`` of chip_smoke.py
(chip_smoke.py:1075-1107 and :1110-1120 at the commit that added this file):
the LD is a band of rho^|i-j| stored as tiles of T, block row i holding its
tiles j with |i - j| <= K // 2, the diagonal first, the other slots masked;
BETA = LD b_true with b_true 1% nonzero N(0, 0.05^2), SE = 1/sqrt(N).  The
tiles are returned as plain tensors: the entry wraps them in the program's
LD type.
"""

from __future__ import annotations

import numpy as np
import torch


def band_tiles(m: int, dev, T: int = 128, K: int = 9, rho: float = 0.9):
    """(tiles (nbr, K, T, T) float32, col_idx (nbr, K) int64, valid (nbr, K)
    bool) on ``dev``; invalid slots point at their own row, as the layout
    asks.  Built by gathering from the 2 K // 2 + 1 distinct tiles of the band."""
    nbr, half = -(-m // T), K // 2
    a = torch.arange(T, device=dev, dtype=torch.float64)
    motifs = [rho ** (a[:, None] - a[None, :] - d * T).abs() for d in range(half + 1)]
    lib = torch.stack([torch.zeros((T, T), dtype=torch.float64, device=dev)] + motifs
                      + [x.T for x in motifs[1:]]).float()
    i = torch.arange(nbr, device=dev)[:, None]
    offs = torch.tensor([0] + [s * o for o in range(1, half + 1) for s in (-1, 1)],
                        device=dev)
    j = i + offs[None, :]
    ok = (j >= 0) & (j < nbr)
    order = torch.sort((~ok).to(torch.int8), dim=1, stable=True).indices  # valid first
    j, ok = torch.gather(j, 1, order), torch.gather(ok, 1, order)
    d = j - i
    code = torch.where(ok, torch.where(d >= 0, 1 + d, 1 + half - d), 0)
    return lib[code], torch.where(ok, j, i), ok


def band_matvec(tiles, cols, valid, v):
    """LD @ v over the tile store, in the tiles' dtype: row i gets
    sum_k tiles[i, k] @ v[cols[i, k]] over its valid slots."""
    nbr, K, T, _ = tiles.shape
    vb = v.to(tiles.dtype).reshape(nbr, T)
    out = torch.zeros((nbr, T), dtype=tiles.dtype, device=tiles.device)
    for k in range(K):
        part = torch.bmm(tiles[:, k], vb[cols[:, k]].unsqueeze(-1)).squeeze(-1)
        out += torch.where(valid[:, k, None], part, 0.0)
    return out.reshape(-1)


def summary_stats(tiles, cols, valid, m: int, gen: torch.Generator, dev,
                  N: int = 50_000, causal_share: float = 0.01, sd: float = 0.05):
    """[MAF, BETA, SE, N] (m, 4) numpy with BETA = LD b_true."""
    m_pad = tiles.shape[0] * tiles.shape[2]
    b = torch.where(torch.rand(m_pad, generator=gen, device=dev) < causal_share,
                    sd * torch.randn(m_pad, generator=gen, device=dev), 0.0)
    b[m:] = 0.0
    beta = band_matvec(tiles, cols, valid, b)[:m].double().cpu().numpy()
    return np.column_stack([np.full(m, 0.3), beta, np.full(m, 1 / np.sqrt(N)),
                            np.full(m, float(N))])


def make(cfg: dict, gen: torch.Generator, dev) -> dict:
    """The summary statistics and LD band of configuration ``cfg``:
    {"tiles", "cols", "valid", "nnz_col", "ss"}.  ``nnz_col`` counts the
    band's entries of every column as the layout records them (K T)."""
    m, T, K = cfg["m"], cfg["tile"], cfg["band_tiles"]
    tiles, cols, valid = band_tiles(m, dev, T, K, cfg["rho"])
    ss = summary_stats(tiles, cols, valid, m, gen, dev, cfg["N"], cfg["causal_share"],
                       cfg["causal_sd"])
    return {"tiles": tiles, "cols": cols, "valid": valid,
            "nnz_col": np.full(m, K * T, np.int64), "ss": ss}
