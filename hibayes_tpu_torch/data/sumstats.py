"""GWAS summary statistics ingestion (COJO .ma format).

A copy of hibayes_tpu/data/sumstats.py (numpy only), kept in the port so that
it imports nothing of the JAX package.  The reference consumes an 8-column
COJO table — SNP A1 A2 MAF BETA SE P NMISS — and selects columns (MAF, BETA,
SE, NMISS) for the samplers (reference: R/sbayes.r:209-210).
"""

from __future__ import annotations

import numpy as np

COJO_COLUMNS = ("SNP", "A1", "A2", "MAF", "BETA", "SE", "P", "NMISS")


def read_sumstat(path: str) -> dict:
    """Parse a whitespace-delimited COJO file with a header row."""
    with open(path) as f:
        header = f.readline().split()
        rows = [line.split() for line in f if line.strip()]
    out = {}
    for i, h in enumerate(header):
        col = np.array([r[i] if i < len(r) else "NA" for r in rows])
        if h in ("MAF", "BETA", "SE", "P", "NMISS"):
            num = np.full(len(col), np.nan)
            for k, v in enumerate(col):
                try:
                    num[k] = float(v)
                except ValueError:
                    pass
            out[h] = num
        else:
            out[h] = col
    return out


def sumstat_matrix(sumstat) -> np.ndarray:
    """Normalise input to the (m, 4) [MAF, BETA, SE, N] matrix the engines use."""
    if isinstance(sumstat, dict):
        cols = []
        for name in ("MAF", "BETA", "SE", "NMISS"):
            if name not in sumstat:
                raise KeyError(f"summary statistics missing column '{name}'")
            cols.append(np.asarray(sumstat[name], dtype=np.float64))
        return np.stack(cols, axis=1)
    arr = np.asarray(sumstat, dtype=np.float64)
    if arr.ndim != 2:
        raise ValueError("sumstat must be 2-D")
    if arr.shape[1] == 8:
        # full COJO table (columns 4,5,6,8 1-based; R/sbayes.r:209)
        return arr[:, [3, 4, 5, 7]]
    if arr.shape[1] == 4:
        return arr
    raise ValueError("sumstat must have 4 ([MAF,BETA,SE,N]) or 8 (COJO) columns")
