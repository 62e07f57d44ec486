"""Genome window construction for GWAS (WPPA).

Vectorised equivalents of the reference's window cutters
(reference: src/cutwind.cpp:14-65) plus the chromosome re-mapping and
window-info assembly the reference duplicates across its three front-ends
(R/bayes.r:213-263, R/sbayes.r:135-189, R/ssbayes.r:157-207).
Window ids are 1-based to match the reference contract.
"""

from __future__ import annotations

import numpy as np


def remap_chr(chrom: np.ndarray) -> np.ndarray:
    """Map non-numeric chromosomes (X, Y, MT, ...) to max(numeric)+i.

    (reference: R/bayes.r:237-245)
    """
    chrom = np.asarray(chrom).astype(str)
    num = np.full(chrom.shape, np.nan)
    for i, c in enumerate(chrom):
        try:
            num[i] = float(c)
        except ValueError:
            pass
    max_chr = np.nanmax(num) if np.isfinite(num).any() else 0.0
    out = num.copy()
    nonnum = ~np.isfinite(num)
    if nonnum.any():
        for j, c in enumerate(dict.fromkeys(chrom[nonnum])):  # stable unique order
            out[chrom == c] = max_chr + j + 1
    return out


def cutwind_by_bp(chrom: np.ndarray, pos: np.ndarray, bp: float) -> np.ndarray:
    """Fixed-bp bins from position 1 per chromosome, skipping empty bins.

    (reference: src/cutwind.cpp:14-35)
    """
    chrom = np.asarray(chrom, dtype=np.float64)
    pos = np.asarray(pos, dtype=np.float64)
    wind = np.zeros(chrom.shape, dtype=np.int64)
    count = 1
    for c in np.unique(chrom):
        idx = np.flatnonzero(chrom == c)
        # raw bin index relative to bp0=1: positions in [1+k*bp, 1+(k+1)*bp)
        raw = np.floor((pos[idx] - 1) / bp).astype(np.int64)
        # renumber non-empty bins in order, skipping empties
        uniq = np.unique(raw)
        remap = {u: count + i for i, u in enumerate(uniq)}
        wind[idx] = [remap[r] for r in raw]
        count += len(uniq)
    return wind


def cutwind_by_num(chrom: np.ndarray, pos: np.ndarray, fix_n: int) -> np.ndarray:
    """Fixed SNP count per window after position sort within chromosome.

    (reference: src/cutwind.cpp:38-65)
    """
    chrom = np.asarray(chrom, dtype=np.float64)
    pos = np.asarray(pos, dtype=np.float64)
    wind = np.zeros(chrom.shape, dtype=np.int64)
    count = 1
    for c in np.unique(chrom):
        idx = np.flatnonzero(chrom == c)
        order = idx[np.argsort(pos[idx], kind="stable")]
        nwin = max(1, int(np.ceil(len(order) / fix_n)))
        for w in range(nwin):
            wind[order[w * fix_n : (w + 1) * fix_n]] = count
            count += 1
    return wind


def build_windows(map_chr, map_pos, windsize=None, windnum=None):
    """Window index + info table, as assembled in the reference front-ends.

    Returns (windindx 1-based int array, windinfo dict of columns).
    """
    chrom_orig = np.asarray(map_chr).astype(str)
    chrom = remap_chr(chrom_orig)
    pos = np.asarray(map_pos, dtype=np.float64)
    if np.isnan(pos).any():
        raise ValueError("NAs are not allowed in physical position.")
    if (pos == 0).any():
        raise ValueError("0 is not allowed in physical position.")
    if windnum is not None:
        if len(pos) < windnum:
            raise ValueError("windnum is larger than the total number of markers.")
        windindx = cutwind_by_num(chrom, pos, int(windnum))
    else:
        if np.max(pos) < windsize:
            raise ValueError("Maximum physical position is smaller than windsize.")
        windindx = cutwind_by_bp(chrom, pos, float(windsize))
    nw = int(windindx.max())
    starts = np.zeros(nw)
    ends = np.zeros(nw)
    counts = np.zeros(nw, dtype=np.int64)
    wchr = np.empty(nw, dtype=object)
    for w in range(1, nw + 1):
        sel = windindx == w
        starts[w - 1] = pos[sel].min()
        ends[w - 1] = pos[sel].max()
        counts[w - 1] = sel.sum()
        wchr[w - 1] = chrom_orig[sel][0]
    windinfo = {
        "Wind": np.array([f"wind{w}" for w in range(1, nw + 1)]),
        "Chr": wchr,
        "N": counts,
        "Start": starts,
        "End": ends,
    }
    return windindx, windinfo
