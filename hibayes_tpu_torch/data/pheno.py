"""Phenotype / covariate table ingestion (a copy of hibayes_tpu/data/pheno.py).

Whitespace-delimited table with a header row; first column is the individual
id (the reference's `data` contract, R/bayes.r:8).  Columns are numeric when
fully parseable (NA tokens -> NaN), strings otherwise.
"""

from __future__ import annotations

import numpy as np

_NA = {"NA", "NaN", "nan", "na", ".", "", "N/A", "n/a", "<NA>"}


def read_pheno(path: str) -> dict:
    with open(path) as f:
        header = f.readline().split()
        rows = [line.split() for line in f if line.strip()]
    out = {}
    for i, h in enumerate(header):
        col = np.array([r[i] if i < len(r) else "NA" for r in rows])
        num = np.full(len(col), np.nan)
        ok = True
        for k, v in enumerate(col):
            if v in _NA:
                continue
            try:
                num[k] = float(v)
            except ValueError:
                ok = False
                break
        out[h] = num if ok else col
    return out
