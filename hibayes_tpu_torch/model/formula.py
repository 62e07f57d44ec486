"""lme4-style formula parsing: ``y ~ x1 + x2 + (1|f1) + (1|f1:f2)``.

Python equivalent of the reference's regex-based term extraction and design
matrix construction (reference: R/bayes.r:167-207).  Semantics replicated:

* random terms are ``(1|name)`` or ``(1|a:b:...)`` (interaction groups whose
  level labels are the ``:``-joined values, R/bayes.r:170-178);
* the fixed part is built with R ``model.matrix`` treatment-contrast rules —
  string/categorical columns expand to dummies dropping the first (sorted)
  level, numeric columns pass through — and the all-ones intercept column is
  dropped because the engine fits an explicit intercept (R/bayes.r:204-206);
* rows with NA in the response, any fixed covariate, or any random factor are
  masked out (R/bayes.r:199-202).

``data`` is a plain dict of column-name -> 1-D numpy array (object/str arrays
for factors, float arrays for covariates); the first column is the id column
by convention, as in the reference.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

_NA_STRINGS = {"NA", "NaN", "nan", "na", "", ".", "<NA>", "N/A", "n/a", "None"}


def _is_na(col: np.ndarray) -> np.ndarray:
    if col.dtype.kind in "fc":
        return np.isnan(col.astype(np.float64))
    if col.dtype.kind in "iu" or col.dtype.kind == "b":
        return np.zeros(col.shape, dtype=bool)
    return np.isin(col.astype(str), list(_NA_STRINGS))


def _as_numeric_or_none(col: np.ndarray):
    if col.dtype.kind in "fiub":
        return col.astype(np.float64)
    return None


@dataclass
class ParsedFormula:
    response: str
    fixed_terms: list  # list[str]
    random_terms: list  # list[str], each possibly "a:b"


def parse_formula(formula: str) -> ParsedFormula:
    if "~" not in formula:
        raise ValueError("not a standard formula (missing '~').")
    lhs, rhs = formula.split("~", 1)
    response = lhs.strip()
    if not response:
        raise ValueError("formula needs a response variable.")
    random_terms = re.findall(r"\(\s*1\s*\|\s*([\w.:]+)\s*\)", rhs)
    bad = re.findall(r"\(\s*([^|)]+)\s*\|\s*[^)]*\)", rhs)
    for b in bad:
        if b.strip() != "1":
            raise ValueError(
                f"Invalid random effects expression '({b}| ...)': "
                "only '(1 | x)' or '(1 | x1:x2:...:xn)' is supported."
            )
    fixed_rhs = re.sub(r"\(\s*1\s*\|\s*[\w.:]+\s*\)", "", rhs)
    fixed_terms = [t.strip() for t in fixed_rhs.split("+") if t.strip() not in ("", "1")]
    return ParsedFormula(response, fixed_terms, random_terms)


@dataclass
class ModelFrame:
    y: np.ndarray            # (n_eff,) float
    X: np.ndarray | None     # (n_eff, nc) fixed design, or None
    X_names: list
    R_codes: list            # per random factor: (n_eff,) int32 level codes
    R_levels: list           # per random factor: array of level labels
    R_names: list
    keep_mask: np.ndarray    # (n,) bool — rows kept (True) after NA masking


def build_model_frame(formula: str, data: dict) -> ModelFrame:
    pf = parse_formula(formula)
    cols = {k: np.asarray(v) for k, v in data.items()}
    if pf.response not in cols:
        raise KeyError(f"response '{pf.response}' not found in data.")
    n = len(cols[pf.response])

    # --- random factor label columns (":"-joined for interactions) ---
    r_labels = []
    for term in pf.random_terms:
        parts = term.split(":")
        for p in parts:
            if p not in cols:
                raise KeyError(f"random term column '{p}' not found in data.")
        if len(parts) == 1:
            lab = cols[parts[0]].astype(str)
            na = _is_na(cols[parts[0]])
        else:
            sub = [cols[p].astype(str) for p in parts]
            na = np.zeros(n, dtype=bool)
            for p in parts:
                na |= _is_na(cols[p])
            lab = np.array([":".join(vals) for vals in zip(*sub)])
        lab = lab.copy()
        lab[na] = "NA"
        r_labels.append((lab, na))

    # --- NA mask over response + fixed + random ---
    na_mask = _is_na(cols[pf.response])
    y_num = _as_numeric_or_none(cols[pf.response])
    if y_num is None:
        raise ValueError(f"'{pf.response}' is not a vector of digital values.")
    for t in pf.fixed_terms:
        base_cols = t.split(":")
        for p in base_cols:
            if p not in cols:
                raise KeyError(f"fixed term column '{p}' not found in data.")
            na_mask |= _is_na(cols[p])
    for _, na in r_labels:
        na_mask |= na
    keep = ~na_mask
    if not keep.any():
        raise ValueError("no effective data left.")

    # --- fixed design (treatment contrasts, drop intercept) ---
    blocks, names = [], []
    for t in pf.fixed_terms:
        parts = t.split(":")
        if len(parts) == 1:
            col = cols[t][keep]
            num = _as_numeric_or_none(col)
            if num is not None:
                blocks.append(num[:, None])
                names.append(t)
            else:
                levels = np.unique(col.astype(str))
                for lev in levels[1:]:  # drop first level (treatment contrast)
                    blocks.append((col.astype(str) == lev).astype(np.float64)[:, None])
                    names.append(f"{t}{lev}")
        else:
            # numeric:numeric or factor:numeric interactions — build the
            # product of the per-part design columns (R model.matrix ':' rule
            # restricted to the pairwise case, sufficient for the reference's
            # documented surface).
            sub_designs = []
            sub_names = []
            for p in parts:
                col = cols[p][keep]
                num = _as_numeric_or_none(col)
                if num is not None:
                    sub_designs.append([num])
                    sub_names.append([p])
                else:
                    levels = np.unique(col.astype(str))
                    sub_designs.append(
                        [(col.astype(str) == lev).astype(np.float64) for lev in levels[1:]]
                    )
                    sub_names.append([f"{p}{lev}" for lev in levels[1:]])
            acc = [(np.ones(int(keep.sum())), "")]
            for dsgn, nms in zip(sub_designs, sub_names):
                acc = [
                    (a * d, (an + ":" + nn).strip(":"))
                    for a, an in acc
                    for d, nn in zip(dsgn, nms)
                ]
            for d, nn in acc:
                blocks.append(d[:, None])
                names.append(nn)
    X = np.concatenate(blocks, axis=1) if blocks else None
    # drop any all-ones column (intercept handled by the engine, R/bayes.r:205)
    if X is not None:
        keep_cols = ~np.all(X == 1.0, axis=0)
        X = X[:, keep_cols]
        names = [nm for nm, k in zip(names, keep_cols) if k]
        if X.shape[1] == 0:
            X, names = None, []

    # --- random factor integer codes ---
    R_codes, R_levels = [], []
    for lab, _ in r_labels:
        lab_kept = lab[keep]
        levels, codes = np.unique(lab_kept, return_inverse=True)
        R_codes.append(codes.astype(np.int32))
        R_levels.append(levels)

    return ModelFrame(
        y=y_num[keep],
        X=X,
        X_names=names,
        R_codes=R_codes,
        R_levels=R_levels,
        R_names=list(pf.random_terms),
        keep_mask=keep,
    )
