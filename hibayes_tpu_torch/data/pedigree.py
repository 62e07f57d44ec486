"""Pedigree processing: ordering, Henderson's A-inverse, partitions, and the
matrix-free imputation operator.

PyTorch port of hibayes_tpu/data/pedigree.py (reference: src/rm.cpp:56-229).
The host half (``make_ped``, ``make_ainv``, ``solve_a_ng``,
``rcm_permutation``, ``read_pedigree``) is NumPy and SciPy, copied here so
that the port never imports the JAX package.  The device half
(``coo_device``, :class:`ImputationOperator`) runs on a torch device: the
batched PCG of the imputation solves in float64 there, and its sparse
products add each row's terms in a fixed order (no atomics), so two runs
give the same bits.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..math.solvers import pcg_batched, segment_matmul

NA_TOKENS = {"NA", "Na", ".", "-", "NaN", "NAN", "nan", "na", "N/A", "n/a", "<NA>"}


def make_ped(ids, sires, dams, verbose=False):
    """Order the pedigree parents-before-offspring and integer-code parents.

    Mirrors the reference's iterative ordering with its two fallback passes
    (src/rm.cpp:56-170): founders first, then rows whose both parents are
    known; if stuck, rows with one known parent; if still stuck, force the
    rest.  Returns (ordered_ids, sire_idx, dam_idx) with 1-based parent
    positions (0 = unknown).
    """
    ids = [str(x) for x in ids]
    sires = [str(x) for x in sires]
    dams = [str(x) for x in dams]

    ped_id, ped_s, ped_d = [], [], []
    for p, s, d in zip(ids, sires, dams):
        if p in NA_TOKENS:
            continue
        ped_id.append(p)
        ped_s.append("0" if s in NA_TOKENS else s)
        ped_d.append("0" if d in NA_TOKENS else d)
    if len(set(ped_id)) != len(ped_id):
        raise ValueError("repeated records are not allowed in the first column of pedigree file.")
    n = len(ped_id)
    id_set = set(ped_id)

    out_id, out_s, out_d = [], [], []
    known = {"0"}
    remaining = np.ones(n, dtype=bool)

    # founders + parents referenced but never recorded become founders
    for i in range(n):
        if ped_s[i] == "0" and ped_d[i] == "0":
            known.add(ped_id[i])
            out_id.append(ped_id[i])
            out_s.append("0")
            out_d.append("0")
            remaining[i] = False
        else:
            for parent in (ped_s[i], ped_d[i]):
                if parent != "0" and parent not in id_set and parent not in known:
                    known.add(parent)
                    out_id.append(parent)
                    out_s.append("0")
                    out_d.append("0")

    while remaining.any():
        progressed = False
        for i in range(n):
            if not remaining[i]:
                continue
            if ped_s[i] in known and ped_d[i] in known:
                known.add(ped_id[i])
                out_id.append(ped_id[i])
                out_s.append(ped_s[i])
                out_d.append(ped_d[i])
                remaining[i] = False
                progressed = True
        if not progressed:
            for i in range(n):
                if not remaining[i]:
                    continue
                if ped_s[i] in known or ped_d[i] in known:
                    known.add(ped_id[i])
                    out_id.append(ped_id[i])
                    out_s.append(ped_s[i])
                    out_d.append(ped_d[i])
                    remaining[i] = False
                    progressed = True
        if not progressed:
            for i in range(n):
                if remaining[i]:
                    known.add(ped_id[i])
                    out_id.append(ped_id[i])
                    out_s.append(ped_s[i])
                    out_d.append(ped_d[i])
                    remaining[i] = False

    if not out_id:
        raise ValueError("no individuals detected.")
    pos = {"0": 0}
    for j, x in enumerate(out_id):
        pos[x] = j + 1
    s_idx = np.array([pos.get(s, 0) for s in out_s], dtype=np.int64)
    d_idx = np.array([pos.get(d, 0) for d in out_d], dtype=np.int64)
    return np.array(out_id), s_idx, d_idx


def make_ainv(s_idx, d_idx, compat_hibayes=False):
    """Henderson's sparse A-inverse from an ordered pedigree.

    Both-parents rules: diag +2, parent links -1, parent-parent +0.5
    (src/rm.cpp:188-194).  One-parent rules use the correct 4/3, -2/3, +1/3
    coefficients by default; ``compat_hibayes=True`` replicates the
    reference's C++ INTEGER-division quirk where 4/3 -> 1 and 2/3, 1/3 -> 0
    (src/rm.cpp:195-203), for bit-parity studies.
    """
    n = len(s_idx)
    rows, cols, vals = [], [], []

    if compat_hibayes:
        c_diag, c_link, c_par = 1.0, 0.0, 0.0
    else:
        c_diag, c_link, c_par = 4.0 / 3.0, -2.0 / 3.0, 1.0 / 3.0

    def add(i, j, v):
        rows.append(i)
        cols.append(j)
        vals.append(v)
        if i != j:
            rows.append(j)
            cols.append(i)
            vals.append(v)

    for x in range(n):
        sx = s_idx[x] - 1
        dx = d_idx[x] - 1
        if s_idx[x] == 0 and d_idx[x] == 0:
            add(x, x, 1.0)
        elif s_idx[x] > 0 and d_idx[x] > 0:
            add(x, x, 2.0)
            add(x, sx, -1.0)
            add(x, dx, -1.0)
            add(sx, sx, 0.5)
            add(dx, dx, 0.5)
            add(sx, dx, 0.5)
        elif s_idx[x] > 0:
            add(x, x, c_diag)
            add(x, sx, c_link)
            add(sx, sx, c_par)
        else:
            add(x, x, c_diag)
            add(x, dx, c_link)
            add(dx, dx, c_par)

    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsc()
    return A


def solve_a_ng(Ai_nn, Ai_ng):
    """A.ng = solve(Ai.nn, -Ai.ng): the imputation operator mapping genotyped
    to non-genotyped individuals (reference: R/ssbayes.r:296-301).  Sparse LU
    on the host; the dense operator feeds device products.  Direct path for
    small pedigrees; at scale see :class:`ImputationOperator`."""
    from scipy.sparse.linalg import splu

    lu = splu(sp.csc_matrix(Ai_nn))
    rhs = -np.asarray(Ai_ng.todense() if sp.issparse(Ai_ng) else Ai_ng)
    return lu.solve(rhs)


def coo_device(A, device="cpu", dtype=torch.float64):
    """Sparse matrix -> (rows, cols, vals) tensors on ``device`` in row-major
    order (columns ascending within a row), with the per-row entry counts
    ``lengths``: the operands of :func:`~hibayes_tpu_torch.math.solvers.segment_matmul`,
    which sums each row's products in that order."""
    csr = sp.csr_matrix(A, copy=True)
    csr.sum_duplicates()
    csr.sort_indices()
    counts = np.diff(csr.indptr)
    rows = np.repeat(np.arange(csr.shape[0]), counts)
    as_t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
    return (as_t(rows, torch.int64), as_t(csr.indices, torch.int64),
            as_t(csr.data, dtype), as_t(counts, torch.int64))


class ImputationOperator:
    """Matrix-free A.ng = Ai_nn^{-1} (-Ai_ng): applies the imputation operator
    to column blocks with diagonally preconditioned batched CG on a torch
    device (the products are O(nnz) per column, summed row by row).

    Port of ``ImputationOperator`` (hibayes_tpu/data/pedigree.py:179-254).
    The JAX operator solves in float32 on the device, refines in float64 on
    the host and falls back to ``splu`` on a non-finite result; here the
    batched PCG runs in float64 on ``device`` to ``tol`` relative to each
    right-hand side's norm, and raises if it does not converge.
    """

    def __init__(self, Ai_nn, Ai_ng, tol=1e-8, maxiter=None, device="cpu"):
        self.device = torch.device(device)
        self.n_ng, self.n_g = Ai_ng.shape
        self.tol = tol
        self.maxiter = maxiter if maxiter is not None else 10 * self.n_ng
        _, self._nn_cols, self._nn_vals, self._nn_len = coo_device(Ai_nn, self.device)
        _, self._ng_cols, self._ng_vals, self._ng_len = coo_device(Ai_ng, self.device)
        self._diag = torch.as_tensor(sp.csr_matrix(Ai_nn).diagonal(),
                                     dtype=torch.float64, device=self.device)

    def _matvec_nn(self, X):
        return segment_matmul(self._nn_len, self._nn_cols, self._nn_vals, X)

    def apply(self, V) -> torch.Tensor:
        """A.ng @ V for V of shape (n_g, k) or (n_g,) (numpy or tensor): the
        batched PCG in float64 on the operator's device; never materialises
        A.ng.  Returns a float64 tensor there."""
        V = torch.as_tensor(V).to(device=self.device, dtype=torch.float64)
        squeeze = V.dim() == 1
        if squeeze:
            V = V[:, None]
        B = -segment_matmul(self._ng_len, self._ng_cols, self._ng_vals, V)
        X, it = pcg_batched(self._matvec_nn, B, diag=self._diag, tol=self.tol,
                            maxiter=self.maxiter)
        if it >= self.maxiter:
            bnorm = torch.clamp_min(torch.linalg.vector_norm(B, dim=0), 1e-30)
            rel = float((torch.linalg.vector_norm(B - self._matvec_nn(X), dim=0)
                         / bnorm).max())
            if not rel <= self.tol:
                raise RuntimeError(
                    f"imputation PCG did not converge: relative residual {rel:.3g} "
                    f"> {self.tol} after {it} iterations")
        return X[:, 0] if squeeze else X

    def impute(self, M, rows_needed=None, chunk_cols=2048, verbose=False,
               out=None) -> torch.Tensor:
        """Mn[rows_needed] = (A.ng @ M)[rows_needed], solved in column chunks
        of M so that the solver's memory is O(n_ng * chunk_cols)
        (R/ssbayes.r:305 at scale).  ``M`` (n_g, m) is a numpy array or a
        tensor on any device; each chunk is cast to float64 on the
        operator's device.  The result is written into ``out`` when given
        (a (len(rows_needed), m) tensor there, of any float type), else
        into a new float64 tensor."""
        m = M.shape[1]
        rows = (torch.arange(self.n_ng, device=self.device) if rows_needed is None
                else torch.as_tensor(np.asarray(rows_needed), dtype=torch.int64,
                                     device=self.device))
        if out is None:
            out = torch.empty((rows.numel(), m), dtype=torch.float64, device=self.device)
        for c0 in range(0, m, chunk_cols):
            c1 = min(m, c0 + chunk_cols)
            V = (M[:, c0:c1] if isinstance(M, torch.Tensor)
                 else torch.from_numpy(np.ascontiguousarray(M[:, c0:c1])))
            out[:, c0:c1] = self.apply(V).index_select(0, rows)
            if verbose:
                print(f"\rimputing genotypes: {100 * c1 // m}%", end="", flush=True)
        if verbose:
            print()
        return out


def rcm_permutation(A) -> np.ndarray:
    """Reverse-Cuthill-McKee ordering of a symmetric sparse matrix: clusters
    pedigree families so the A-inverse(nn) block packs densely into the
    diagonal blocks of the in-chain epsilon Gibbs."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    return np.asarray(reverse_cuthill_mckee(sp.csr_matrix(A), symmetric_mode=True))


def read_pedigree(path: str, header=True):
    """Read a 3-column (id, sire, dam) pedigree file."""
    with open(path) as f:
        lines = [line.split() for line in f if line.strip()]
    if header:
        lines = lines[1:]
    ids = np.array([l[0] for l in lines])
    sires = np.array([l[1] if len(l) > 1 else "0" for l in lines])
    dams = np.array([l[2] if len(l) > 2 else "0" for l in lines])
    return ids, sires, dams
