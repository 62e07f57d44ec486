"""Linear solvers over an abstract matvec: conjugate gradient and batched
Jacobi-preconditioned CG, and the row-ordered sparse product they run on.

Counterparts of hibayes_tpu/math/solvers.py (reference src/solver.cpp:3-117)
as torch loops with the same stopping rules.  A loop reads its stopping
test on the host once per iteration.
"""

from __future__ import annotations

import torch


def conj_grad(matvec, b, lam=None, x0=None, tol=1e-6, maxiter=None):
    """Plain CG with optional per-element ridge ``lam``: solves
    (A + diag(lam)) x = b.  Iterates while the residual norm is >= ``tol``
    and fewer than ``maxiter`` (default: len(b)) steps were taken.
    Returns (x, iterations, final residual norm)."""
    m = b.shape[0]
    maxiter = m if maxiter is None else maxiter
    x = torch.zeros_like(b) if x0 is None else x0.clone()

    def amul(v):
        out = matvec(v)
        return out if lam is None else out + v * lam

    r = b - amul(x)
    p = r
    r2 = torch.dot(r, r)
    err = float(torch.sqrt(r2))
    it = 0
    while err >= tol and it < maxiter:
        ap = amul(p)
        alpha = r2 / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        r2new = torch.dot(r, r)
        err = float(torch.sqrt(r2new))
        p = r + (r2new / r2) * p
        r2 = r2new
        it += 1
    return x, it, err


def segment_matmul(lengths, cols, vals, X):
    """A @ X for a sparse A given row by row: ``cols``/``vals`` hold the
    entries of row 0, then row 1, ... (``lengths`` int64 counts per row, as
    :func:`~hibayes_tpu_torch.data.pedigree.coo_device` returns them).  Each
    row's products are summed in stored order by ``segment_reduce``, with no
    atomics, so the result does not vary from run to run.  X is (n, ...);
    memory O(nnz * X[0].numel())."""
    G = X.index_select(0, cols)
    G.mul_(vals.to(X.dtype).reshape((-1,) + (1,) * (X.dim() - 1)))
    return torch.segment_reduce(G, "sum", lengths=lengths, axis=0)


def pcg_batched(matvec, B, diag=None, tol=1e-8, maxiter=None):
    """Jacobi-preconditioned CG over a batch of right-hand sides B (n, k),
    the block variant of the reference's PCGm (src/solver.cpp:44-52).
    ``matvec`` maps (n, k) -> (n, k) column-wise.  Per-column step sizes;
    stops when every column's residual norm is <= ``tol`` relative to its
    right-hand side's norm, or after ``maxiter`` (default n) steps.
    Returns (X, iterations): iterations == maxiter means it stopped there."""
    n, k = B.shape
    maxiter = n if maxiter is None else maxiter
    if diag is None:
        minv = torch.ones((n, 1), dtype=B.dtype, device=B.device)
    else:
        d = torch.where(diag == 0, torch.full_like(diag, 1e-4), diag)
        minv = (1.0 / d).reshape(n, 1).to(B.dtype)
    bnorm = torch.clamp_min(torch.linalg.vector_norm(B, dim=0), 1e-30)
    X = torch.zeros_like(B)
    R = B - matvec(X)
    Z = minv * R
    P = Z.clone()
    rz = (Z * R).sum(dim=0)
    it = 0
    while it < maxiter:
        err = torch.linalg.vector_norm(R, dim=0) / bnorm
        if not float(err.max()) > tol:
            break
        AP = matvec(P)
        a = rz / torch.clamp_min((P * AP).sum(dim=0), 1e-300)
        X.addcmul_(P, a)
        R.addcmul_(AP, a, value=-1.0)
        torch.mul(R, minv, out=Z)
        rz1 = (Z * R).sum(dim=0)
        beta = rz1 / torch.clamp_min(rz, 1e-300)
        P.mul_(beta).add_(Z)
        rz = rz1
        it += 1
    return X, it

