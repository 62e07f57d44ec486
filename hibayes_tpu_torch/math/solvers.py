"""Conjugate gradient over an abstract matvec.

Counterpart of ``conj_grad`` (hibayes_tpu/math/solvers.py:17-57; reference
src/solver.cpp:54-117) as a torch loop with the same stopping rule.  The
other solvers of that module come with ssbrm.
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
