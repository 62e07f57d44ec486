"""Linear solvers over an abstract matvec: conjugate gradient, Jacobi-
preconditioned CG (one right-hand side with an explicit or a probed
diagonal, or a batch), and the row-ordered sparse product they run on.

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


def estimate_diag(matvec, m, nprobes=16, gen=None, device="cpu", dtype=torch.float64):
    """Stochastic estimate of diag(A) from ``nprobes`` Rademacher probes v
    (Bekas et al.): E[v * A v] = diag(A), one matvec a probe.  ``gen``
    defaults to a generator seeded 0 on ``device``."""
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(0)
    probes = 2.0 * torch.randint(0, 2, (nprobes, m), generator=gen, device=device,
                                 dtype=dtype) - 1.0
    av = torch.stack([matvec(v) for v in probes])
    return (probes * av).mean(dim=0)


def pcg_with_diag(matvec, b, diag, x0=None, tol=1e-6, maxiter=None):
    """Jacobi-preconditioned CG (solver.cpp:3-42) with the operator's
    diagonal ``diag`` (None: no preconditioner; zeros taken as 1e-4).
    Iterates while the residual norm is > ``tol`` and fewer than
    ``maxiter`` (default len(b)) steps were taken.  Returns (x, iterations)."""
    m = b.shape[0]
    maxiter = m if maxiter is None else maxiter
    if diag is None:
        minv = torch.ones_like(b)
    else:
        minv = 1.0 / torch.where(diag == 0, torch.full_like(diag, 1e-4), diag).to(b.dtype)
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    r = b - matvec(x)
    z = minv * r
    p = z
    it = 0
    while float(torch.linalg.vector_norm(r)) > tol and it < maxiter:
        ap = matvec(p)
        a = torch.dot(r, z) / torch.dot(p, ap)
        x = x + a * p
        r1 = r - a * ap
        z1 = minv * r1
        p = z1 + (torch.dot(z1, r1) / torch.dot(z, r)) * p
        r, z = r1, z1
        it += 1
    return x, it


def pcg(matvec, b, x0=None, tol=1e-6, maxiter=None, nprobes=16):
    """Jacobi-preconditioned CG whose diagonal is :func:`estimate_diag`'s
    probe estimate (non-positive entries taken as 1); callers with an
    explicit diagonal use :func:`pcg_with_diag`.  Returns (x, iterations)."""
    diag = estimate_diag(matvec, b.shape[0], nprobes=nprobes, device=b.device, dtype=b.dtype)
    diag = torch.where(diag > 0, diag, torch.ones_like(diag))
    return pcg_with_diag(matvec, b, diag, x0=x0, tol=tol, maxiter=maxiter)


def segment_matmul(lengths, cols, vals, X, *, checked=True):
    """A @ X for a sparse A given row by row: ``cols``/``vals`` hold the
    entries of row 0, then row 1, ... (``lengths`` int64 counts per row, as
    :func:`~hibayes_tpu_torch.data.pedigree.coo_device` returns them).  Each
    row's products are summed in stored order by ``segment_reduce``, with no
    atomics, so the result does not vary from run to run.  X is (n, ...);
    memory O(nnz * X[0].numel()).  ``checked=False`` skips segment_reduce's
    check of ``lengths`` (two reads back to the host), for lengths checked
    once where they were made."""
    G = X.index_select(0, cols)
    G.mul_(vals.to(X.dtype).reshape((-1,) + (1,) * (X.dim() - 1)))
    return torch.segment_reduce(G, "sum", lengths=lengths, axis=0, unsafe=not checked)


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

