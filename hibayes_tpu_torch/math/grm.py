"""Genomic relationship matrix (GRM) on the card.

Port of hibayes_tpu/math/grm.py (reference: src/rm.cpp:5-53): centre the
columns, G = Zc Zc', divide by mean(diag(G)); optionally its inverse or its
eigendecomposition (BSLMM).  On int8 genotypes Zc Zc' = MM' - v1' - 1v' +
(mu.mu) 11' with MM' the exact int32 product (``torch._int_mm``, as ldmat
takes it) and the rank-1 mean corrections in the output type, in the JAX
module's order; the product, ``eigh`` and ``inv`` are library calls, as
they are XLA's in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.ld import _int_mm

CHUNK_BYTES = 1 << 28   # genotype columns cast at once for the mean corrections
JACOBI_MAX_N = 512      # CUDA float32 eigh below this many rows is solved in float64


def make_grm(M, lambda_=0.0, inverse=False, eigen=False, dtype=None, device=None):
    """The GRM of an (n, m) genotype (numpy array or torch tensor) on
    ``device`` (the tensor's own, else the CPU).  ``dtype`` defaults to the
    JAX module's ``result_type(M, float32)``: float32 for integer codes.
    Returns G, or ``inv(G + lambda_ I)`` with ``inverse``, or the
    eigenvalues (ascending) and eigenvectors of G + lambda_ I with
    ``eigen``."""
    if device is None:
        device = M.device if isinstance(M, torch.Tensor) else "cpu"
    device = torch.device(device)
    Mt = M if isinstance(M, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(M))
    if dtype is None:
        dtype = torch.promote_types(Mt.dtype, torch.float32)
    n, m = Mt.shape
    if Mt.dtype == torch.int8:
        # |entry of MM'| <= 4m: exact in int32
        if not 4 * m < 2 ** 31:
            raise ValueError(f"m={m}: the int32 product MM' could overflow")
        Mi = Mt.to(device)
        S = _int_mm(Mi, Mi).to(dtype)
        step = max(1, CHUNK_BYTES // (max(n, 1) * torch.empty((), dtype=dtype).element_size()))
        mu = torch.empty((m,), dtype=dtype, device=device)
        for c0 in range(0, m, step):
            mu[c0:c0 + step] = Mi[:, c0:c0 + step].to(dtype).mean(dim=0)
        v = torch.zeros((n,), dtype=dtype, device=device)
        for c0 in range(0, m, step):
            v += Mi[:, c0:c0 + step].to(dtype) @ mu[c0:c0 + step]
        G = S - v[:, None] - v[None, :] + torch.dot(mu, mu)
    else:
        Mj = Mt.to(device=device, dtype=dtype)
        Zc = Mj - Mj.mean(dim=0, keepdim=True)
        G = Zc @ Zc.T
    G = G / torch.diagonal(G).mean()
    if inverse or eigen:
        if lambda_:
            G = G + lambda_ * torch.eye(n, dtype=G.dtype, device=device)
        if inverse:
            return torch.linalg.inv(G)
        if G.is_cuda and G.dtype == torch.float32 and n <= JACOBI_MAX_N:
            # PyTorch's CUDA eigh takes cuSOLVER's Jacobi solver (syevj) for
            # float32 matrices of 32 to 512 rows: 1.2e-4 of the largest
            # eigenvalue off at n = 333 on an H100, against 1.2e-6 on the
            # CPU and 7.7e-7 for its divide-and-conquer solver at n = 2,000
            # (scripts/eigh_accuracy.py).  So small float32 GRMs are solved
            # in float64 and rounded.
            vals, vecs = torch.linalg.eigh(G.double())
            return vals.to(G.dtype), vecs.to(G.dtype)
        vals, vecs = torch.linalg.eigh(G)
        return vals, vecs
    return G
