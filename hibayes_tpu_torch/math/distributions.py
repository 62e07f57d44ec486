"""Distribution samplers the individual-level chain uses.

Counterparts of hibayes_tpu/math/distributions.py (reference:
src/stats.cpp:13-76).  ``gamma`` takes an explicit ``torch.Generator``; the
chain's chi-square and Dirichlet draws are built on it by
:class:`~hibayes_tpu_torch.engine.rng.IterNoise`.  ``inv_gaussian_from`` is a
deterministic transform of pre-drawn numbers.
"""

from __future__ import annotations

import torch


def gamma(gen: torch.Generator, alpha, shape=None, device="cpu",
          dtype=torch.float32) -> torch.Tensor:
    """Gamma(alpha, 1).  A scalar ``alpha`` is broadcast to ``shape``.
    (reference: src/stats.cpp:13-15)"""
    # a Python number is filled on the device: copying it there would make
    # the host wait for the device
    a = (alpha.to(dtype) if isinstance(alpha, torch.Tensor)
         else torch.full((), alpha, dtype=dtype, device=device))
    if shape is not None:
        a = a.expand(tuple(shape)).contiguous()
    return torch._standard_gamma(a, generator=gen)


def inv_gaussian_from(z, u, mu, lam):
    """Michael-Schucany-Haas inverse-Gaussian transform from a standard
    normal ``z`` and a uniform ``u``.  (reference: src/stats.cpp:55-67)"""
    y = z * z
    x = (mu + 0.5 * mu * mu * y / lam
         - 0.5 * (mu / lam) * torch.sqrt(4.0 * mu * lam * y + mu * mu * y * y))
    return torch.where(u <= mu / (mu + x), x, mu * mu / x)
