"""Distribution samplers.

Counterparts of hibayes_tpu/math/distributions.py (reference:
src/stats.cpp:3-76).  Two flavours, as there:

* samplers that draw from an explicit ``torch.Generator`` on ``device``
  (``normal``, ``gamma``, ``chisq`` ...), in ``dtype``; the chain's
  chi-square and Dirichlet draws are built on :func:`gamma` by
  :class:`~hibayes_tpu_torch.engine.rng.IterNoise`;
* deterministic transforms of pre-drawn numbers (``inv_gaussian_from``,
  ``scaled_inv_chisq_from``, ``laplace_from``), which follow the dtype of
  their inputs.

Each keyed sampler's distribution is the JAX package's; the numbers are
not (torch's Philox streams are not JAX's Threefry).
"""

from __future__ import annotations

import math

import torch


def _param(x, dtype, device):
    """A parameter as a tensor on ``device``: a Python number is filled there
    (copying it there would make the host wait for the device)."""
    return (x.to(device=device, dtype=dtype) if isinstance(x, torch.Tensor)
            else torch.full((), x, dtype=dtype, device=device))


def normal(gen: torch.Generator, mean=0.0, sd=1.0, shape=(), device="cpu",
           dtype=torch.float32) -> torch.Tensor:
    """mean + sd z.  (reference: src/stats.cpp:8-11)"""
    return mean + sd * torch.randn(tuple(shape), generator=gen, device=device, dtype=dtype)


def uniform(gen: torch.Generator, shape=(), device="cpu", dtype=torch.float32) -> torch.Tensor:
    """Uniform on [0, 1)."""
    return torch.rand(tuple(shape), generator=gen, device=device, dtype=dtype)


def gamma(gen: torch.Generator, alpha, shape=None, device="cpu",
          dtype=torch.float32, scale=1.0) -> torch.Tensor:
    """Gamma(alpha, scale), mean alpha scale.  A scalar ``alpha`` is
    broadcast to ``shape``.  (reference: src/stats.cpp:13-15)"""
    a = _param(alpha, dtype, device)
    if shape is not None:
        a = a.expand(tuple(shape)).contiguous()
    x = torch._standard_gamma(a, generator=gen)
    return x if isinstance(scale, (int, float)) and scale == 1.0 else x * scale


def inv_gamma(gen: torch.Generator, alpha, scale, shape=(), device="cpu",
              dtype=torch.float32) -> torch.Tensor:
    """1 / Gamma(alpha, 1 / scale)."""
    return 1.0 / gamma(gen, alpha, shape, device, dtype, scale=1.0 / scale)


def chisq(gen: torch.Generator, df, shape=(), device="cpu", dtype=torch.float32) -> torch.Tensor:
    """Chi-square(df) as 2 Gamma(df / 2).  (reference: src/stats.cpp:22-24)"""
    return 2.0 * gamma(gen, _param(df, dtype, device) / 2.0, shape, device, dtype)


def inv_chisq(gen: torch.Generator, df, scale, shape=(), device="cpu",
              dtype=torch.float32) -> torch.Tensor:
    """(df scale) / chisq(df).  (reference: src/stats.cpp:26-28)"""
    return (df * scale) / chisq(gen, df, shape, device, dtype)


def scaled_inv_chisq_from(quad, df_scale_prod, df_total, chi_draw):
    """The sampler of every variance update in the reference engines,
    (quadratic form + s2 df) / chisq(df_total), from a pre-drawn chi-square
    draw; ``df_total`` only sets that draw's distribution.  (reference:
    src/Bayes.cpp:603,823)"""
    del df_total
    return (quad + df_scale_prod) / chi_draw


def beta(gen: torch.Generator, a, b, shape=(), device="cpu", dtype=torch.float32) -> torch.Tensor:
    """Beta(a, b) as Ga / (Ga + Gb)."""
    x = gamma(gen, a, shape, device, dtype)
    return x / (x + gamma(gen, b, shape, device, dtype))


def student_t(gen: torch.Generator, df, shape=(), device="cpu",
              dtype=torch.float32) -> torch.Tensor:
    """Student's t(df) as z / sqrt(chisq(df) / df)."""
    z = normal(gen, shape=shape, device=device, dtype=dtype)
    return z / torch.sqrt(chisq(gen, df, shape, device, dtype) / df)


def cauchy(gen: torch.Generator, location=0.0, scale=1.0, shape=(), device="cpu",
           dtype=torch.float32) -> torch.Tensor:
    """location + scale tan(pi (u - 1/2))."""
    u = uniform(gen, shape, device, dtype)
    return location + scale * torch.tan(math.pi * (u - 0.5))


def exponential(gen: torch.Generator, scale=1.0, shape=(), device="cpu",
                dtype=torch.float32) -> torch.Tensor:
    """scale Exp(1), as -log(1 - u)."""
    return scale * -torch.log1p(-uniform(gen, shape, device, dtype))


def laplace_from(u, mean=0.0, scale=1.0):
    """The inverse-CDF Laplace transform of a uniform ``u``.  (reference:
    src/stats.cpp:46-53)"""
    return torch.where(u < 0.5, mean + scale * torch.log(2.0 * u),
                       mean - scale * torch.log(2.0 * (1.0 - u)))


def laplace(gen: torch.Generator, mean=0.0, scale=1.0, shape=(), device="cpu",
            dtype=torch.float32) -> torch.Tensor:
    """Laplace(mean, scale) by :func:`laplace_from`."""
    return laplace_from(uniform(gen, shape, device, dtype), mean, scale)


def inv_gaussian_from(z, u, mu, lam):
    """Michael-Schucany-Haas inverse-Gaussian transform from a standard
    normal ``z`` and a uniform ``u``.  (reference: src/stats.cpp:55-67)"""
    y = z * z
    x = (mu + 0.5 * mu * mu * y / lam
         - 0.5 * (mu / lam) * torch.sqrt(4.0 * mu * lam * y + mu * mu * y * y))
    return torch.where(u <= mu / (mu + x), x, mu * mu / x)


def inv_gaussian(gen: torch.Generator, mu, lam, shape=(), device="cpu",
                 dtype=torch.float32) -> torch.Tensor:
    """Inverse-Gaussian(mu, lam) by :func:`inv_gaussian_from`."""
    z = normal(gen, shape=shape, device=device, dtype=dtype)
    return inv_gaussian_from(z, uniform(gen, shape, device, dtype), mu, lam)


def dirichlet(gen: torch.Generator, alpha, device="cpu", dtype=torch.float32) -> torch.Tensor:
    """Normalised gammas.  (reference: src/stats.cpp:69-76)"""
    x = gamma(gen, _param(alpha, dtype, device), None, device, dtype)
    return x / x.sum()
