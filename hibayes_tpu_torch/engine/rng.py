"""Per-iteration random streams.

The JAX engine derives every draw of iteration ``it`` from
``fold_in(fold_in(PRNGKey(seed), it), STREAM_*)`` (hibayes_tpu/engine/gibbs.py:55-71),
so skipping an unused stream leaves the others unchanged and a resumed chain
is bit-identical.  The port keeps the same registry: each (seed, iteration,
stream id) triple is hashed into the seed of its own ``torch.Generator``.

A batch of chains (``run_chains``) gives chain k the streams of (seed, k,
iteration, stream id), the counterpart of ``jax.random.split(PRNGKey(seed),
nchains)`` (hibayes_tpu/engine/gibbs.py:2522-2523): a chain's numbers depend
on its index alone, not on how many chains run beside it.  Chain 0 hashes
as a single chain does.

All draws of one iteration go through an :class:`IterNoise`.  Its three
primitive methods (``normal``, ``uniform``, ``gamma``) take the stream id and
the same shape and parameters the JAX engine passes to ``jax.random``, so a
test can hand the port a subclass that returns JAX's numbers instead; the
chi-square and Dirichlet draws are built on ``gamma`` exactly as the JAX
engine builds them.
"""

from __future__ import annotations

import torch

from ..math.distributions import gamma
from ..utils.profiling import count

STREAM_MU = 0
STREAM_COV = 1
STREAM_SNP_Z = 2
STREAM_SNP_U = 3
STREAM_SNP_CHI = 4
STREAM_SNP_Z2 = 5
STREAM_VARG = 6
STREAM_PI = 7
STREAM_VE = 8
STREAM_BSLMM_Z = 9
STREAM_BSLMM_CHI = 10
STREAM_EPSL_J = 11
STREAM_EPSL_Z = 12
STREAM_EPSL_CHI = 13
STREAM_LAMBDA = 14
STREAM_SNP_ZR = 15  # summary engine: retry normals of the rejection guard
STREAM_FACTOR = 20  # factor i uses 20 + 2*i (normals) and 21 + 2*i (chisq)
STREAM_S_VARA = 31  # summary engine: the chi-square of the Vg draw

_MASK64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64 finaliser: a bijective avalanche of a 64-bit word."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


_CHAIN_SALT = 0x6A09E667F3BCC909   # keeps chain words apart from iteration words


def stream_seed(seed: int, it: int, stream: int, chain: int = 0) -> int:
    """63-bit generator seed for one (seed, chain, iteration, stream id);
    chain 0 is the single chain's (seed, iteration, stream id)."""
    h = _mix64(int(seed) & _MASK64)
    if chain:
        h = _mix64(h ^ _mix64(_CHAIN_SALT ^ (int(chain) & _MASK64)))
    h = _mix64(h ^ (int(it) & _MASK64))
    h = _mix64(h ^ (int(stream) & _MASK64))
    return h >> 1


def stream_generator(seed: int, it: int, stream: int, device,
                     chain: int = 0) -> torch.Generator:
    """The seeded generator of one stream; counted as ``rng.generators``
    (utils/profiling.py) while a profiler records."""
    count("rng.generators")
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(stream_seed(seed, it, stream, chain))
    return gen


class IterNoise:
    """The random numbers of one iteration of chain ``chain``, one generator
    per stream id."""

    def __init__(self, seed: int, it: int, device, dtype=torch.float32, chain: int = 0):
        self.seed = int(seed)
        self.it = int(it)
        self.device = torch.device(device)
        self.dtype = dtype
        self.chain = int(chain)

    def _gen(self, stream: int) -> torch.Generator:
        return stream_generator(self.seed, self.it, stream, self.device, self.chain)

    def normal(self, stream: int, shape=()) -> torch.Tensor:
        return torch.randn(shape, generator=self._gen(stream),
                           device=self.device, dtype=self.dtype)

    def uniform(self, stream: int, shape=()) -> torch.Tensor:
        return torch.rand(shape, generator=self._gen(stream),
                          device=self.device, dtype=self.dtype)

    def gamma(self, stream: int, alpha, shape=None) -> torch.Tensor:
        """Gamma(alpha, 1); ``shape`` broadcasts a scalar alpha, as in
        ``jax.random.gamma(key, alpha, shape)``."""
        return gamma(self._gen(stream), alpha, shape, self.device, self.dtype)

    def chisq(self, stream: int, df, shape=None) -> torch.Tensor:
        """Chi-square as 2 * Gamma(df/2), the JAX engine's form."""
        return 2.0 * self.gamma(stream, df / 2.0, shape)

    def dirichlet(self, stream: int, alpha) -> torch.Tensor:
        """Normalised gammas. (reference: src/stats.cpp:69-76)"""
        x = self.gamma(stream, alpha)
        return x / x.sum()
