"""The random numbers of one chain iteration, worked out from the seed.

A chain's numbers are part of its definition: iteration ``it`` of chain k of
seed s draws stream id q from a ``torch.Generator`` seeded by a splitmix64
hash of (s, k, it, q), each stream one call of the shape the chain asks for
(the stream registry of hibayes_tpu_torch/engine/rng.py:36-75, frozen here
as the yardstick's own copy).  The draws are float32, as the chain's; the
reference computes with them in its own precision.
"""

from __future__ import annotations

import torch

STREAM_MU = 0
STREAM_COV = 1
STREAM_SNP_Z = 2
STREAM_SNP_U = 3
STREAM_VARG = 6
STREAM_PI = 7
STREAM_VE = 8
STREAM_SNP_ZR = 15
STREAM_FACTOR = 20
STREAM_S_VARA = 31
N_RETRY = 8

_MASK64 = (1 << 64) - 1
_CHAIN_SALT = 0x6A09E667F3BCC909


def _mix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def stream_seed(seed: int, it: int, stream: int, chain: int = 0) -> int:
    h = _mix64(int(seed) & _MASK64)
    if chain:
        h = _mix64(h ^ _mix64(_CHAIN_SALT ^ (int(chain) & _MASK64)))
    h = _mix64(h ^ (int(it) & _MASK64))
    h = _mix64(h ^ (int(stream) & _MASK64))
    return h >> 1


class Noise:
    """Iteration ``it`` of chain ``chain``: float32 draws on ``device``."""

    def __init__(self, seed: int, it: int, chain: int, device):
        self.seed, self.it, self.chain = int(seed), int(it), int(chain)
        self.device = torch.device(device)

    def _gen(self, stream: int) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(stream_seed(self.seed, self.it, stream, self.chain))
        return gen

    def normal(self, stream: int, shape=()) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self._gen(stream), device=self.device,
                           dtype=torch.float32)

    def uniform(self, stream: int, shape=()) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self._gen(stream), device=self.device,
                          dtype=torch.float32)

    def gamma(self, stream: int, alpha, shape=None) -> torch.Tensor:
        """Gamma(alpha, 1) by torch's standard-gamma sampler, alpha float32."""
        a = (alpha.to(device=self.device, dtype=torch.float32)
             if isinstance(alpha, torch.Tensor)
             else torch.full((), float(alpha), dtype=torch.float32, device=self.device))
        if shape is not None:
            a = a.expand(tuple(shape)).contiguous()
        return torch._standard_gamma(a, generator=self._gen(stream))

    def chisq(self, stream: int, df) -> torch.Tensor:
        """Chi-square(df) as 2 Gamma(df / 2); ``df`` a number or a 0-d tensor
        (halved in float32, exact for the counts it holds)."""
        half = (df.to(torch.float32) / 2.0 if isinstance(df, torch.Tensor)
                else float(df) / 2.0)
        return 2.0 * self.gamma(stream, half)

    def dirichlet(self, stream: int, alpha: torch.Tensor) -> torch.Tensor:
        """Normalised gammas, in float64."""
        x = self.gamma(stream, alpha).double()
        return x / x.sum()
