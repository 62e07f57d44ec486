"""TPU kernels 1, 2 and 8 against the port's sweep (hibayes_tpu_torch/ops/
blockgibbs.py), in interpret mode on the CPU.

Kernels 1 (``sweep`` / ``_kernel``, the X block VMEM-resident) and 8
(``sweep_chunked`` / ``_kernel_chunked``, X streamed in chunks of 2,048 rows)
are the JAX engine's single-chain fallbacks when no transposed kernel fits
(hibayes_tpu/engine/gibbs.py:786-808).  The port has no such fallback: its
``sweep_mc`` streams X in row tiles for any n, and ``one_iteration`` always
sweeps through it at K = 1.  So both are held here to ``sweep_mc`` at K = 1.
Kernel 2 (``sweep_mc`` / ``_kernel_mc``) is the K-chain sweep in which the
chains share each genotype block; the port's is ``sweep_mc`` at K >= 2.
The port runs its plain version, which is what a wrapper does on the CPU;
tests/test_torch_cuda.py holds the CUDA kernels to it on the card.
"""

import functools

import numpy as np
import pytest
import torch

from hibayes_tpu.ops import blockgibbs as JB
from hibayes_tpu_torch.ops import blockgibbs as TB

from .torch_parity import (assert_kernel_bar, model_setup, port_spec, sweep_inputs,
                           with_sparse_effects)

torch.set_num_threads(2)


@functools.cache
def _setup(model, n, int8):
    return with_sparse_effects(model_setup(model, n=n, m=64, B=16, warm=0, int8=int8))


def _one_chain(jargs):
    """The JAX arguments of a K = 1 batch without the chain axis."""
    consts, X, W, xpx, vx, *per = jargs
    return ({k: v[0] for k, v in consts.items()}, X, W, xpx, vx, *(a[0] for a in per))


@pytest.mark.parametrize("kernel,n", [("sweep", 512), ("sweep_chunked", 2048)],
                         ids=["kernel1", "kernel8"])
@pytest.mark.parametrize("int8", [True, False], ids=["int8", "f32"])
@pytest.mark.parametrize("model", ["BayesCpi", "BayesR"])
def test_single_chain_kernels_match_port_k1(model, int8, kernel, n):
    """Kernels 1 and 8 against sweep_mc_plain at K = 1 on the same inputs,
    at the f32 bar of tests/test_pallas_kernel.py (kernel 8 needs n a
    multiple of its 2,048-row chunk)."""
    s = _setup(model, n, int8)
    jargs, targs = sweep_inputs(s, K=1)
    ref = getattr(JB, kernel)(s["spec"], *_one_chain(jargs), interpret=True)
    out = TB.sweep_mc_plain(port_spec(s["spec"]), *targs)
    assert out[0].shape == (1, s["spec"].m_pad)
    assert_kernel_bar(ref, [o[0] for o in out])


@pytest.mark.parametrize("int8", [True, False], ids=["int8", "f32"])
@pytest.mark.parametrize("model", ["BayesCpi", "BayesR"])
def test_kernel2_matches_port_k3(model, int8):
    """Kernel 2 at K = 3 against sweep_mc_plain at K = 3: every chain at the
    f32 bar."""
    s = _setup(model, 512, int8)
    jargs, targs = sweep_inputs(s, K=3)
    ref = JB.sweep_mc(s["spec"], *jargs, interpret=True)
    out = TB.sweep_mc_plain(port_spec(s["spec"]), *targs)
    assert out[0].shape == (3, s["spec"].m_pad)
    for k in range(3):
        assert_kernel_bar([r[k] for r in ref], [o[k] for o in out])


def test_chains_of_the_plain_sweep_do_not_depend_on_k():
    """Chain k of a K = 2 plain sweep is chain k of the K = 3 sweep, bit for
    bit (each chain's products are formed alone)."""
    s = _setup("BayesR", 512, True)
    _, targs = sweep_inputs(s, K=3)
    consts, X, W, xpx, vx, *per = targs
    spec = port_spec(s["spec"])
    three = TB.sweep_mc_plain(spec, consts, X, W, xpx, vx, *per)
    two = TB.sweep_mc_plain(spec, {k: v[:2] for k, v in consts.items()}, X, W, xpx, vx,
                            *(a[:2] for a in per))
    for a, b in zip(two, three):
        assert torch.equal(a, b[:2])
    assert not torch.equal(three[0][0], three[0][1])
