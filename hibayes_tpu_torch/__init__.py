"""hibayes_tpu_torch: the PyTorch / CUDA port of hibayes_tpu.

Runs single-chain individual-level Bayesian regression (`ibrm`, every method
but BSLMM) on one NVIDIA Hopper GPU through hand-written CUDA kernels for the
SNP sweep (csrc/), and on the CPU through their plain PyTorch versions.
The JAX package ``hibayes_tpu`` stays the reference; this package never
imports it, nor JAX.

Numerical policy: float32 means float32.  TF32 is switched off for matrix
products and convolutions, the counterpart of the JAX package's
``precision=HIGHEST``.  Dtype and device are explicit arguments throughout.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .model.ibrm import ibrm  # noqa: E402
from .model.results import BlrMod  # noqa: E402

__all__ = ["ibrm", "BlrMod"]
__version__ = "0.1.0"
