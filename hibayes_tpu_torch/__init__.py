"""hibayes_tpu_torch: the PyTorch / CUDA port of hibayes_tpu.

Runs single-chain individual-level Bayesian regression (`ibrm`, every method
but BSLMM), single-chain summary-level regression over dense or
tiled-sparse LD (`sbrm`, and its CG solver over every LD layout) and
single-chain single-step regression with a pedigree (`ssbrm`) on one
NVIDIA Hopper GPU through hand-written CUDA kernels for the SNP and
epsilon sweeps (csrc/), and on the CPU through their plain PyTorch
versions.
The JAX package ``hibayes_tpu`` stays the reference; this package never
imports it, nor JAX.

Numerical policy: float32 means float32.  TF32 is switched off for matrix
products and convolutions, the counterpart of the JAX package's
``precision=HIGHEST``.  Dtype and device are explicit arguments throughout.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .data.ld import BlockDiagLD, DenseLD, SparseLD  # noqa: E402
from .data.pedigree import read_pedigree  # noqa: E402
from .data.sparse_ld import TiledSparseLD  # noqa: E402
from .data.sumstats import read_sumstat  # noqa: E402
from .model.ibrm import ibrm  # noqa: E402
from .model.results import BlrMod  # noqa: E402
from .model.sbrm import sbrm  # noqa: E402
from .model.ssbrm import ssbrm  # noqa: E402

__all__ = ["ibrm", "sbrm", "ssbrm", "read_sumstat", "read_pedigree", "DenseLD",
           "SparseLD", "BlockDiagLD", "TiledSparseLD", "BlrMod"]
__version__ = "0.1.0"
