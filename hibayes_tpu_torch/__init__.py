"""hibayes_tpu_torch: the PyTorch / CUDA port of hibayes_tpu.

Runs the hibayes surface on one NVIDIA Hopper GPU: PLINK ingestion
(`read_plink`, `read_pheno`), LD construction on the card (`ldmat`,
`build_tiled_ld`), individual-level Bayesian regression (`ibrm`, every
method with BSLMM's GRM eigenbasis from `math/grm.py`, one chain or a
batch), summary-level regression over every LD layout (`sbrm`, MCMC and
its CG solver) and single-chain single-step regression with a pedigree
(`ssbrm`), every chain resumable from a checkpoint, through hand-written
CUDA kernels for the SNP and epsilon sweeps (csrc/), and on the CPU
through their plain PyTorch versions; `python -m hibayes_tpu_torch` runs
them as batch jobs (cli.py).
The JAX package ``hibayes_tpu`` stays the reference; this package never
imports it, nor JAX.

Numerical policy: float32 means float32.  TF32 is switched off for matrix
products and convolutions, the counterpart of the JAX package's
``precision=HIGHEST``.  Dtype and device are explicit arguments throughout.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .data.ld import BlockDiagLD, DenseLD, SparseLD, ldmat  # noqa: E402
from .data.pedigree import read_pedigree  # noqa: E402
from .data.pheno import read_pheno  # noqa: E402
from .data.plink import GenoMatrix, read_plink  # noqa: E402
from .data.sparse_ld import TiledSparseLD, build_tiled_ld  # noqa: E402
from .data.sumstats import read_sumstat  # noqa: E402
from .model.ibrm import ibrm  # noqa: E402
from .model.results import BlrMod  # noqa: E402
from .model.sbrm import sbrm  # noqa: E402
from .model.ssbrm import ssbrm  # noqa: E402

__all__ = [
    "read_plink", "GenoMatrix", "ldmat", "read_sumstat", "read_pheno", "read_pedigree",
    "ibrm", "sbrm", "ssbrm", "BlrMod", "plot",
    "DenseLD", "SparseLD", "BlockDiagLD", "TiledSparseLD", "build_tiled_ld",
]


def __getattr__(name):
    # `plot` needs matplotlib: loaded at first use, as the JAX package does,
    # so that installs without it keep working
    if name == "plot":
        import importlib

        return importlib.import_module(".plot", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__version__ = "0.1.0"
