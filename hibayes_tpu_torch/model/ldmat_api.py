"""Public `ldmat` entry point (re-export with the reference's name/signature;
hibayes_tpu/model/ldmat_api.py).

(reference: R/ldm.r:31-112)
"""

from ..data.ld import BlockDiagLD, DenseLD, SparseLD, ldmat

__all__ = ["ldmat", "DenseLD", "SparseLD", "BlockDiagLD"]
