"""LD (tXX) variance-covariance matrices in the three layouts `sbrm` takes.

Counterparts of the classes of hibayes_tpu/data/ld.py (reference return
types: R/ldm.r:86-111):

* ``DenseLD``     — m x m dense: SBayesD semantics in `sbrm`;
* ``SparseLD``    — chi-square-pruned, dense storage with explicit zeros and
                    the per-column nonzero counts (SBayesS's varediff);
* ``BlockDiagLD`` — per-chromosome dense blocks.

``DenseLD.values`` may be a numpy array or a torch tensor on any device, so
that a matrix made on the card is not copied through the host.  ``diag`` and
``nnz_per_col`` are numpy float64 / int64; ``matvec`` takes and returns
numpy.  ``ldmat`` (building LD from genotypes) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


def as_numpy(x) -> np.ndarray:
    """A numpy array or a torch tensor (any device) as a numpy array."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def dense_matvec(values, v) -> np.ndarray:
    """values @ v in float64 for numpy or torch ``values``; numpy out."""
    if isinstance(values, torch.Tensor):
        vt = torch.as_tensor(np.asarray(v, np.float64), device=values.device)
        return (values.to(torch.float64) @ vt).cpu().numpy()
    return values @ v


@dataclass
class DenseLD:
    values: np.ndarray  # (m, m) numpy array or torch tensor

    @property
    def m(self):
        return self.values.shape[0]

    @property
    def diag(self):
        d = (torch.diagonal(self.values) if isinstance(self.values, torch.Tensor)
             else np.diag(self.values))
        return as_numpy(d).astype(np.float64)

    def nnz_per_col(self):
        return np.full(self.m, self.m, dtype=np.int64)

    def matvec(self, v):
        return dense_matvec(self.values, v)


@dataclass
class SparseLD:
    """Chi-square-pruned LD.  Dense storage with explicit zeros plus the
    sparsity pattern; triggers SBayesS semantics in `sbrm`."""

    values: np.ndarray       # (m, m) with zeros outside the pattern
    nnz_col: np.ndarray      # (m,) nonzeros per column (for varediff)

    @property
    def m(self):
        return self.values.shape[0]

    @property
    def diag(self):
        return np.diag(self.values)

    def nnz_per_col(self):
        return self.nnz_col

    def matvec(self, v):
        return self.values @ v

    @classmethod
    def from_scipy(cls, mat):
        import scipy.sparse as sp

        csc = sp.csc_matrix(mat)
        nnz = np.diff(csc.indptr).astype(np.int64)
        return cls(values=np.asarray(csc.todense()), nnz_col=nnz)


@dataclass
class BlockDiagLD:
    """Per-chromosome dense blocks.  SNPs must be grouped contiguously by
    chromosome."""

    blocks: list                    # list[np.ndarray] (m_c, m_c)
    sizes: list = field(default_factory=list)
    nnz_col: np.ndarray | None = None  # set when chi-square-pruned

    @property
    def m(self):
        return int(sum(self.sizes))

    @property
    def diag(self):
        return np.concatenate([np.diag(b) for b in self.blocks])

    def nnz_per_col(self):
        if self.nnz_col is not None:
            return self.nnz_col
        return np.concatenate(
            [np.full(s, s, dtype=np.int64) for s in self.sizes]
        )

    def matvec(self, v):
        out = np.empty_like(v)
        off = 0
        for b, s in zip(self.blocks, self.sizes):
            out[off : off + s] = b @ v[off : off + s]
            off += s
        return out
