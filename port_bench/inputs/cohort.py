"""An individual-level cohort made on the card from a seed: an int8 genotype
and a phenotype with a covariate and a 20-level factor.

Frozen copies of ``make_genotype`` and ``phenotype`` of chip_smoke.py
(chip_smoke.py:381-391 and :401-425 at the commit that added this file),
written as functions of a ``torch.Generator``.  The benchmark imports
nothing from chip_smoke.py, so a change there cannot move these inputs.
"""

from __future__ import annotations

import numpy as np
import torch


def make_genotype(n: int, m: int, gen: torch.Generator, dev, chunk: int = 4096):
    """(n, m) int8 allele counts, Binomial(2, p_j), p_j ~ U(0.05, 0.5)."""
    M = torch.empty((n, m), dtype=torch.int8, device=dev)
    p = torch.rand(m, generator=gen, device=dev) * 0.45 + 0.05
    for c0 in range(0, m, chunk):
        pc = p[c0:c0 + chunk]
        a = torch.rand((n, pc.numel()), generator=gen, device=dev) < pc
        b = torch.rand((n, pc.numel()), generator=gen, device=dev) < pc
        M[:, c0:c0 + chunk] = a.to(torch.int8) + b.to(torch.int8)
    return M


def phenotype(M: torch.Tensor, gen: torch.Generator, dev, n_causal: int = 500,
              h2: float = 0.5, n_levels: int = 20):
    """y = gv + 0.3 x1 + grp + e for the genotype M, h2 from ``n_causal``
    SNPs.  Returns the data dict of ``ibrm("y ~ x1 + (1|grp)")``: id, y,
    x1 and the factor's labels grp."""
    n, m = M.shape
    causal = torch.randperm(m, generator=gen, device=dev)[:n_causal]
    b = torch.randn(causal.numel(), generator=gen, device=dev)
    gv = M[:, causal].float() @ b
    gv = (gv - gv.mean()) / gv.std() * np.sqrt(h2)
    x1 = torch.randn(n, generator=gen, device=dev)
    grp = torch.randint(0, n_levels, (n,), generator=gen, device=dev)
    grp_eff = 0.3 * torch.randn(n_levels, generator=gen, device=dev)
    y = gv + 0.3 * x1 + grp_eff[grp] + np.sqrt(1.0 - h2) * torch.randn(
        n, generator=gen, device=dev)
    return {"id": np.array([f"id{i}" for i in range(n)]), "y": y.cpu().numpy(),
            "x1": x1.cpu().numpy(),
            "grp": np.array([f"g{k}" for k in grp.cpu().numpy()])}


def make(cfg: dict, gen: torch.Generator, dev) -> dict:
    """The cohort of configuration ``cfg``: {"M": genotype, "data": dict}."""
    M = make_genotype(cfg["n"], cfg["m"], gen, dev)
    return {"M": M, "data": phenotype(M, gen, dev, cfg["n_causal"], cfg["h2"],
                                      cfg["factor_levels"])}
