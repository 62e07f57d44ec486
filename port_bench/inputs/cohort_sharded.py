"""An individual-level cohort larger than one card, made on the cards from
a seed, one rank's SNP shard at a time: an int8 genotype and the phenotype
of ``cohort.py`` (a covariate and a 20-level factor).

Every column chunk of ``block`` SNPs (the configuration's block, so that a
rank's columns, whole blocks, are whole chunks) is a pure function of (seed,
chunk index): a generator of its own, seeded by a hash of both, draws the
chunk's allele frequencies p_j ~ U(0.05, 0.5) and its n x block allele
counts Binomial(2, p_j), as two uniform draws below p_j.  Any process can
so make any rank's columns, and the reference can make them again, and no
process makes more than it holds.

The phenotype is ``cohort.py:phenotype``'s recipe: y = gv + 0.3 x1 + grp +
e, h2 from ``n_causal`` SNPs with N(0, 1) effects, every draw but the
genotype's from the harness's generator.  The causal SNPs' columns are made
again from their chunks.  Rank 0, the harness's process, makes it and
hands it to the other ranks, so that every rank fits the same y bit for
bit.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch


def chunk_seed(seed: int, c: int) -> int:
    """The seed of column chunk ``c`` of the cohort of ``seed`` (63 bits)."""
    h = hashlib.sha256(f"cohort_sharded:{int(seed)}:{int(c)}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def chunk(seed: int, c: int, n: int, block: int, m: int, dev) -> torch.Tensor:
    """Columns [c block, min(m, (c + 1) block)) of the genotype, (n, width)
    int8: a pure function of (seed, c) on a given kind of device."""
    width = min(block, m - c * block)
    gen = torch.Generator(device=dev).manual_seed(chunk_seed(seed, c))
    p = torch.rand(width, generator=gen, device=dev) * 0.45 + 0.05
    a = torch.rand((n, width), generator=gen, device=dev) < p
    b = torch.rand((n, width), generator=gen, device=dev) < p
    return a.to(torch.int8) + b.to(torch.int8)


def columns(seed: int, start: int, count: int, n: int, block: int, m: int, dev):
    """Columns [start, start + count) of the genotype (start a multiple of
    ``block``), (n, count) int8, made chunk by chunk."""
    if start % block:
        raise ValueError(f"a shard starts at a block's first column, not {start}")
    M = torch.empty((n, count), dtype=torch.int8, device=dev)
    for c0 in range(0, count, block):
        c = (start + c0) // block
        M[:, c0:c0 + block] = chunk(seed, c, n, block, m, dev)
    return M


def shard(cfg: dict, seed: int, index: int, dev) -> tuple:
    """(start, columns) of SNP shard ``index`` of the configuration's mesh
    (``parallel/mesh.py:snp_column_range``)."""
    # imported here: the reference makes chunks again and imports nothing of
    # the program
    from hibayes_tpu_torch.parallel.mesh import snp_column_range

    n, m, B = cfg["n"], cfg["m"], cfg["block"]
    start, count = snp_column_range(m, B, cfg["mesh"][1], index)
    return start, columns(seed, start, count, n, B, m, dev)


def phenotype(seed: int, cfg: dict, gen: torch.Generator, dev) -> dict:
    """The data dict of ``ibrm(cfg["formula"])`` (id, y, x1, grp), its
    genetic values from the causal SNPs' columns made again by their
    chunks."""
    n, m, B = cfg["n"], cfg["m"], cfg["block"]
    h2 = cfg["h2"]
    causal = torch.randperm(m, generator=gen, device=dev)[:cfg["n_causal"]]
    b = torch.randn(causal.numel(), generator=gen, device=dev)
    Xc = torch.empty((n, causal.numel()), dtype=torch.float32, device=dev)
    cs = causal.cpu().numpy()
    for c in np.unique(cs // B):
        at = np.nonzero(cs // B == c)[0]
        cols = torch.as_tensor(cs[at] - c * B, device=dev)
        Xc[:, torch.as_tensor(at, device=dev)] = chunk(seed, int(c), n, B, m, dev)[:, cols].float()
    gv = Xc @ b
    gv = (gv - gv.mean()) / gv.std() * np.sqrt(h2)
    x1 = torch.randn(n, generator=gen, device=dev)
    nl = cfg["factor_levels"]
    grp = torch.randint(0, nl, (n,), generator=gen, device=dev)
    grp_eff = 0.3 * torch.randn(nl, generator=gen, device=dev)
    y = gv + 0.3 * x1 + grp_eff[grp] + np.sqrt(1.0 - h2) * torch.randn(
        n, generator=gen, device=dev)
    return {"id": np.array([f"id{i}" for i in range(n)]), "y": y.cpu().numpy(),
            "x1": x1.cpu().numpy(),
            "grp": np.array([f"g{k}" for k in grp.cpu().numpy()])}


def make(cfg: dict, gen: torch.Generator, dev) -> dict:
    """Rank 0's part of the cohort of configuration ``cfg``: {"M": its
    columns, "start": their first, "seed": the cohort's seed, "data": the
    phenotype}."""
    seed = gen.initial_seed()
    start, M = shard(cfg, seed, 0, dev)
    return {"M": M, "start": start, "seed": seed, "data": phenotype(seed, cfg, gen, dev)}
