"""Work of one iteration of the individual-level sweep on a SNP-sharded
mesh, one card's share: K chains over the shard of n x m / S SNP columns a
card holds.

The least work is the same whatever schedule does it (work/ibrm.py's
count of the whole, over the S cards): each SNP's draw needs its genotype
column twice for every chain, 4 n float32 operations a SNP a chain, and a
card's shard is read once an iteration for all chains (the pipeline reads
it once for each chain group it sweeps, S times, which the yardstick
leaves visible).  The shard at the cohort's real size in its stored type;
the collectives' bytes and the engine's n- and m-vectors are left out."""

from __future__ import annotations

from .ibrm import GENO_BYTES


def iteration_work(cfg: dict, chains: int) -> dict:
    n, m, S = cfg["n"], cfg["m"], cfg["mesh"][1]
    return {"bytes": n * m * GENO_BYTES[cfg["geno_dtype"]] / S,
            "flops": 4 * n * m * chains / S}
