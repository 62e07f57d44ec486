"""Work of one iteration of the individual-level sweep (ibrm), K chains.

Each SNP's draw needs its genotype column twice, once for X_j' r and once
for the residual update r -= X_j dg_j, for every chain: 4 n float32
operations a SNP a chain.  The genotype is read once an iteration for all
chains, at the cohort's real size in its stored type (the program's row
and column padding is not counted).  The engine's n- and m-vectors are
left out as negligible."""

from __future__ import annotations

GENO_BYTES = {"int8": 1, "float32": 4}


def iteration_work(cfg: dict, chains: int) -> dict:
    n, m = cfg["n"], cfg["m"]
    return {"bytes": n * m * GENO_BYTES[cfg["geno_dtype"]],
            "flops": 4 * n * m * chains}
