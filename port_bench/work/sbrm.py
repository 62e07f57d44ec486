"""Work of one iteration of the summary-level sweep (sbrm) on a tiled LD
band, K chains.

The sweep needs every stored LD tile once: read once (float32), and 2 T^2
operations a tile a chain for the products of its dg with the tile (a SNP's
column of LD applied once, as the plain sequential sweep does).  Valid
tiles of a band of ``band_tiles`` tiles over nbr tile rows: nbr K minus the
slots that fall off either end."""

from __future__ import annotations


def valid_tiles(m: int, T: int, K: int) -> int:
    nbr, half = -(-m // T), K // 2
    return sum(min(nbr - 1, i + half) - max(0, i - half) + 1 for i in range(nbr))


def iteration_work(cfg: dict, chains: int) -> dict:
    T = cfg["tile"]
    tiles = valid_tiles(cfg["m"], T, cfg["band_tiles"])
    return {"bytes": tiles * T * T * 4, "flops": 2 * tiles * T * T * chains}
