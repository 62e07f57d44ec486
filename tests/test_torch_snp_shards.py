"""A genotype larger than one device: each rank of a (1, 4) mesh given its
own SNP columns alone (parallel/mesh.py:SnpShard), on gloo ranks on the CPU.

(a) The set-up of a rank's columns (``prepare_gibbs_data(SnpShard,
mesh=...)``) against the whole set-up cut by ``shard_gibbs_data``: X_blocks,
W_blocks and C_blocks equal, xpx, vx and the real mask gathered whole, bit for bit,
for an int8 genotype in blocks of 16 (n=600 x m=2,000: 125 blocks padded to
128, the last rank holding 464 columns) and a float64 one.  (b) A 4-chain
ring pipeline (``run_chains``, float32 with a resync every 5 iterations)
and ``ibrm`` (float64, some phenotypes missing) from the shards against the
same from the whole genotype: states, records, effects and the GEBV of the
phenotyped bit for bit; the unphenotyped ids' GEBV, whose column chunks the
shards' edges cut, to rounding; each rank's columns read from a .bed by
``load_plink_snp_sharded``.  Also ``snp_column_range``, the SNP range of a
.bed (``read_plink(snps=...)``), and (c) the benchmark's harness driving
the 4-chip cell at a small size."""


import numpy as np
import pytest
import torch

from hibayes_tpu_torch.data.plink import encode_bed_bytes, read_plink
from hibayes_tpu_torch.parallel.mesh import snp_blocks, snp_column_range

from .torch_dist import spawn

torch.set_num_threads(2)
RANKS = "tests.torch_dist:snp_shard_cases"


def _payload():
    rng = np.random.default_rng(3)
    n, m = 600, 2000
    M = rng.binomial(2, rng.uniform(0.05, 0.5, m), (n, m)).astype(np.int8)
    M[:, 7] = 1                                       # monomorphic: vx 0
    y = M[:, :40].astype(np.float64) @ rng.normal(0, 0.3, 40) + rng.normal(0, 1, n)
    nb, mb = 300, 512                                 # (b)'s cohort
    Mb = np.ascontiguousarray(M[:nb, :mb])
    yb = y[:nb].copy()
    y_na = yb.copy()
    y_na[::37] = np.nan
    return {"y": y, "M": M, "block": 16, "fold": np.array([0.0, 1e-4, 1e-3, 1e-2]),
            "layouts": [("int8", "int8", "float32"), ("float64", None, "float64")],
            "fit_y": yb, "fit_M": Mb, "y_na": y_na,
            "ids": np.array([f"i{k}" for k in range(nb)])}


@pytest.fixture(scope="module")
def outs(tmp_path_factory):
    p = _payload()
    tmp = tmp_path_factory.mktemp("snp_shards")
    p["bfile"] = _fileset(tmp, G=p["fit_M"])
    return spawn(RANKS, 4, tmp, p, timeout=240), p


def test_column_ranges_are_whole_blocks():
    """Rank s holds blocks [s nb/S, (s + 1) nb/S) of the blocks padded to a
    multiple of the shards (and of ``multiple``); the ranges tile [0, m)."""
    assert snp_blocks(2000, 16, 4) == (16, 128)
    assert snp_blocks(600_000, 128, 4) == (128, 4688)
    assert snp_blocks(100, 128, 4, 3) == (104, 12)
    assert [snp_column_range(600_000, 128, 4, s) for s in range(4)] == [
        (0, 150_016), (150_016, 150_016), (300_032, 150_016), (450_048, 149_952)]
    assert [snp_column_range(40, 16, 4, s) for s in range(4)] == [
        (0, 16), (16, 16), (32, 8), (40, 0)]
    for m, B, S, mult in ((2000, 16, 4, 1), (777, 64, 3, 2), (5, 64, 4, 1)):
        r = [snp_column_range(m, B, S, s, mult) for s in range(S)]
        assert r[0][0] == 0 and sum(c for _, c in r) == m
        assert all(a + c == b for (a, c), (b, _) in zip(r, r[1:]))
        B_, nb = snp_blocks(m, B, S, mult)
        assert all(a % B_ == 0 or c == 0 for a, c in r)


@pytest.mark.parametrize("layout", ["int8", "float64"])
def test_shard_setup_is_the_whole_setups_cut(outs, layout):
    """(a) Each rank's set-up of its columns equals the whole set-up cut
    for that rank, bit for bit; xpx, vx and real are whole on every rank;
    its cross-Grams are the float64 products of its own blocks, the first
    zero (it follows none of the rank's blocks)."""
    res, _ = outs
    for r in res:
        for f, (whole, part) in r["layout"][layout].items():
            assert whole.shape == part.shape, f
            np.testing.assert_array_equal(part, whole, err_msg=f)
        assert r["layout"][layout]["xpx"][0].shape == (128 * 16,)


def test_pipeline_from_shards_is_bit_for_bit(outs):
    """(b) run_chains and ibrm from the shards against the same from the
    whole genotype: states, records, effects and the phenotyped GEBV bit for
    bit, on every rank; the unphenotyped GEBV to rounding."""
    res, p = outs
    keep = ~np.isnan(p["y_na"])
    for r in res:
        whole, shard = r["fits"]["whole"], r["fits"]["shard"]
        assert shard["X_rows"] == whole["X_rows"] // 4
        for k, v in whole["state"].items():
            for a, b in (zip(v, shard["state"][k]) if isinstance(v, tuple) else [(v, shard["state"][k])]):
                np.testing.assert_array_equal(b, a, err_msg=k)
        for k, v in whole["samples"].items():
            np.testing.assert_array_equal(shard["samples"][k], v, err_msg=k)
        for k in ("alpha", "e"):
            np.testing.assert_array_equal(shard[k], whole[k], err_msg=k)
        np.testing.assert_array_equal(shard["g"][keep], whole["g"][keep])
        np.testing.assert_array_equal(shard["gebv"][keep], whole["gebv"][keep])
        np.testing.assert_allclose(shard["g"][~keep], whole["g"][~keep], rtol=1e-12,
                                   atol=1e-12 * np.abs(whole["g"]).max())
    for r in res[1:]:
        np.testing.assert_array_equal(r["fits"]["shard"]["gebv"], res[0]["fits"]["shard"]["gebv"])


def _tiny_cell():
    """The SNP-sharded cell at n=300 x m=512 (one block of 128 a rank)."""
    import copy

    from port_bench import harness

    cell = copy.deepcopy(harness.load("workloads", "ibrm_bayesr_uk200k-pipe4"))
    cfg = copy.deepcopy(harness.load("configs", cell["config"]))
    cfg.update(n=300, m=512, n_causal=20)
    return cell, cfg


@pytest.mark.parametrize("alter", [False, True], ids=["sound", "rank2_altered"])
def test_sharded_cell_reads_correct_and_catches_a_shard(tmp_path, alter):
    """(c) port_bench's harness on the CPU drives the SNP-sharded cell at a
    small size: rank 0 in the harness's process (spawned here without JAX),
    ranks 1-3 spawned by the entry, over gloo.  Sound, the plain reference
    (reference/ibrm_mesh.py, each block made again from the seed, the
    pipeline's order) reads ``correct``; with one effect of rank 2's shard
    altered after each of its sweeps, it does not.  No rank is left."""
    cell, cfg = _tiny_cell()
    (r, alive), = spawn("tests.torch_dist:harness_mesh_case", 1, tmp_path,
                        {"init": "own", "cell": cell, "cfg": cfg, "seed": 2 ** 33 + 5,
                         "alter": alter}, timeout=300)
    assert alive == []
    assert r["correct"] is (not alter)
    assert r["attempted"] > 4 * 512 * 6
    if alter:
        assert r["checks"]["effect_gap"]["value"] > 1.0
    else:
        assert r["checks"]["records_gap"]["value"] == 0


def _fileset(tmp_path, n=37, m=50, G=None):
    """A PLINK fileset of G (default: n x m codes, 10% missing)."""
    if G is None:
        rng = np.random.default_rng(5)
        G = rng.integers(0, 3, (n, m)).astype(np.int8)
        G[rng.random((n, m)) < 0.1] = -9
    n, m = G.shape
    stem = str(tmp_path / "c")
    with open(stem + ".bed", "wb") as f:
        f.write(encode_bed_bytes(G))
    with open(stem + ".fam", "w") as f:
        f.writelines(f"f{i} i{i} 0 0 1 -9\n" for i in range(n))
    with open(stem + ".bim", "w") as f:
        f.writelines(f"{1 + j // 25} s{j} 0 {1000 * j} A G\n" for j in range(m))
    return stem


@pytest.mark.parametrize("impute", [True, False])
def test_read_plink_snp_range_is_the_full_reads_columns(tmp_path, impute):
    """A SNP range of a .bed, read on its own (each SNP imputed by its own
    counts), equals the full read's columns; fam and map stay whole."""
    stem = _fileset(tmp_path)
    full = read_plink(stem, impute=impute)
    for s0, sc in ((0, 50), (0, 13), (13, 24), (49, 1), (50, 0)):
        part = read_plink(stem, impute=impute, snps=(s0, sc), max_chunk_bytes=64)
        np.testing.assert_array_equal(part["geno"].values, full["geno"].values[:, s0:s0 + sc])
        assert len(part["map"]["SNP"]) == 50 and len(part["fam"][0]) == 37
    with pytest.raises(ValueError):
        read_plink(stem, snps=(40, 11))
    with pytest.raises(ValueError):
        read_plink(stem, snps=(0, 5), out=str(tmp_path / "o"))
