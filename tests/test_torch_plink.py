"""The port's host I/O (hibayes_tpu_torch/data/plink.py, data/pheno.py,
native/bed_codec.py) against the JAX package's, bit for bit, on filesets
written by ``encode_bed_bytes`` (n % 4 != 0, so the last byte of every SNP
is padded; missing codes): decode and encode in modes A and D, chunked,
row-sharded and memmapped reads, imputation, column statistics, the native
codec against the numpy path, and the phenotype table.  Both packages'
native codecs build with one set of flags from one source; where no
compiler is found both take the numpy path."""

import numpy as np
import pytest

from hibayes_tpu.data import pheno as JP
from hibayes_tpu.data import plink as JPL
from hibayes_tpu_torch.data import pheno as TP
from hibayes_tpu_torch.data import plink as TPL
from hibayes_tpu_torch.native import bed_codec as TC


def _write_bed(tmp_path, g, name="t", chroms=None):
    n, m = g.shape
    (tmp_path / f"{name}.bed").write_bytes(TPL.encode_bed_bytes(g))
    with open(tmp_path / f"{name}.bim", "w") as f:
        for j in range(m):
            c = chroms[j] if chroms is not None else 1
            f.write(f"{c}\tM{j}\t0\t{1000 * (j + 1)}\tA\tG\n")
    with open(tmp_path / f"{name}.fam", "w") as f:
        for i in range(n):
            f.write(f"F{i}\tI{i}\t0\t0\t{1 + i % 2}\t-9\n")
    return str(tmp_path / name)


@pytest.fixture
def geno():
    rng = np.random.default_rng(7)
    g = rng.integers(0, 3, size=(203, 37)).astype(np.int8)
    g[rng.random(g.shape) < 0.1] = -9
    return g


def _same_read(a, b):
    np.testing.assert_array_equal(np.asarray(b["geno"].values), np.asarray(a["geno"].values))
    assert b["geno"].values.dtype == np.int8
    for x, y in zip(a["fam"], b["fam"]):
        np.testing.assert_array_equal(y, x)
    for k in a["map"]:
        np.testing.assert_array_equal(b["map"][k], a["map"][k])


def test_encode_bytes_equal_jax(geno):
    assert TPL.encode_bed_bytes(geno) == JPL.encode_bed_bytes(geno)


@pytest.mark.parametrize("mode", ["A", "D"])
def test_decode_matches_jax(geno, mode):
    n, m = geno.shape
    payload = np.frombuffer(TPL.encode_bed_bytes(geno), dtype=np.uint8)[3:]
    out = TPL.decode_bed_bytes(payload, n, m, mode)
    np.testing.assert_array_equal(out, JPL.decode_bed_bytes(payload, n, m, mode))
    expect = geno if mode == "A" else np.where(geno == -9, -9, (geno == 1).astype(np.int8))
    np.testing.assert_array_equal(out, expect)


@pytest.mark.parametrize("mode", ["A", "D"])
@pytest.mark.parametrize("impute", [True, False])
def test_read_plink_matches_jax(tmp_path, geno, mode, impute):
    bfile = _write_bed(tmp_path, geno)
    _same_read(JPL.read_plink(bfile, impute=impute, mode=mode),
               TPL.read_plink(bfile, impute=impute, mode=mode))


def test_read_plink_chunked_rows_and_out(tmp_path, geno):
    """Small chunks, a row shard (imputed by the global major genotype) and
    a file-backed read re-attached: each equal to JAX's, and the chunked
    and row reads to the whole read."""
    bfile = _write_bed(tmp_path, geno)
    whole = TPL.read_plink(bfile)
    chunked = TPL.read_plink(bfile, max_chunk_bytes=600)
    _same_read(JPL.read_plink(bfile, max_chunk_bytes=600), chunked)
    _same_read(whole, chunked)
    rows = TPL.read_plink(bfile, rows=(50, 77))
    _same_read(JPL.read_plink(bfile, rows=(50, 77)), rows)
    np.testing.assert_array_equal(rows["geno"].values, whole["geno"].values[50:127])
    out = TPL.read_plink(bfile, out=str(tmp_path / "store" / "g"), max_chunk_bytes=1000)
    att = TPL.GenoMatrix.attach(str(tmp_path / "store" / "g"))
    np.testing.assert_array_equal(np.asarray(att.values), whole["geno"].values)
    np.testing.assert_array_equal(np.asarray(out["geno"].values), whole["geno"].values)
    ref = JPL.read_plink(bfile, out=str(tmp_path / "jstore" / "g"), max_chunk_bytes=1000)
    for ext in (".desc", ".id", ".map"):
        assert (open(str(tmp_path / "store" / "g") + ext).read()
                == open(str(tmp_path / "jstore" / "g") + ext).read())
    np.testing.assert_array_equal(np.asarray(ref["geno"].values), np.asarray(att.values))


def test_region_counts_and_impute_match_jax(tmp_path, geno):
    n, m = geno.shape
    bfile = _write_bed(tmp_path, geno)
    p_t = TPL.bed_payload_memmap(bfile + ".bed", n, m)
    p_j = JPL.bed_payload_memmap(bfile + ".bed", n, m)
    np.testing.assert_array_equal(TPL.bed_geno_counts(p_t, n), JPL.bed_geno_counts(p_j, n))
    for rows, cols in [((0, n), (3, 20)), ((5, 101), (0, m)), ((1, 7), (30, 7))]:
        np.testing.assert_array_equal(
            TPL.decode_bed_region(p_t, n, rows=rows, cols=cols),
            JPL.decode_bed_region(p_j, n, rows=rows, cols=cols))
    np.testing.assert_array_equal(TPL.impute_major(geno), JPL.impute_major(geno))
    counts = TPL.bed_geno_counts(p_t, n)
    np.testing.assert_array_equal(TPL.impute_major_with_counts(geno, counts),
                                  JPL.impute_major_with_counts(geno, counts))


def test_col_stats_and_persistence_match_jax(tmp_path, geno):
    g = JPL.impute_major(geno)
    a, b = JPL.GenoMatrix(values=g), TPL.GenoMatrix(values=g)
    for k, v in a.col_stats().items():
        np.testing.assert_array_equal(b.col_stats()[k], v, err_msg=k)
    b.save(str(tmp_path / "p"))
    np.testing.assert_array_equal(np.asarray(TPL.GenoMatrix.attach(str(tmp_path / "p")).values), g)


def test_native_codec_matches_numpy_path(geno, monkeypatch):
    """The port's C++ codec (built at first use into the package's build/)
    against its own numpy path: decode A and D, encode, imputation and
    column statistics (the sums exact, the means and roots to the last
    bits of float64)."""
    if not TC.available():
        pytest.skip("no C++ toolchain to build the codec")
    n, m = geno.shape
    payload = np.frombuffer(TPL.encode_bed_bytes(geno), dtype=np.uint8)[3:]
    native = {mode: TPL.decode_bed_bytes(payload, n, m, mode) for mode in "AD"}
    enc = TC.encode(geno)
    imp = TPL.impute_major(geno)
    stats = TC.col_stats(imp)
    monkeypatch.setattr(TC, "available", lambda: False)
    for mode in "AD":
        np.testing.assert_array_equal(native[mode], TPL.decode_bed_bytes(payload, n, m, mode))
    np.testing.assert_array_equal(enc, payload)
    np.testing.assert_array_equal(imp, TPL.impute_major(geno))
    plain = TPL.GenoMatrix(values=imp).col_stats()
    np.testing.assert_array_equal(stats["sum"], plain["sum"])
    np.testing.assert_allclose(stats["mean"], plain["mean"], rtol=1e-15)
    np.testing.assert_allclose(stats["sqrt_ssd"], plain["sqrt_ssd"], rtol=1e-12)


def test_read_pheno_matches_jax(tmp_path):
    path = tmp_path / "p.phe"
    path.write_text("id T1 sex loc\nI0 1.5 1 a\nI1 NA 2 b\nI2 -0.25 . a\nI3 3e-2 1\n")
    a, b = JP.read_pheno(str(path)), TP.read_pheno(str(path))
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(b[k], a[k])
