"""LD construction in the port (hibayes_tpu_torch/data/ld.py ``ldmat``,
data/sparse_ld.py ``build_tiled_ld``) against the JAX package's, on the
CPU: every layout bit for bit on int8 genotypes (the exact integer Gram,
float64 centring and chi-square mask are elementwise IEEE operations), the
GWAS-panel overlay, the tiled construction's host path bit for bit and its
device path within float32 (keep decisions may part only where r^2 n lies
at the threshold), then `read_plink` -> `ldmat` -> `sbrm` end to end and
the plots.  Genotypes copy their left neighbour with probability 0.6, so
LD decays along each chromosome; n = 203 (not a multiple of 8: the int8
product's padding), m = 150 over three chromosomes."""

import numpy as np
import pytest
import torch

import hibayes_tpu as hj
import hibayes_tpu_torch as ht
from hibayes_tpu.data import plink as JPL
from hibayes_tpu.data import sparse_ld as JS
from hibayes_tpu_torch.data import ld as TLD
from hibayes_tpu_torch.data import sparse_ld as TS

torch.set_num_threads(2)


def _ld_geno(n=203, m=150, seed=0, copy_p=0.6):
    rng = np.random.default_rng(seed)
    X = rng.binomial(2, rng.uniform(0.1, 0.5, m), (n, m)).astype(np.int8)
    for j in range(1, m):
        c = rng.random(n) < copy_p
        X[c, j] = X[c, j - 1]
    return X


def _map(m, sizes=(60, 50, 40), prefix="s"):
    return {"SNP": np.array([f"{prefix}{i}" for i in range(m)]),
            "Chr": np.repeat([str(c + 1) for c in range(len(sizes))], sizes),
            "Pos": np.arange(m) * 1000}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same_ld(a, b):
    assert type(a).__name__ == type(b).__name__
    if hasattr(a, "blocks"):
        assert list(a.sizes) == list(b.sizes)
        for x, y in zip(a.blocks, b.blocks):
            np.testing.assert_array_equal(_np(y), np.asarray(x))
        assert (a.nnz_col is None) == (b.nnz_col is None)
    else:
        np.testing.assert_array_equal(_np(b.values), np.asarray(a.values))
    np.testing.assert_array_equal(b.nnz_per_col(), a.nnz_per_col())
    np.testing.assert_array_equal(b.diag, a.diag)


def _overlay():
    """A GWAS panel of other individuals over 70 of the SNPs, listed in
    another order and with two SNPs the reference panel lacks."""
    Xg = _ld_geno(n=157, seed=3)
    mp = _map(150)
    pick = np.random.default_rng(4).permutation(150)[:70]
    ids = np.concatenate([mp["SNP"][pick], ["x1", "x2"]])
    Xg = np.concatenate([Xg[:, pick], Xg[:, :2]], axis=1)
    return Xg, {"SNP": ids, "Chr": np.ones(72, str), "Pos": np.arange(72)}


KINDS = {
    "dense": dict(),
    "sparse": dict(chisq=10.0),
    "blockdiag": dict(map=True),
    "blockdiag_chisq": dict(map=True, chisq=10.0),
    "dense_overlay": dict(overlay=True, ldchr=True, map=True),
    "sparse_overlay": dict(overlay=True, ldchr=True, map=True, chisq=5.0),
    "blockdiag_overlay": dict(overlay=True, map=True, chisq=10.0),
}


@pytest.mark.parametrize("kind", list(KINDS))
def test_ldmat_int8_equals_jax_bit_for_bit(kind):
    X = _ld_geno()
    kw = dict(KINDS[kind])
    if kw.pop("map", False):
        kw["map"] = _map(150)
    if kw.pop("overlay", False):
        kw["gwas_geno"], kw["gwas_map"] = _overlay()
    ref = hj.ldmat(X, **kw)
    out = ht.ldmat(X, device="cpu", **kw)
    _assert_same_ld(ref, out)


def test_ldmat_float_input_within_float32():
    """Float genotypes take the float32 Gram in both packages (the JAX
    package's ``_cov_gram`` is float32 at HIGHEST precision), so the two
    agree to float32 rounding, not to float64's: within 5e-6 of the
    largest covariance (sums of 203 float32 products in another order, a
    few float32 epsilons of their terms), and so does each against a
    float64 reference."""
    X = _ld_geno().astype(np.float32) + 0.5
    ref = np.asarray(hj.ldmat(X).values)
    out = ht.ldmat(X, device="cpu").values.numpy()
    Xc = X.astype(np.float64) - X.astype(np.float64).mean(0)
    exact = Xc.T @ Xc / X.shape[0]
    scale = np.abs(exact).max()
    np.testing.assert_allclose(out, ref, rtol=0, atol=5e-6 * scale)
    np.testing.assert_allclose(out, exact, rtol=0, atol=5e-6 * scale)


@pytest.mark.parametrize("p,k,q", [(150, 203, 150), (7, 13, 40), (64, 8, 24)])
def test_int_gram_is_exact(p, k, q):
    """The padded int8 product equals the int64 product at shapes the
    library does not take as they are (k not a multiple of 8, p < 16)."""
    rng = np.random.default_rng(p + k + q)
    Xi = torch.from_numpy(rng.integers(0, 3, (k, p)).astype(np.int8))
    Xj = torch.from_numpy(rng.integers(0, 3, (k, q)).astype(np.int8))
    S, si, sj = TLD.int_gram(Xi, Xj)
    assert torch.equal(S, Xi.long().t() @ Xj.long())
    assert torch.equal(si, Xi.long().sum(0)) and torch.equal(sj, Xj.long().sum(0))
    S2, s2, _ = TLD.int_gram(Xi)
    assert torch.equal(S2, Xi.long().t() @ Xi.long()) and torch.equal(s2, si)


def _assert_same_tiles(a, b):
    np.testing.assert_array_equal(_np(b.col_idx), a.col_idx)
    np.testing.assert_array_equal(_np(b.valid), a.valid)
    np.testing.assert_array_equal(_np(b.nnz_col), a.nnz_col)
    assert (b.tile, b.m) == (a.tile, a.m)


@pytest.mark.parametrize("case", ["chrom", "chisq", "chisq_chrom", "overlay"])
def test_tiled_host_path_equals_jax(case):
    """The float64 host path (and the overlay, which takes it at any store
    type) bit for bit: tiles, columns, masks and nonzero counts."""
    X = _ld_geno()
    mp = _map(150)
    kw = dict(tiled=True, tile=16, stripe=48)
    if case != "chisq":
        kw["map"] = mp
    if case != "chrom":
        kw["chisq"] = 10.0
    if case == "overlay":
        kw["gwas_geno"], kw["gwas_map"] = _overlay()
    else:
        kw["dtype"] = torch.float64
    ref = hj.ldmat(X, **{**kw, "dtype": np.float64 if case != "overlay" else np.float32})
    out = ht.ldmat(X, device="cpu", **kw)
    _assert_same_tiles(ref, out)
    np.testing.assert_array_equal(_np(out.tiles), ref.tiles)


@pytest.mark.parametrize("chrom", [False, True])
def test_tiled_device_path_matches_jax(chrom):
    """The device path (int8, float32 store), run on the CPU, against the
    JAX package's ``_build_tiled_device``: the same columns, masks and
    nonzero counts, tiles within 1e-6.  Keep decisions could part only for
    entries whose r^2 n lies within 1e-5 relative of chisq (float32 sums in
    another order); such entries are counted and there are none here."""
    X = _ld_geno(m=300, seed=1)
    chisq = 8.0
    chroms = np.repeat(["1", "2", "3"], [120, 100, 80]) if chrom else None
    ref = JS.build_tiled_ld(X, chisq=chisq, chrom=chroms, tile=32, stripe=96)
    out = TS.build_tiled_ld(X, chisq=chisq, chrom=chroms, tile=32, stripe=96, device="cpu")
    assert isinstance(out.tiles, torch.Tensor) and out.tiles.dtype == torch.float32
    Xc = X.astype(np.float64) - X.mean(0)
    G = Xc.T @ Xc / X.shape[0]
    d = np.sqrt(np.diag(G))
    r2n = (G / np.outer(d, d)) ** 2 * X.shape[0]
    borderline = int((np.abs(r2n - chisq) < 1e-5 * chisq).sum())
    assert borderline == 0
    _assert_same_tiles(ref, out)
    np.testing.assert_allclose(out.tiles.numpy(), ref.tiles, rtol=0, atol=1e-6)
    np.testing.assert_allclose(out.to_dense(), ref.to_dense(), rtol=0, atol=1e-6)


def test_ldmat_tiled_device_via_api():
    """``ldmat(tiled=True)`` (tile 64, int8, float32 store, per chromosome)
    takes the device path in both packages and agrees."""
    X = _ld_geno(m=300, seed=2)
    mp = _map(300, sizes=(130, 100, 70))
    ref = hj.ldmat(X, map=mp, chisq=10.0, tiled=True)
    out = ht.ldmat(X, map=mp, chisq=10.0, tiled=True, device="cpu")
    assert out.tile == 64
    _assert_same_tiles(ref, out)
    np.testing.assert_allclose(out.tiles.numpy(), ref.tiles, rtol=0, atol=1e-6)


def test_ldmat_needs_a_gpu_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ht.ldmat(_ld_geno(n=30, m=20))


def _fileset(tmp_path, n=1200, m=256, seed=11):
    """A PLINK fileset of two chromosomes with LD, a phenotype of h2 0.5
    from 12 causal SNPs, and the cohort's marginal regressions as COJO
    summary statistics."""
    rng = np.random.default_rng(seed)
    X = _ld_geno(n=n, m=m, seed=seed)
    X[rng.random(X.shape) < 0.01] = -9
    (tmp_path / "c.bed").write_bytes(JPL.encode_bed_bytes(X))
    with open(tmp_path / "c.bim", "w") as f:
        for j in range(m):
            f.write(f"{1 + j * 2 // m}\tM{j}\t0\t{1000 * (j + 1)}\tA\tG\n")
    with open(tmp_path / "c.fam", "w") as f:
        for i in range(n):
            f.write(f"F{i}\tI{i}\t0\t0\t1\t-9\n")
    G = JPL.impute_major(X).astype(np.float64)
    b = np.zeros(m)
    b[rng.choice(m, 12, replace=False)] = rng.normal(0, 1, 12)
    gv = G @ b
    y = gv + rng.normal(0, gv.std(), n)
    Gc, yc = G - G.mean(0), y - y.mean()
    vx = (Gc ** 2).sum(0)
    beta = Gc.T @ yc / vx
    se = np.sqrt(((yc[:, None] - Gc * beta) ** 2).sum(0) / (n - 2) / vx)
    maf = G.mean(0) / 2
    ss = np.column_stack([np.minimum(maf, 1 - maf), beta, se, np.full(m, float(n))])
    return str(tmp_path / "c"), ss, b


def test_read_plink_ldmat_sbrm_agrees_with_jax(tmp_path):
    """The README's summary path on the port: read_plink -> ldmat(map=,
    ldchr=False) -> sbrm BayesCpi on the BlockDiagLD (SBayesS semantics, the
    guarded segment sweep), against the same path of the JAX package.  The
    LD equals JAX's bit for bit; the fits draw different streams, so the
    posterior-mean effects agree to Monte-Carlo error: correlation >= 0.99
    (BayesCpi, 200 of 300 iterations kept), Vg within one posterior
    standard deviation."""
    bfile, ss, b = _fileset(tmp_path)
    bj, bt = JPL.read_plink(bfile), ht.read_plink(bfile)
    ld_j = hj.ldmat(bj["geno"], map=bj["map"], ldchr=False)
    ld_t = ht.ldmat(bt["geno"], map=bt["map"], ldchr=False, device="cpu")
    _assert_same_ld(ld_j, ld_t)
    kw = dict(method="BayesCpi", niter=300, nburn=100, verbose=False)
    ref = hj.sbrm(ss, ld_j, **kw)
    out = ht.sbrm(ss, ld_t, device="cpu", **kw)
    assert np.corrcoef(ref.alpha, out.alpha)[0, 1] >= 0.99
    sd = np.concatenate([ref.MCMCsamples["Vg"], out.MCMCsamples["Vg"]]).std()
    assert abs(ref.Vg - out.Vg) < sd
    assert np.corrcoef(out.alpha, b)[0, 1] > 0.9
    assert out.guard.shape == (1, 2)


def test_sbrm_chain_batch_on_ldmat_sparse(tmp_path):
    """Two chains on the chromosome-1 SparseLD from ldmat(chisq=): both
    finite, split R-hat and guard counts per chain."""
    bfile, ss, b = _fileset(tmp_path, n=600, m=128)
    bt = ht.read_plink(bfile)
    ld = ht.ldmat(bt["geno"], chisq=10.0, device="cpu")
    fit = ht.sbrm(ss, ld, method="BayesR", niter=60, nburn=30, nchains=2,
                  verbose=False, device="cpu")
    assert isinstance(ld, ht.SparseLD) and fit.guard.shape == (2, 2)
    assert np.isfinite(fit.rhat["Vg"]) and np.isfinite(fit.alpha).all()


def test_plot_reads_port_fits(tmp_path):
    """`plot` is exported lazily, as the JAX package's is, and draws from a
    port fit (Manhattan of PIP, QQ, trace)."""
    pytest.importorskip("matplotlib")
    bfile, ss, _ = _fileset(tmp_path, n=300, m=64)
    bt = ht.read_plink(bfile)
    fit = ht.sbrm(ss, ht.ldmat(bt["geno"], map=bt["map"], device="cpu"),
                  method="BayesCpi", niter=40, nburn=20, verbose=False, device="cpu")
    fig, _ = ht.plot.manhattan_pip(fit, bt["map"])
    fig.savefig(tmp_path / "m.png")
    ht.plot.trace(fit, ("Vg", "h2"))
    ht.plot.qqplot(np.linspace(0.01, 1, 50))
    assert (tmp_path / "m.png").stat().st_size > 0
