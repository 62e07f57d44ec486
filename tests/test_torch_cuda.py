"""Tests of the CUDA kernels that need the card.  They carry the ``gpu``
marker and skip without a CUDA device.  They import no JAX, so they run on
the GPU machine (which has none) without the JAX conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from hibayes_tpu_torch.data.ld import DenseLD
from hibayes_tpu_torch.data.sparse_ld import TiledSparseLD, _tiled_matvec
from hibayes_tpu_torch.engine import gibbs as TG
from hibayes_tpu_torch.engine import sgibbs as TSG
from hibayes_tpu_torch.engine.rng import IterNoise
from hibayes_tpu_torch.ops import blockgibbs as TB
from hibayes_tpu_torch.ops import build

pytestmark = pytest.mark.gpu

MODELS = ["BayesRR", "BayesA", "BayesBpi", "BayesCpi", "BayesL", "BayesR"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(model, dev, K=2, n=300, m=80, B=16, int8=True, pad_n="auto"):
    """Batched sweep inputs for K chains on the card: each chain a sparse
    random effect vector and its own pre-sweep noise."""
    rng = np.random.default_rng(3)
    M = rng.binomial(2, 0.3, size=(n, m)).astype(np.int8)
    y = M @ rng.normal(0, 0.1, m) + rng.normal(0, 1, n)
    if model == "BayesR":
        nf, pi, fold = 4, np.array([0.95, 0.02, 0.02, 0.01]), np.array([0.0, 1e-4, 1e-3, 1e-2])
    else:
        nf, fold = 2, None
        pi = (np.array([0.0, 1.0]) if model in ("BayesRR", "BayesA", "BayesL")
              else np.array([0.95, 0.05]))
    data = TG.prepare_gibbs_data(y, M if int8 else M.astype(np.float32), block=B,
                                 fold=fold, geno_dtype="int8" if int8 else None,
                                 pad_n=pad_n, device=dev)
    pr = TG.resolve_priors(y, float(data.vx.sum()), pi[0], nr=0)
    spec = TG.GibbsSpec(
        model=model, n=n, m=m, m_pad=int(data.xpx.shape[0]), block=B, nc=0,
        nlevels=(), n_fold=nf, niter=10, nburn=5, thin=5,
        nvar0=int((data.vx[:m] == 0).sum()), dfvara=pr.dfvara, s2vara=pr.s2vara,
        dfvare=pr.dfvare, s2vare=pr.s2vare, s2varg=pr.s2varg,
        lambda_rate0=pr.lambda_rate0)
    st0 = TG.init_state(spec, data, pr, pi)
    cols, consts = [[] for _ in range(9)], []
    for k in range(K):
        gen = torch.Generator(device=dev).manual_seed(k)
        g = torch.where((torch.rand(spec.m_pad, generator=gen, device=dev) < 0.2)
                        & data.real,
                        0.05 * torch.randn(spec.m_pad, generator=gen, device=dev), 0.0)
        st = st0._replace(g=g, yadj=st0.yadj - TG.genotype_matmul(
            data.X_blocks, g[:, None], torch.float32)[:, 0])
        pre = TG._pre_sweep(spec, data, IterNoise(7, k, dev), st)
        consts.append(pre["consts"])
        for c, v in zip(cols, (pre["vei"], g, *pre["rnd"], pre["vargL_in"],
                               pre["yadj"], pre["u"])):
            c.append(v)
    consts_b = {c: torch.stack([cc[c] for cc in consts]) for c in consts[0]}
    return spec, (consts_b, data.X_blocks, data.W_blocks, data.xpx, data.vx,
                  *(torch.stack(c) for c in cols))


def _assert_bar(ref, out):
    """tests/test_pallas_kernel.py:64-76: at most 1% mixture draws flip,
    effects within 5e-5 max|g| where the draws agree, residuals within
    1e-4 max|yadj| when none flips."""
    g_r, g_o = ref[0].cpu().numpy(), out[0].cpu().numpy()
    agree = ref[1].cpu().numpy() == out[1].cpu().numpy()
    assert agree.mean() >= 0.99
    np.testing.assert_allclose(g_o[agree], g_r[agree], rtol=0,
                               atol=5e-5 * (np.abs(g_r).max() + 1e-12))
    if agree.all() and len(ref) > 3:
        y_r, y_o = ref[3].cpu().numpy(), out[3].cpu().numpy()
        np.testing.assert_allclose(y_o, y_r, rtol=0, atol=1e-4 * np.abs(y_r).max() + 1e-6)


@pytest.mark.parametrize("int8", [True, False], ids=["int8", "f32"])
@pytest.mark.parametrize("model", MODELS)
def test_sweep_and_draw_kernels_match_plain(model, int8, dev):
    spec, args = _inputs(model, dev, int8=int8)
    _assert_bar(TB.sweep_mc_plain(spec, *args), TB.sweep_mc(spec, *args))

    consts, X, W, xpx, vx, *per = args
    B, off, nbg = spec.block, 1, 3
    cols = slice(off * B, (off + nbg) * B)
    loc = [a[:, cols] for a in per[:7]]
    out = TB.sweep_mc(spec, consts, X, W, xpx[cols], vx[cols], *loc, per[7],
                      per[8], block_range=(off, nbg))
    ref = TB.sweep_mc_plain(spec, consts, X[off:off + nbg], W[off:off + nbg],
                            xpx[cols], vx[cols], *loc, per[7], per[8])
    _assert_bar(ref, out)

    P = TB.pack_rows(spec, consts, xpx, vx, per[0], per[1], per[2], per[3],
                     per[4], per[6], torch.float32)
    P_b = TB.to_block_layout(P, spec.nblocks, B)[2].contiguous()
    r0 = (per[7] @ X[2].float()).T.contiguous()
    logpi = consts["logpi"][:, :1].T.contiguous()
    dg_k, tr_k = TB.block_draws(spec, logpi, P_b, W[2], r0)
    dg_p, tr_p = TB.block_draws_plain(spec, logpi, P_b, W[2], r0)
    g_old = P_b[:, 1, :]
    _assert_bar((g_old - dg_p, tr_p), (g_old - dg_k, tr_k))


def test_launch_counts(dev):
    """Each wrapper counts its own calls and the library each kernel launch:
    a sweep over nbg blocks is nbg + 1 rows_kernel (one chain) or
    rows_mc_kernel (K >= 2) and nbg draws_kernel launches, and does not
    count as a block_draws call."""
    for K, rows in ((2, "rows_mc_kernel"), (1, "rows_kernel")):
        spec, args = _inputs("BayesCpi", dev, K=K)
        TB.sweep_mc(spec, *args)
        TB.reset_kernel_launches()
        before = (TB.sweep_mc.launches, TB.block_draws.launches)
        TB.sweep_mc(spec, *args)
        nbg = spec.nblocks
        want = {"rows_kernel": 0, "rows_mc_kernel": 0, "draws_kernel": nbg,
                "segment_draws": 0, "segment_update": 0, "tiled_sweep": 0,
                "mme_sweep_kernel": 0}
        want[rows] = nbg + 1
        assert TB.kernel_launches() == want
        assert (TB.sweep_mc.launches, TB.block_draws.launches) == (before[0] + 1, before[1])


@pytest.mark.parametrize("int8", [True, False], ids=["int8", "f32"])
@pytest.mark.parametrize("model", ["BayesCpi", "BayesR"])
def test_k_chain_rows_kernel_matches_plain(model, int8, dev):
    """sweep_mc at K=2 and K=8 (the K-chain rows kernel) against its plain
    version at the kernel bar, and over an offset block range; a second
    launch is bit-identical."""
    for K in (2, 8):
        spec, args = _inputs(model, dev, K=K, int8=int8)
        out = TB.sweep_mc(spec, *args)
        _assert_bar(TB.sweep_mc_plain(spec, *args), out)
        assert all(torch.equal(a, b) for a, b in zip(out, TB.sweep_mc(spec, *args)))
    consts, X, W, xpx, vx, *per = args
    B, off, nbg = spec.block, 1, 3
    cols = slice(off * B, (off + nbg) * B)
    loc = [a[:, cols] for a in per[:7]]
    out = TB.sweep_mc(spec, consts, X, W, xpx[cols], vx[cols], *loc, per[7], per[8],
                      block_range=(off, nbg))
    ref = TB.sweep_mc_plain(spec, consts, X[off:off + nbg], W[off:off + nbg], xpx[cols],
                            vx[cols], *loc, per[7], per[8])
    _assert_bar(ref, out)


def test_k_chain_rows_kernel_chain_does_not_depend_on_k(dev):
    """Chains 0-1 of a K=8 sweep are bit for bit a K=2 sweep of the same
    chains (the kernel's sums do not depend on K; phase C's per-chain sums,
    torch reductions, are left out), at n not a multiple of a tile."""
    spec, args8 = _inputs("BayesR", dev, K=8, n=1000)
    consts, X, W, xpx, vx, *per = args8
    args2 = ({k: v[:2] for k, v in consts.items()}, X, W, xpx, vx, *(a[:2] for a in per))
    out8, out2 = TB.sweep_mc(spec, *args8), TB.sweep_mc(spec, *args2)
    for a, b in zip(out8[:5], out2[:5]):
        assert torch.equal(a[:2], b)


@pytest.mark.parametrize("int8", [True, False], ids=["int8", "f32"])
def test_k_chain_rows_kernel_tiles_of_several_chunks(int8, dev):
    """At n=9,001 (B=128) a K-chain tile spans several chunks of 32 rows and
    the last tile is ragged, so the kernel's walk from chunk to chunk (the
    next chunk's X and yadj loaded while this one is used) is held to the
    plain sweep at K=2 and K=8, bit-identical on a second launch.  The rows
    are left unpadded (ibrm pads them to a multiple of 512)."""
    n = 9001
    for K in (2, 8):
        tile = TB.rows_per_tile(n, dev, K)
        assert tile >= 2 * TB.MC_CHUNK_ROWS and n % tile
        spec, args = _inputs("BayesR", dev, K=K, n=n, m=512, B=128, int8=int8,
                             pad_n=False)
        out = TB.sweep_mc(spec, *args)
        _assert_bar(TB.sweep_mc_plain(spec, *args), out)
        assert all(torch.equal(a, b) for a, b in zip(out, TB.sweep_mc(spec, *args)))


@pytest.mark.parametrize("model", ["BayesCpi", "BayesR"])
def test_k_chain_segment_sweep(model, dev):
    """sweep_s_segment over K=4 chains against its plain version at the
    kernel bar, bit-identical on a second launch; each chain bit for bit
    the single-chain sweep (K=1) of its inputs."""
    spec, data, g, r, P, _, _ = _s_problem(model, "dense", dev)
    gen = torch.Generator(device=dev).manual_seed(9)
    scale = 1.0 + 0.1 * torch.rand((4, 1), generator=gen, device=dev)
    g4, r4 = g[None] * scale, r[None] * scale
    P4 = P[None].expand(4, -1, -1).contiguous()
    seg = data.ld_segs[0]
    out = TB.sweep_s_segment(spec, seg, r4, P4, spec.n)
    plain = TB.sweep_s_segment_plain(spec, seg, r4, P4, spec.n)
    _assert_bar((g4 - plain[0], plain[1], None, plain[2]), (g4 - out[0], out[1], None, out[2]))
    assert all(torch.equal(a, b) for a, b in zip(out, TB.sweep_s_segment(spec, seg, r4, P4,
                                                                         spec.n)))
    for k in range(4):
        one = TB.sweep_s_segment(spec, seg, r4[k], P4[k], spec.n)
        assert all(torch.equal(a[k], b) for a, b in zip(out, one))


def test_chain_batches_on_the_card(dev):
    """ibrm and sbrm with nchains=3 on the card: rhat for Vg and Ve, the
    records of every chain, and two fits with one seed bit for bit."""
    import hibayes_tpu_torch as htt

    rng = np.random.default_rng(5)
    n, m = 600, 256
    M = rng.binomial(2, 0.3, size=(n, m)).astype(np.int8)
    ids = np.array([f"i{k}" for k in range(n)])
    data = {"id": ids, "T1": M[:, :10] @ rng.normal(0, 0.3, 10) + rng.normal(size=n)}
    fits = [htt.ibrm("T1 ~ 1", data=data, M=M, M_id=ids, method="BayesCpi", niter=40,
                     nburn=20, nchains=3, verbose=False, device=dev) for _ in range(2)]
    np.testing.assert_array_equal(fits[0].g["gebv"], fits[1].g["gebv"])
    assert np.isfinite(fits[0].rhat["Vg"]) and np.isfinite(fits[0].rhat["Ve"])
    assert fits[0].MCMCsamples["alpha"].shape == (3 * 4, m)
    spec, data_s, g, r, P, ss, ld = _s_problem("BayesCpi", "dense", dev)
    fit = htt.sbrm(ss, ld, method="BayesCpi", niter=40, nburn=20, nchains=3,
                   verbose=False, device=dev)
    assert np.isfinite(fit.rhat["Ve"]) and fit.MCMCsamples["alpha"].shape == (3 * 4, 600)


def test_cuda_tensor_without_library_raises(monkeypatch, tmp_path, dev):
    """A CUDA tensor never falls back to the plain version: with the kernel
    library unbuildable the wrapper raises."""
    spec, args = _inputs("BayesCpi", dev, K=1)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_nvcc", no_nvcc)
    build.library.cache_clear()
    calls = TB.sweep_mc_plain.calls
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            TB.sweep_mc(spec, *args)
    finally:
        build.library.cache_clear()
    assert TB.sweep_mc_plain.calls == calls


def test_sweep_rejects_mismatched_shapes(dev):
    """Shapes are checked before a pointer reaches the kernel: residuals of
    another length, or per-SNP inputs that do not cover block_range."""
    spec, args = _inputs("BayesR", dev, K=2)
    consts, X, W, xpx, vx, *per = args
    with pytest.raises(ValueError, match="yadj"):
        TB.sweep_mc(spec, consts, X, W, xpx, vx, *per[:7], per[7][:, :-1], per[8])
    with pytest.raises(ValueError, match="packed rows"):
        TB.sweep_mc(spec, *args, block_range=(0, 2))


@pytest.mark.parametrize("int8", [True, False], ids=["int8", "f32"])
def test_ibrm_paths_on_the_card(int8, dev):
    """Row padding (n > 4096), a ragged last block (B=64), GWAS windows and
    unphenotyped individuals through ibrm on the card."""
    import hibayes_tpu_torch as htt

    rng = np.random.default_rng(9)
    n, m = 4300, 200
    M = rng.binomial(2, 0.3, size=(n, m)).astype(np.int8 if int8 else np.float32)
    ids = np.array([f"i{k}" for k in range(n)])
    y = M[:, :20] @ rng.normal(0, 0.3, 20) + rng.normal(size=n)
    data = {"id": ids[:4200], "T1": y[:4200]}
    gmap = {"Chr": np.repeat([1, 2], m // 2), "Pos": np.tile(np.arange(1, m // 2 + 1) * 1e4, 2)}
    fit = htt.ibrm("T1 ~ 1", data=data, M=M, M_id=ids, method="BayesCpi",
                   map=gmap, windsize=2e5, niter=60, nburn=30, block=64,
                   verbose=False, device=dev)
    assert fit.g["gebv"].shape == (n,) and np.isfinite(fit.g["gebv"]).all()
    assert fit.e["e"].shape == (4200,) and 0 < fit.h2 < 1
    wppa = fit.gwas["WPPA"]
    assert ((wppa >= 0) & (wppa < 1)).all() and wppa.max() > 0
    assert np.corrcoef(fit.g["gebv"][:4200], M[:4200, :20] @ np.ones(20))[0, 1] > 0


def test_chain_is_reproducible(dev):
    """One seed, one chain: two fits on the card agree bit for bit (no
    atomics in the sweep's partial sums or the factor updates)."""
    import hibayes_tpu_torch as htt

    rng = np.random.default_rng(5)
    n, m = 600, 256
    M = rng.binomial(2, 0.3, size=(n, m)).astype(np.int8)
    ids = np.array([f"i{k}" for k in range(n)])
    data = {"id": ids, "T1": M[:, :10] @ rng.normal(0, 0.3, 10) + rng.normal(size=n),
            "f": rng.choice(["a", "b", "c"], n)}
    fits = [htt.ibrm("T1 ~ (1|f)", data=data, M=M, M_id=ids, method="BayesR",
                     niter=30, nburn=10, verbose=False, device=dev) for _ in range(2)]
    np.testing.assert_array_equal(fits[0].g["gebv"], fits[1].g["gebv"])
    assert fits[0].Vg == fits[1].Vg and fits[0].Vr[0] == fits[1].Vr[0]


# ---------------------------------------------------------------------------
# summary-level sweeps
# ---------------------------------------------------------------------------


def _s_problem(model, layout, dev, m=600, rho=0.8):
    """A summary problem on the card: LD rho^|i-j|, dense (B=64) or as tiles
    of 128 in a 3-tile band (masked slots at the ends), statistics
    BETA = LD b; a mid-run state and one iteration's packed rows."""
    idx = torch.arange(m, device=dev, dtype=torch.float64)
    R = (rho ** (idx[:, None] - idx[None, :]).abs()).float()
    if layout == "dense":
        ld, block = DenseLD(values=R), 64
    else:
        T, nbr = 128, -(-m // 128)
        Rp = torch.zeros((nbr * T, nbr * T), device=dev)
        Rp[:m, :m] = R
        band = (idx[:, None] // T - idx[None, :] // T).abs() <= 1
        Rp[:m, :m] *= band
        ld = TiledSparseLD.from_dense(Rp[:m, :m].cpu().numpy(), tile=T, dtype=np.float32)
        ld.tiles = torch.as_tensor(ld.tiles, device=dev)
        block = T
    rng = np.random.default_rng(4)
    b = np.where(rng.random(m) < 0.05, rng.normal(0, 0.1, m), 0.0)
    beta = (R.double() @ torch.as_tensor(b, device=dev)).cpu().numpy()
    ss = np.column_stack([np.full(m, 0.3), beta, np.full(m, 0.01), np.full(m, 1e4)])
    pi = (np.array([0.95, 0.02, 0.02, 0.01]) if model == "BayesR"
          else np.array([0.0, 1.0]) if model in ("BayesRR", "BayesA", "BayesL")
          else np.array([0.95, 0.05]))
    fold = np.array([0.0, 1e-4, 1e-3, 1e-2]) if model == "BayesR" else None
    data, n, vary, nvar0, seg_sizes, seg_real = TSG.prepare_sgibbs_data(
        ss, ld, fold=fold, block=block, device=dev)
    pr = TG.resolve_priors(None, float(ld.diag.sum()), pi[0], nr=0, vary=vary)
    spec = TG.GibbsSpec(
        model=model, n=n, m=m, m_pad=int(sum(seg_sizes)), block=block, nc=0,
        nlevels=(), n_fold=len(pi), niter=10, nburn=5, thin=5, nvar0=nvar0,
        dfvara=pr.dfvara, s2vara=pr.s2vara, dfvare=pr.dfvare, s2vare=pr.s2vare,
        s2varg=pr.s2varg, lambda_rate0=pr.lambda_rate0, vargl_strict_pos=True,
        real_excl_nvar0=True, reject_guard=layout == "tiled", vary=vary,
        seg_sizes=seg_sizes, seg_real=seg_real)
    gen = torch.Generator(device=dev).manual_seed(2)
    g = torch.where((torch.rand(spec.m_pad, generator=gen, device=dev) < 0.2) & data.real,
                    0.05 * torch.randn(spec.m_pad, generator=gen, device=dev), 0.0)
    if layout == "dense":
        ldg = data.ld_segs[0] @ g
    else:
        ldg = _tiled_matvec(data.ld_tiles, data.ld_cols, data.ld_valid, g)
    st = TSG.init_s_state(spec, data, pr, pi)._replace(g=g, r_hat=data.xy - n * ldg, it=2)
    P = TSG._s_pre_sweep(spec, data, IterNoise(3, 2, dev), st)["P"]
    return spec, data, g, st.r_hat, P, ss, ld


def _s_sweep(kind, spec, data, r, P):
    if kind == "dense":
        return TB.sweep_s_segment(spec, data.ld_segs[0], r, P, spec.n)
    return TB.sweep_s_tiled(spec, data.ld_tiles, data.ld_cols, data.ld_valid, r, P,
                            spec.n)


@pytest.mark.parametrize("layout", ["dense", "tiled"])
@pytest.mark.parametrize("model", MODELS)
def test_summary_kernels_match_plain(model, layout, dev):
    """Each summary sweep against its plain version at the kernel bar (r_hat
    for the residual), and bit-identical on a second launch."""
    spec, data, g, r, P, _, _ = _s_problem(model, layout, dev)
    plain = (TB.sweep_s_segment_plain(spec, data.ld_segs[0], r, P, spec.n)
             if layout == "dense" else
             TB.sweep_s_tiled_plain(spec, data.ld_tiles, data.ld_cols, data.ld_valid,
                                    r, P, spec.n))
    out, again = _s_sweep(layout, spec, data, r, P), _s_sweep(layout, spec, data, r, P)
    _assert_bar((g - plain[0], plain[1], None, plain[2]),
                (g - out[0], out[1], None, out[2]))
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    if layout == "tiled":
        assert int(out[3]) == int(plain[3])


def test_summary_launch_counts(dev):
    """A segment sweep over nb blocks is nb segment_draws and nb
    segment_update launches; a tiled sweep over any number of rows is one
    tiled_sweep launch; each wrapper counts one call."""
    for layout, key in (("dense", "segment"), ("tiled", "tiled")):
        spec, data, g, r, P, _, _ = _s_problem("BayesCpi", layout, dev)
        TB.reset_kernel_launches()
        before = (TB.sweep_s_segment.launches, TB.sweep_s_tiled.launches)
        _s_sweep(layout, spec, data, r, P)
        nb = spec.m_pad // spec.block
        counts = TB.kernel_launches()
        if key == "segment":
            assert (counts["segment_draws"], counts["segment_update"]) == (nb, nb)
            assert TB.sweep_s_segment.launches == before[0] + 1
            assert sum(counts.values()) == 2 * nb
        else:
            assert counts["tiled_sweep"] == 1 and nb > 1
            assert TB.sweep_s_tiled.launches == before[1] + 1
            assert sum(counts.values()) == 1


def test_summary_sweeps_refuse_bad_inputs(dev):
    """float64 on the card raises TypeError (the kernels take float32), a
    packed-row array of the wrong height raises ValueError, and sbrm refuses
    dtype=float64 on the card."""
    import hibayes_tpu_torch as htt

    spec, data, g, r, P, ss, ld = _s_problem("BayesCpi", "tiled", dev)
    with pytest.raises(TypeError, match="float32"):
        _s_sweep("tiled", spec, data, r.double(), P)
    with pytest.raises(ValueError, match="packed rows"):
        _s_sweep("tiled", spec, data, r, P[:-1])
    spec_d, data_d, _, r_d, P_d, _, _ = _s_problem("BayesCpi", "dense", dev)
    with pytest.raises(TypeError, match="float32"):
        _s_sweep("dense", spec_d, data_d._replace(ld_segs=(data_d.ld_segs[0].double(),)),
                 r_d, P_d)
    with pytest.raises(TypeError, match="float32"):
        htt.sbrm(ss, ld, niter=20, nburn=10, dtype=torch.float64, verbose=False,
                 device=dev)


@pytest.mark.parametrize("layout", ["dense", "tiled"])
def test_sbrm_chain_is_reproducible(layout, dev):
    """One seed, one summary chain on the card: two fits agree bit for bit
    (the scatter and update kernels own distinct rows; no atomics)."""
    import hibayes_tpu_torch as htt

    _, _, _, _, _, ss, ld = _s_problem("BayesR" if layout == "dense" else "BayesCpi",
                                       layout, dev)
    kw = dict(method="BayesCpi", niter=30, nburn=10, verbose=False, device=dev)
    fits = [htt.sbrm(ss, ld.values if layout == "dense" else ld, **kw) for _ in range(2)]
    np.testing.assert_array_equal(fits[0].alpha, fits[1].alpha)
    assert fits[0].Vg == fits[1].Vg and np.isfinite(fits[0].h2)


# ---------------------------------------------------------------------------
# single-step epsilon sweep
# ---------------------------------------------------------------------------


def _pedigree(nfound, nkid, seed):
    rng = np.random.default_rng(seed)
    ids = np.array([f"p{k}" for k in range(nfound + nkid)])
    sires = np.array(["0"] * nfound + [ids[rng.integers(0, nfound + k)] for k in range(nkid)])
    dams = np.array(["0"] * nfound + [ids[rng.integers(0, nfound + k)] for k in range(nkid)])
    return ids, sires, dams


def _mme_problem(T, dev, q=710, seed=3):
    """The RCM-ordered A-inverse(nn) of a pedigree (q non-genotyped sites,
    q not a multiple of T, so the last block has padded sites), packed in
    blocks of T on the card, with counts, a right-hand side, normals and a
    mid-run x; returns (layout, counts, scale, ve, z, x, res, q)."""
    from hibayes_tpu_torch.data.pedigree import make_ainv, make_ped, rcm_permutation

    rng = np.random.default_rng(seed)
    ids, sires, dams = _pedigree(100, q + 150, seed)
    _, s_idx, d_idx = make_ped(ids, sires, dams)
    Ai = make_ainv(s_idx, d_idx).tocsr()
    ng = np.sort(rng.choice(Ai.shape[0], q, replace=False))
    nn = Ai[ng].tocsc()[:, ng]
    perm = rcm_permutation(nn)
    nn = nn[perm][:, perm]
    sp_t, qp = TG._build_epsl_sparse(nn, T, torch.float32, dev)
    assert q % T and qp > q
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    pad = lambda a: np.concatenate([a, np.zeros(qp - q)])
    counts = f(pad(rng.integers(0, 3, q)))
    z, x, b = (f(pad(rng.normal(0, s, q))) for s in (1.0, 0.3, 1.0))
    scale, ve = f(0.7), f(1.3)
    res = b - scale * TG._epsl_matvec(sp_t, x) - counts * x
    return sp_t, counts, scale, ve, z, x, res, q


@pytest.mark.parametrize("T", [64, 128, 20])
def test_mme_sweep_matches_plain(T, dev):
    """The epsilon sweep kernel against its plain version on the card (T=64
    and 128, and 20, not a multiple of 8): effects within 5e-5 max|x| (the
    kernel bar of chip_smoke.py), padded tail sites frozen, and a second
    launch bit-identical.  Also its first 3 blocks alone (the layout and
    vectors cut to them)."""
    sp_t, counts, scale, ve, z, x, res, q = _mme_problem(T, dev)
    outs = [TB.mme_sweep(sp_t, counts, scale, ve, z, x, res) for _ in range(2)]
    ref = TB.mme_sweep_plain(sp_t, counts, scale, ve, z, x, res)
    torch.cuda.synchronize()
    xk, xp = outs[0][0].cpu().numpy(), ref[0].cpu().numpy()
    np.testing.assert_allclose(xk, xp, rtol=0, atol=5e-5 * np.abs(xp).max())
    assert (xk[q:] == 0).all() and not np.array_equal(xk[:q], x[:q].cpu().numpy())
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    part = sp_t._replace(diag_blocks=sp_t.diag_blocks[:3], blk_ptr=sp_t.blk_ptr[:4])
    args = (part, counts[:3 * T], scale, ve, z[:3 * T], x[:3 * T], res)
    (xk3, rk3), (xp3, rp3) = (tuple(t.cpu().numpy() for t in f(*args))
                              for f in (TB.mme_sweep, TB.mme_sweep_plain))
    assert xk3.shape == (3 * T,)
    np.testing.assert_allclose(xk3, xp3, rtol=0, atol=5e-5 * np.abs(xp3).max())
    # the residual at chip_smoke.py's bar
    np.testing.assert_allclose(rk3, rp3, rtol=0, atol=1e-4 * np.abs(rp3).max() + 1e-6)


def test_mme_sweep_launch_count_and_refusals(dev):
    """One sweep is one mme_sweep launch, counted by the library and by the
    wrapper; float64 raises TypeError and a block of more than 128 sites
    ValueError, before any launch."""
    sp_t, counts, scale, ve, z, x, res, _ = _mme_problem(64, dev)
    TB.mme_sweep(sp_t, counts, scale, ve, z, x, res)
    TB.reset_kernel_launches()
    before = TB.mme_sweep.launches
    TB.mme_sweep(sp_t, counts, scale, ve, z, x, res)
    counts_k = TB.kernel_launches()
    assert counts_k["mme_sweep_kernel"] == 1 and sum(counts_k.values()) == 1
    assert TB.mme_sweep.launches == before + 1
    with pytest.raises(TypeError, match="float32"):
        TB.mme_sweep(sp_t, counts, scale, ve, z, x, res.double())
    big = sp_t._replace(diag_blocks=torch.zeros((1, 136, 136), device=dev))
    with pytest.raises(ValueError, match="at most"):
        TB.mme_sweep(big, counts[:136], scale, ve, z[:136], x[:136], res)
    assert TB.kernel_launches()["mme_sweep_kernel"] == 1


@pytest.mark.parametrize("impute", ["pcg", "direct"])
def test_ssbrm_on_the_card_is_reproducible(impute, dev):
    """ssbrm on the card (imputation, J and epsilon through mme_sweep, the
    SNP sweep through sweep_mc): two fits with one seed agree bit for bit,
    every GEBV is finite, and no plain sweep ran."""
    import hibayes_tpu_torch as htt

    rng = np.random.default_rng(12)
    ids, sires, dams = _pedigree(150, 1350, 4)
    gid = ids[np.sort(rng.choice(len(ids), 400, replace=False))]
    M = rng.binomial(2, 0.3, size=(400, 300)).astype(np.int8)
    phe = ids[rng.choice(len(ids), 600, replace=False)]
    data = {"id": phe, "y": rng.normal(size=600)}
    plain = TB.mme_sweep_plain.calls + TB.sweep_mc_plain.calls
    fits = [htt.ssbrm("y ~ 1", data=data, M=torch.as_tensor(M, device=dev), M_id=gid,
                      pedigree={"id": ids, "sire": sires, "dam": dams}, niter=30,
                      nburn=10, verbose=False, impute=impute, chunk_cols=128, device=dev)
            for _ in range(2)]
    assert TB.mme_sweep_plain.calls + TB.sweep_mc_plain.calls == plain
    np.testing.assert_array_equal(fits[0].g["gebv"], fits[1].g["gebv"])
    assert fits[0].Veps == fits[1].Veps and fits[0].J == fits[1].J
    assert len(fits[0].g["id"]) == 1500 and np.isfinite(fits[0].g["gebv"]).all()
    assert np.isfinite(fits[0].Veps) and 0 < fits[0].h2 < 1


# ---------------------------------------------------------------------------
# the redesigned K-chain rows kernel and the persistent tiled sweep
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [4096, 9001, 50_176])
@pytest.mark.parametrize("K", [2, 3, 4, 5, 8, 64])
def test_k_chain_sweep_shapes(K, n, dev):
    """sweep_mc at K chains against its plain version at the kernel bar, over
    the whole range and an offset block range, bit-identical on a second
    launch; n=9,001 leaves the last tile ragged and its chunk partial."""
    spec, args = _inputs("BayesR" if K % 2 else "BayesCpi", dev, K=K, n=n, m=384, B=128,
                         pad_n=False)
    out = TB.sweep_mc(spec, *args)
    _assert_bar(TB.sweep_mc_plain(spec, *args), out)
    assert all(torch.equal(a, b) for a, b in zip(out, TB.sweep_mc(spec, *args)))
    consts, X, W, xpx, vx, *per = args
    B, off, nbg = spec.block, 1, 2
    cols = slice(off * B, (off + nbg) * B)
    loc = [a[:, cols] for a in per[:7]]
    out = TB.sweep_mc(spec, consts, X, W, xpx[cols], vx[cols], *loc, per[7], per[8],
                      block_range=(off, nbg))
    ref = TB.sweep_mc_plain(spec, consts, X[off:off + nbg], W[off:off + nbg], xpx[cols],
                            vx[cols], *loc, per[7], per[8])
    _assert_bar(ref, out)


@pytest.mark.parametrize("n", [4096, 9001])
def test_k_chain_sweep_chains_0_7_of_64(n, dev):
    """Chains 0-7 of a K=64 sweep are bit for bit a K=8 sweep of the same
    chains, and chains 0-3 of K=8 a K=4 sweep's (another register-tile
    shape), for the kernel's outputs (phase C's per-chain sums, torch
    reductions, left out)."""
    spec, args64 = _inputs("BayesCpi", dev, K=64, n=n, m=256, B=128, pad_n=False)
    consts, X, W, xpx, vx, *per = args64
    sub = lambda k: ({c: v[:k] for c, v in consts.items()}, X, W, xpx, vx,
                     *(a[:k] for a in per))
    out = {K: TB.sweep_mc(spec, *(args64 if K == 64 else sub(K))) for K in (64, 8, 4)}
    for big, small in ((64, 8), (8, 4)):
        for a, b in zip(out[big][:5], out[small][:5]):
            assert torch.equal(a[:small], b)


def _tiled_layout(data, kind, dev, seed=0):
    """cols/valid of a summary problem's 3-tile band made into a band with
    gaps (some off-diagonal slots masked) or columns that are not a band
    (each row's off-diagonal slots point at random other blocks); the tiles
    stay.  Invalid slots point at the row's own block."""
    rng = np.random.default_rng(seed)
    cols = data.ld_cols.cpu().numpy().copy()
    valid = data.ld_valid.cpu().numpy().copy()
    nbr, K = cols.shape
    rows = np.arange(nbr)[:, None].repeat(K, 1)
    if kind == "gaps":
        valid[:, 1:] &= rng.random((nbr, K - 1)) < 0.6
    elif kind == "nonband":
        for i in range(nbr):
            others = rng.permutation(np.delete(np.arange(nbr), i))[:K - 1]
            cols[i, 1:] = others
            valid[i, 1:] = rng.random(K - 1) < 0.8
    cols = np.where(valid, cols, rows)
    return (torch.as_tensor(cols, dtype=torch.int32, device=dev),
            torch.as_tensor(valid, device=dev))


@pytest.mark.parametrize("guard", [True, False], ids=["guard", "noguard"])
@pytest.mark.parametrize("kind", ["band", "gaps", "nonband"])
@pytest.mark.parametrize("model", ["BayesCpi", "BayesR"])
def test_tiled_sweep_layouts(model, kind, guard, dev):
    """The one-launch tiled sweep against its plain version at the kernel bar
    on a band, a band with gaps and columns that are not a band, with the
    guard on and off; the guard's rejection counts equal the plain
    version's; a second launch is bit-identical; one tiled_sweep launch."""
    spec, data, g, r, P, _, _ = _s_problem(model, "tiled", dev, m=1500)
    cols, valid = ((data.ld_cols, data.ld_valid) if kind == "band"
                   else _tiled_layout(data, kind, dev))
    if not guard:
        spec = dataclasses.replace(spec, reject_guard=False)
        P = P[:TB.n_rows(spec)].contiguous()
    assert TB.guard_on(spec) == guard
    args = (spec, data.ld_tiles, cols, valid, r, P, spec.n)
    TB.reset_kernel_launches()
    out = TB.sweep_s_tiled(*args)
    assert TB.kernel_launches()["tiled_sweep"] == 1
    plain = TB.sweep_s_tiled_plain(*args)
    _assert_bar((g - plain[0], plain[1], None, plain[2]), (g - out[0], out[1], None, out[2]))
    assert int(out[3]) == int(plain[3])
    again = TB.sweep_s_tiled(*args)
    assert all(torch.equal(a, b) for a, b in zip(out, again))


def test_tiled_sweep_guard_fires(dev):
    """At a lowered vary the guard rejects draws: the kernel's count equals
    the plain version's where no draw flips, over many sweeps of one
    schedule (its counters run on from epoch to epoch)."""
    spec, data, g, r, P, _, _ = _s_problem("BayesCpi", "tiled", dev, m=1500)
    spec = dataclasses.replace(spec, vary=spec.vary * 1e-3)
    args = (spec, data.ld_tiles, data.ld_cols, data.ld_valid, r, P, spec.n)
    outs = [TB.sweep_s_tiled(*args) for _ in range(5)]
    plain = TB.sweep_s_tiled_plain(*args)
    assert int(plain[3]) > 0
    _assert_bar((g - plain[0], plain[1], None, plain[2]),
                (g - outs[0][0], outs[0][1], None, outs[0][2]))
    assert int(outs[0][3]) == int(plain[3])
    for o in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(outs[0], o))


def test_chain_latency_and_stamps(dev):
    """The measurement entry points run: the draw chain alone, and the
    stamps of a K-chain and a tiled sweep, ordered in time."""
    spec, data, g, r, P, _, _ = _s_problem("BayesCpi", "tiled", dev)
    B = spec.block
    W = spec.n * data.ld_tiles[0, 0]
    Pb = P[:, :B].T.contiguous()
    cyc = TB.chain_latency(spec, W, Pb, r[:B], reps=10, vary=spec.vary)
    assert int(cyc) > 0
    stamps = torch.zeros(4 * (spec.m_pad // B) + 4, dtype=torch.int64, device=dev)
    TB.sweep_s_tiled(spec, data.ld_tiles, data.ld_cols, data.ld_valid, r, P, spec.n,
                     stamps=stamps)
    st = stamps.cpu().numpy()
    nbr = spec.m_pad // B
    rows = st[:4 * nbr].reshape(nbr, 4)
    assert (np.diff(rows, axis=1) >= 0).all() and st[4 * nbr + 1] > st[4 * nbr]
    spec_i, args = _inputs("BayesCpi", dev, K=4, n=2000, m=256, B=128)
    nbg = spec_i.nblocks
    stamps = torch.zeros(16 * (nbg + 1), dtype=torch.int64, device=dev)
    TB.sweep_mc(spec_i, *args, stamps=stamps)
    st = stamps.cpu().numpy().reshape(nbg + 1, 16)
    assert (st[:nbg, 3:8] > 0).all() and (np.diff(st[:nbg, 3:8], axis=1) >= 0).all()
    assert (np.diff(st[:nbg, 8:15], axis=1) >= 0).all()
