"""Tests of the CUDA kernels that need the card.  They carry the ``gpu``
marker and skip without a CUDA device.  They import no JAX, so they run on
the GPU machine (which has none) without the JAX conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q
"""

import contextlib
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
from hibayes_tpu_torch.utils import spans

pytestmark = pytest.mark.gpu

MODELS = ["BayesRR", "BayesA", "BayesBpi", "BayesCpi", "BayesL", "BayesR"]
# the port's sweep kernels, by their names in the profiler's traces
PORT_KERNELS = ("sweep1_kernel", "rows_mc_kernel", "draws_kernel", "seg_sweep_kernel",
                "tiled_sweep_kernel", "mme_sweep_kernel")


@contextlib.contextmanager
def launches():
    """The launches of each of the port's sweep kernels inside the block: a
    dict of PORT_KERNELS, filled as the block ends from the span store's
    counters ``ops.launch.<kernel>``, which record while a torch.profiler
    does (the profiler's own kernel records lose some on the card after
    heavy device work)."""
    out = {}
    spans()   # ends the store's last session: the block's spans start a new one
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        yield out
    got = {}
    for rec in spans():
        for name, n in (rec.counts or {}).items():
            got[name] = got.get(name, 0) + n
    out.update((k, got.get("ops.launch." + k, 0)) for k in PORT_KERNELS)


def ops_calls(name: str) -> int:
    """Calls of the ops wrapper ``name`` in the last :func:`launches`
    block: its ``ops.<name>`` spans."""
    return sum(s.name == "ops." + name for s in spans())


def counted(monkeypatch, *names):
    """Calls of the plain versions ``names`` of blockgibbs from here on,
    one entry a call."""
    calls = []
    for name in names:
        real = getattr(TB, name)
        monkeypatch.setattr(TB, name, lambda *a, real=real, **k: calls.append(1) or real(*a, **k))
    return calls


def plain_sweep_mc(*args, C_blocks=None, plans=None, **kw):
    """``sweep_mc_plain`` in the wrapper's place: the keywords that only the
    card's route reads are dropped."""
    return TB.sweep_mc_plain(*args, **kw)


plain_sweep_mc.block_range_in_place = True


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _fold_prior(nf):
    """BayesR's pi and fold variances with nf folds (tests/torch_parity.py's)."""
    if nf == 4:
        return np.array([0.95, 0.02, 0.02, 0.01]), np.array([0.0, 1e-4, 1e-3, 1e-2])
    return (np.array([0.95] + [0.05 / (nf - 1)] * (nf - 1)),
            np.concatenate([[0.0], np.logspace(-5, -2, nf - 1)]))


def _inputs(model, dev, K=2, n=300, m=80, B=16, int8=True, pad_n="auto", nf=4):
    """Batched sweep inputs for K chains on the card: each chain a sparse
    random effect vector and its own pre-sweep noise; BayesR with nf
    folds."""
    rng = np.random.default_rng(3)
    M = rng.binomial(2, 0.3, size=(n, m)).astype(np.int8)
    y = M @ rng.normal(0, 0.1, m) + rng.normal(0, 1, n)
    if model == "BayesR":
        pi, fold = _fold_prior(nf)
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
            data.X_blocks, g[:, None], torch.float32, data.block)[:, 0])
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
    """Kernel launches as the span store counts them: a sweep over nbg
    blocks is one sweep1 launch (one chain, the whole sweep) or nbg + 1
    rows_mc_kernel and nbg draws_kernel launches (K >= 2), one sweep_mc
    call and no block_draws call."""
    for K in (2, 1):
        spec, args = _inputs("BayesCpi", dev, K=K)
        TB.sweep_mc(spec, *args)
        with launches() as got:
            TB.sweep_mc(spec, *args)
        nbg = spec.nblocks
        want = dict.fromkeys(PORT_KERNELS, 0)
        if K == 1:
            want["sweep1_kernel"] = 1
        else:
            want.update(rows_mc_kernel=nbg + 1, draws_kernel=nbg)
        assert got == want
        assert (ops_calls("sweep_mc"), ops_calls("block_draws")) == (1, 0)


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
    calls = counted(monkeypatch, "sweep_mc_plain")
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            TB.sweep_mc(spec, *args)
    finally:
        build.library.cache_clear()
    assert not calls


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


def _s_problem(model, layout, dev, m=600, rho=0.8, guard=False, tile=128, block=64, nf=4):
    """A summary problem on the card: LD rho^|i-j|, dense (blocks of
    ``block``) or as tiles of ``tile`` in a 3-tile band (masked slots at the
    ends), statistics BETA = LD b; a mid-run state and one iteration's
    packed rows (BayesR with nf folds).  SBayesS semantics (the guard's rows
    packed) for tiles, and with ``guard`` for the dense segment too."""
    idx = torch.arange(m, device=dev, dtype=torch.float64)
    R = (rho ** (idx[:, None] - idx[None, :]).abs()).float()
    if layout == "dense":
        ld = DenseLD(values=R)
    else:
        T, nbr = tile, -(-m // tile)
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
    pi, fold = (_fold_prior(nf) if model == "BayesR"
                else (np.array([0.0, 1.0]) if model in ("BayesRR", "BayesA", "BayesL")
                      else np.array([0.95, 0.05]), None))
    data, n, vary, nvar0, seg_sizes, seg_real = TSG.prepare_sgibbs_data(
        ss, ld, fold=fold, block=block, device=dev)
    pr = TG.resolve_priors(None, float(ld.diag.sum()), pi[0], nr=0, vary=vary)
    spec = TG.GibbsSpec(
        model=model, n=n, m=m, m_pad=int(sum(seg_sizes)), block=block, nc=0,
        nlevels=(), n_fold=len(pi), niter=10, nburn=5, thin=5, nvar0=nvar0,
        dfvara=pr.dfvara, s2vara=pr.s2vara, dfvare=pr.dfvare, s2vare=pr.s2vare,
        s2varg=pr.s2varg, lambda_rate0=pr.lambda_rate0, vargl_strict_pos=True,
        real_excl_nvar0=True, reject_guard=layout == "tiled" or guard, vary=vary,
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
    """A segment sweep over any number of blocks is one segment_sweep
    launch; a tiled sweep over any number of rows is one tiled_sweep
    launch; each is one call of its wrapper."""
    for layout, key in (("dense", "segment"), ("tiled", "tiled")):
        spec, data, g, r, P, _, _ = _s_problem("BayesCpi", layout, dev)
        with launches() as counts:
            _s_sweep(layout, spec, data, r, P)
        nb = spec.m_pad // spec.block
        if key == "segment":
            assert counts["seg_sweep_kernel"] == 1 and nb > 1
            assert ops_calls("sweep_s_segment") == 1
            assert sum(counts.values()) == 1
        else:
            assert counts["tiled_sweep_kernel"] == 1 and nb > 1
            assert ops_calls("sweep_s_tiled") == 1
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
    """One sweep is one mme_sweep launch as the span store counts it and one
    call of the wrapper; float64 raises TypeError and a block of more than
    128 sites ValueError, before any launch."""
    sp_t, counts, scale, ve, z, x, res, _ = _mme_problem(64, dev)
    TB.mme_sweep(sp_t, counts, scale, ve, z, x, res)
    with launches() as counts_k:
        TB.mme_sweep(sp_t, counts, scale, ve, z, x, res)
    assert counts_k["mme_sweep_kernel"] == 1 and sum(counts_k.values()) == 1
    assert ops_calls("mme_sweep") == 1
    with launches() as refused:
        with pytest.raises(TypeError, match="float32"):
            TB.mme_sweep(sp_t, counts, scale, ve, z, x, res.double())
        big = sp_t._replace(diag_blocks=torch.zeros((1, 136, 136), device=dev))
        with pytest.raises(ValueError, match="at most"):
            TB.mme_sweep(big, counts[:136], scale, ve, z[:136], x[:136], res)
    assert refused["mme_sweep_kernel"] == 0


@pytest.mark.parametrize("T", [64, 20])
def test_k_chain_mme_sweep(T, dev):
    """The K-chain epsilon sweep (K=4, a CTA a chain) in one launch: each
    chain bit for bit its K=1 launch on its own z, x, residual, scale and
    ve; against the batched plain version at the kernel bar; a second
    launch bit-identical; padded sites frozen."""
    sp_t, counts, scale, ve, z, x, res, q = _mme_problem(T, dev)
    K = 4
    f = torch.arange(K, device=dev, dtype=torch.float32)
    Z = torch.stack([z.roll(3 * k) for k in range(K)])
    Z[:, q:] = 0
    X = x[None] * (1 + 0.1 * f[:, None])
    Rs = res[None] * (1 - 0.05 * f[:, None])
    S, V = scale * (1 + 0.2 * f), ve * (1 + 0.3 * f)
    with launches() as got:
        out = TB.mme_sweep(sp_t, counts, S, V, Z, X, Rs)
    assert got["mme_sweep_kernel"] == 1
    assert out[0].shape == X.shape and out[1].shape == Rs.shape
    again = TB.mme_sweep(sp_t, counts, S, V, Z, X, Rs)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    plain = TB.mme_sweep_plain(sp_t, counts, S, V, Z, X, Rs)
    for k in range(K):
        one = TB.mme_sweep(sp_t, counts, S[k], V[k], Z[k], X[k], Rs[k])
        assert torch.equal(out[0][k], one[0]) and torch.equal(out[1][k], one[1])
        xk, xp = out[0][k].cpu().numpy(), plain[0][k].cpu().numpy()
        np.testing.assert_allclose(xk, xp, rtol=0, atol=5e-5 * np.abs(xp).max())
        assert (xk[q:] == 0).all()


@pytest.mark.parametrize("impute", ["pcg", "direct"])
def test_ssbrm_on_the_card_is_reproducible(impute, dev, monkeypatch):
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
    plain = counted(monkeypatch, "mme_sweep_plain", "sweep_mc_plain")
    fits = [htt.ssbrm("y ~ 1", data=data, M=torch.as_tensor(M, device=dev), M_id=gid,
                      pedigree={"id": ids, "sire": sires, "dam": dams}, niter=30,
                      nburn=10, verbose=False, impute=impute, chunk_cols=128, device=dev)
            for _ in range(2)]
    assert not plain
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
    with launches() as got:
        out = TB.sweep_s_tiled(*args)
    assert got["tiled_sweep_kernel"] == 1
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


@pytest.mark.parametrize("low", [False, True], ids=["vary", "lowvary"])
@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("model", ["BayesCpi", "BayesR", "BayesL"])
def test_k_chain_tiled_sweep(model, tile, low, dev):
    """The K-chain tiled sweep (K=4: a drawer CTA a chain, each tile read
    once for all chains) in one launch: each chain bit for bit its K=1
    launch on its own r_hat and packed rows; against the batched plain
    version at the kernel bar, the guard's counts per chain equal the plain
    version's (at the chain's vary and a lowered one where it rejects); a
    second launch bit-identical."""
    spec, data, g, r, P, _, _ = _s_problem(model, "tiled", dev, m=1500, tile=tile)
    if low:
        spec = dataclasses.replace(spec, vary=spec.vary * 1e-3)
    K = 4
    st = TSG.init_s_state(spec, data, *_s_priors_pi(spec, data, model))._replace(
        g=g, r_hat=r, it=2)
    Ps = torch.stack([P] + [TSG._s_pre_sweep(spec, data, IterNoise(4 + k, 2, dev), st)["P"]
                            for k in range(K - 1)])
    Rs = r[None].expand(K, -1).contiguous()
    lay = (data.ld_tiles, data.ld_cols, data.ld_valid)
    tally = torch.zeros((K, 2), dtype=torch.int64, device=dev)
    with launches() as got:
        out = TB.sweep_s_tiled(spec, *lay, Rs, Ps, spec.n, tally=tally)
    assert got["tiled_sweep_kernel"] == 1
    again = TB.sweep_s_tiled(spec, *lay, Rs, Ps, spec.n)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    p_tally = torch.zeros((K, 2), dtype=torch.int64, device=dev)
    plain = TB.sweep_s_tiled_plain(spec, *lay, Rs, Ps, spec.n, tally=p_tally)
    for k in range(K):
        one = TB.sweep_s_tiled(spec, *lay, Rs[k], Ps[k], spec.n)
        assert all(torch.equal(a[k], b) for a, b in zip(out, one))
        _assert_bar((g - plain[0][k], plain[1][k], None, plain[2][k]),
                    (g - out[0][k], out[1][k], None, out[2][k]))
    assert torch.equal(tally, p_tally)
    if low and TB.guard_on(spec):
        assert int(tally[:, 0].sum()) > 0


def _s_priors_pi(spec, data, model):
    pi = (np.array([0.95, 0.02, 0.02, 0.01]) if model == "BayesR"
          else np.array([0.0, 1.0]) if model in ("BayesRR", "BayesA", "BayesL")
          else np.array([0.95, 0.05]))
    pr = TG.resolve_priors(None, float(data.vx.sum()), pi[0], nr=0, vary=spec.vary)
    return pr, pi


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


# ---------------------------------------------------------------------------
# the persistent one-chain sweep and the redesigned draw chain
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", ["BayesCpi", "BayesR"])
@pytest.mark.parametrize("B", [64, 128])
@pytest.mark.parametrize("int8", [True, False], ids=["int8", "f32"])
@pytest.mark.parametrize("n", [4096, 9001, 50_176, 131_072])
def test_one_chain_sweep_shapes(n, int8, B, model, dev):
    """sweep_mc at K = 1 (one sweep1 launch, the right-hand side one block
    ahead) against its plain version at the kernel bar, over the whole
    range and an offset block range, and bit-identical on a second launch;
    n=9,001 unpadded leaves the last row tile ragged; at n=50,176 every row
    CTA holds three X tiles (int8), at n=131,072 X_{b+1} is read from
    global memory."""
    spec, args = _inputs(model, dev, K=1, n=n, m=384, B=B, int8=int8, pad_n=False)
    with launches() as got:
        out = TB.sweep_mc(spec, *args)
    assert got["sweep1_kernel"] == 1
    _assert_bar(TB.sweep_mc_plain(spec, *args), out)
    assert all(torch.equal(a, b) for a, b in zip(out, TB.sweep_mc(spec, *args)))
    consts, X, W, xpx, vx, *per = args
    off, nbg = 1, 2
    cols = slice(off * B, (off + nbg) * B)
    loc = [a[:, cols] for a in per[:7]]
    out = TB.sweep_mc(spec, consts, X, W, xpx[cols], vx[cols], *loc, per[7], per[8],
                      block_range=(off, nbg))
    ref = TB.sweep_mc_plain(spec, consts, X[off:off + nbg], W[off:off + nbg], xpx[cols],
                            vx[cols], *loc, per[7], per[8])
    _assert_bar(ref, out)
    assert all(torch.equal(a, b) for a, b in zip(out, TB.sweep_mc(
        spec, consts, X, W, xpx[cols], vx[cols], *loc, per[7], per[8],
        block_range=(off, nbg))))


@pytest.mark.parametrize("int8,B", [(True, 128), (False, 64), (True, 256)],
                         ids=["int8_B128", "f32_B64", "int8_B256"])
def test_one_chain_sweep_from_mid_sweep(int8, B, dev):
    """A one-chain block range that starts mid-sweep (blocks 3 .. 8 of 10 at
    n=50,176; at B=256, sub-blocks of 128): its first block's right-hand
    side takes no correction, the others C indexed globally; against the
    plain version at the bar, bit-identical on a second launch, and the same
    with the cross-Grams passed as prepare_gibbs_data makes them."""
    spec, args = _inputs("BayesR", dev, K=1, n=50_176, m=10 * B, B=B, int8=int8, pad_n=False)
    consts, X, W, xpx, vx, *per = args
    off, nbg = 3, 6
    cols = slice(off * B, (off + nbg) * B)
    part = (consts, X, W, xpx[cols], vx[cols], *(a[:, cols] for a in per[:7]), per[7], per[8])
    out = TB.sweep_mc(spec, *part, block_range=(off, nbg))
    S = X.shape[0] // 10
    ref = TB.sweep_mc_plain(spec, consts, X[off * S:(off + nbg) * S], W[off * S:(off + nbg) * S],
                            *part[3:])
    _assert_bar(ref, out)
    again = TB.sweep_mc(spec, *part, block_range=(off, nbg), C_blocks=TB.cross_grams(X))
    assert all(torch.equal(a, b) for a, b in zip(out, again))


def test_one_chain_iteration_emulated_on_four_shards(dev, monkeypatch):
    """One chain's iteration under the concurrent schedule emulated on four
    shards (GibbsSpec(emulate_shards=4): four sweep1 launches of a quarter
    of the blocks each, from the round-start residual, with the cross-Grams
    of GibbsData) against the same iteration through the plain sweep, at
    the kernel bar; bit-identical on a second run."""
    rng = np.random.default_rng(21)
    n, m, B = 6000, 16 * 64, 64
    M = rng.binomial(2, 0.3, size=(n, m)).astype(np.int8)
    y = M[:, :40] @ rng.normal(0, 0.2, 40) + rng.normal(size=n)
    pi, fold = _fold_prior(4)
    data = TG.prepare_gibbs_data(y, M, block=B, fold=fold, geno_dtype="int8",
                                 nblocks_multiple=4, device=dev)
    pr = TG.resolve_priors(y, float(data.vx.sum()), pi[0], nr=0)
    spec = TG.GibbsSpec(
        model="BayesR", n=int(data.y.shape[0]), n_real=n, m=m, m_pad=int(data.xpx.shape[0]),
        block=B, nc=0, nlevels=(), n_fold=4, niter=10, nburn=5, thin=5,
        nvar0=int((data.vx[:m] == 0).sum()), dfvara=pr.dfvara, s2vara=pr.s2vara,
        dfvare=pr.dfvare, s2vare=pr.s2vare, s2varg=pr.s2varg,
        lambda_rate0=pr.lambda_rate0, shard_schedule="concurrent", emulate_shards=4)
    state = TG.init_state(spec, data, pr, pi)
    for _ in range(3):
        state = TG.one_iteration(spec, data, 1, state)
    with launches() as got:
        kern = TG.one_iteration(spec, data, 1, state)
    assert got["sweep1_kernel"] == 4
    assert all(torch.equal(a, b) for a, b in zip(
        kern, TG.one_iteration(spec, data, 1, state)) if isinstance(a, torch.Tensor))
    monkeypatch.setattr(TB, "sweep_mc", plain_sweep_mc)
    plain = TG.one_iteration(spec, data, 1, state)
    monkeypatch.undo()
    _assert_bar((plain.g, plain.track, None, plain.yadj), (kern.g, kern.track, None, kern.yadj))


def test_one_chain_sweeps_of_other_shapes_in_turn(dev):
    """The one-chain sweep's flags, kept in the plans it is given, run on
    from sweep to sweep (by an epoch) and are made anew for a larger tile
    count: sweeps at n=4,096, 50,176 and 4,096 again with one plans dict,
    each repeated, give their first launch's outputs bit for bit."""
    cases = [_inputs("BayesR", dev, K=1, n=n, m=256, B=128, pad_n=False)
             for n in (4096, 50_176)]
    plans = {}
    first = [TB.sweep_mc(spec, *args, plans=plans) for spec, args in cases]
    flags = plans["sweep1_flags"]["flags"]
    for i in (0, 1, 0, 1, 0):
        spec, args = cases[i]
        for _ in range(2):
            assert all(torch.equal(a, b) for a, b in zip(
                first[i], TB.sweep_mc(spec, *args, plans=plans)))
    assert plans["sweep1_flags"]["flags"] is flags and plans["sweep1_flags"]["epoch"] > 0


@pytest.mark.parametrize("B", [4, 64, 128])
@pytest.mark.parametrize("model", MODELS)
def test_block_draws_under_the_new_chain(model, B, dev):
    """block_draws (draws_kernel, one CTA a chain) at blocks of 4, 64 and 128
    SNPs (lanes that own no SNP, and every lane owning four) against its
    plain version at the bar, bit-identical on a second launch."""
    spec, args = _inputs(model, dev, K=3, n=700, m=2 * B, B=B, pad_n=False)
    consts, X, W, xpx, vx, *per = args
    P = TB.pack_rows(spec, consts, xpx, vx, per[0], per[1], per[2], per[3], per[4], per[6],
                     torch.float32)
    P_b = TB.to_block_layout(P, spec.nblocks, B)[1].contiguous()
    r0 = (per[7] @ X[1].float()).T.contiguous()
    logpi = consts["logpi"][:, :1].T.contiguous()
    dg_k, tr_k = TB.block_draws(spec, logpi, P_b, W[1], r0)
    dg_p, tr_p = TB.block_draws_plain(spec, logpi, P_b, W[1], r0)
    g_old = P_b[:, 1, :]
    _assert_bar((g_old - dg_p, tr_p), (g_old - dg_k, tr_k))
    again = TB.block_draws(spec, logpi, P_b, W[1], r0)
    assert torch.equal(dg_k, again[0]) and torch.equal(tr_k, again[1])


@pytest.mark.parametrize("model", ["BayesCpi", "BayesR"])
def test_guard_out_of_line_path(model, dev):
    """At a lowered vary the guard's retries (the chain's out-of-line path)
    run: the tiled sweep's count of first draws rejected equals the plain
    version's and is positive, the outputs meet the bar, and a second launch
    is bit-identical; the draw chain alone runs the same path."""
    spec, data, g, r, P, _, _ = _s_problem(model, "tiled", dev, m=1500)
    spec = dataclasses.replace(spec, vary=spec.vary * 1e-3)
    args = (spec, data.ld_tiles, data.ld_cols, data.ld_valid, r, P, spec.n)
    out, again = TB.sweep_s_tiled(*args), TB.sweep_s_tiled(*args)
    plain = TB.sweep_s_tiled_plain(*args)
    assert int(plain[3]) > 0
    assert int(out[3]) == int(plain[3])
    _assert_bar((g - plain[0], plain[1], None, plain[2]),
                (g - out[0], out[1], None, out[2]))
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    B = spec.block
    cyc = TB.chain_latency(spec, spec.n * data.ld_tiles[0, 0], P[:, :B].T.contiguous(),
                           r[:B], reps=4, vary=spec.vary)
    assert int(cyc) > 0


def test_one_chain_sweep_stamps(dev):
    """The one-chain sweep's stamps (drawer: chain started, drawn, dg
    published, then block b+1's partials summed and rhs_{b+1} formed; its
    summing warps: flags seen, partials summed; the first rows CTA: waited
    for dg, corrected, formed the partials one block ahead) are ordered in
    time, block after block."""
    spec, args = _inputs("BayesR", dev, K=1, n=9001, m=512, B=128, pad_n=False)
    nbg = spec.nblocks
    stamps = torch.zeros(16 * (nbg + 1), dtype=torch.int64, device=dev)
    TB.sweep_mc(spec, *args, stamps=stamps)
    st = stamps.cpu().numpy().reshape(nbg + 1, 16)
    chain = st[:nbg][:, [2, 6, 3, 7, 4]]
    assert (chain > 0).all() and (np.diff(chain, axis=1) >= 0).all()
    rhs = st[:nbg - 1][:, [3, 15, 7]]   # dg out; the sums and C in; rhs formed
    assert (rhs > 0).all() and (np.diff(rhs, axis=1) >= 0).all()
    sums = st[:nbg - 1][:, [0, 5, 14, 15]]
    assert (sums > 0).all() and (np.diff(sums, axis=1) >= 0).all()
    assert (np.diff(st[:, [8, 9, 11, 10]], axis=1) >= 0).all()
    assert (np.diff(st[:nbg, 3]) > 0).all() and (np.diff(st[:nbg, 0]) > 0).all()
    assert (st[1:, 9] >= st[:nbg, 3]).all()   # a row step starts after dg is published
    # block b+1's partials (row step b) are out before chain b+1 starts
    assert (st[1:nbg - 1, 10] <= st[2:nbg, 2]).all()


# ---------------------------------------------------------------------------
# the redesigned epsilon sweep and the persistent segment sweep
# ---------------------------------------------------------------------------


def _coupled_layout(T, dev, q=None, seed=5):
    """An epsilon layout whose blocks couple to the next, the one after and
    blocks far ahead, with blocks that couple to none, and in-block bands
    (tests/test_torch_sweep_plans.py builds the same on the CPU)."""
    from tests.test_torch_sweep_plans import _coupled

    import scipy.sparse as sps

    q = q or 9 * T - 5
    band = sps.diags([np.full(q - 1, -0.1), np.full(q - 2, -0.05)], [1, 2])
    A = _coupled(q, T, (1, 2, 7), seed=seed, empty=(2, 5)) + band + band.T
    sp_t, qp = TG._build_epsl_sparse(A, T, torch.float32, dev)
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    pad = lambda a: np.concatenate([a, np.zeros(qp - q)])
    counts = f(pad(rng.integers(0, 3, q)))
    z, x, b = (f(pad(rng.normal(0, s, q))) for s in (1.0, 0.3, 1.0))
    scale, ve = f(0.7), f(1.3)
    res = b - scale * TG._epsl_matvec(sp_t, x) - counts * x
    return sp_t, counts, scale, ve, z, x, res, q


@pytest.mark.parametrize("kind", ["pedigree", "coupled"])
@pytest.mark.parametrize("T", [20, 64, 128])
def test_mme_sweep_layouts(T, kind, dev):
    """The epsilon sweep on a pedigree's RCM-ordered layout and on one whose
    blocks couple 1, 2 and 7 blocks ahead (and some to none): against its
    plain version at the bar (x within 5e-5 max|x|, res within 1e-4
    max|res|), bit-identical on a second launch, over the whole layout and
    its first 4 blocks alone."""
    prob = _mme_problem(T, dev) if kind == "pedigree" else _coupled_layout(T, dev)
    sp_t, counts, scale, ve, z, x, res, q = prob
    for cut in (None, 4):
        lay, a = sp_t, (counts, scale, ve, z, x, res)
        if cut is not None:
            lay = sp_t._replace(diag_blocks=sp_t.diag_blocks[:cut], blk_ptr=sp_t.blk_ptr[:cut + 1])
            a = (counts[:cut * T], scale, ve, z[:cut * T], x[:cut * T], res)
        outs = [TB.mme_sweep(lay, *a) for _ in range(2)]
        ref = TB.mme_sweep_plain(lay, *a)
        torch.cuda.synchronize()
        assert all(torch.equal(u, v) for u, v in zip(*outs))
        xk, xp = outs[0][0].cpu().numpy(), ref[0].cpu().numpy()
        np.testing.assert_allclose(xk, xp, rtol=0, atol=5e-5 * np.abs(xp).max())
        rk, rp = outs[0][1].cpu().numpy(), ref[1].cpu().numpy()
        np.testing.assert_allclose(rk, rp, rtol=0, atol=1e-4 * np.abs(rp).max() + 1e-6)


def test_mme_chain_latency_and_stamps(dev):
    """The epsilon sweep's measurement hooks run: the chain alone returns
    cycles, and the stamps of a sweep are filled and ordered in time."""
    sp_t, counts, scale, ve, z, x, res, _ = _mme_problem(64, dev)
    T = 64
    cyc = TB.mme_chain_latency(sp_t.diag_blocks[0], counts[:T], z[:T], scale, ve, res[:T], 10)
    assert int(cyc) > 0
    nbr = sp_t.diag_blocks.shape[0]
    st = torch.zeros(6 * (nbr + 1) + 4, dtype=torch.int64, device=dev)
    out = TB.mme_sweep(sp_t, counts, scale, ve, z, x, res, stamps=st)
    assert all(torch.equal(u, v) for u, v in zip(out, TB.mme_sweep(sp_t, counts, scale, ve,
                                                                    z, x, res)))
    s = st.cpu().numpy()
    b = s[:6 * nbr].reshape(nbr, 6)
    assert (b[:, :3] > 0).all() and (np.diff(b[:, :3], axis=1) >= 0).all()
    assert (np.diff(b[:, 0]) > 0).all() and s[6 * (nbr + 1) + 1] > s[6 * (nbr + 1)]


def _segment_problem(B, K, dev, m=1000, seed=3):
    spec, data, g, r, P, _, _ = _s_problem("BayesCpi" if K % 2 else "BayesR", "dense", dev,
                                           m=m)
    spec = dataclasses.replace(spec, block=B) if B != spec.block else spec
    seg = data.ld_segs[0]
    mc = seg.shape[0]
    if mc % B:
        raise AssertionError("the segment must hold whole blocks")
    gen = torch.Generator(device=dev).manual_seed(seed)
    scale = 1.0 + 0.1 * torch.rand((K, 1), generator=gen, device=dev)
    return spec, seg, g[None] * scale, r[None] * scale, P[None].expand(K, -1, -1).contiguous()


@pytest.mark.parametrize("K", [1, 2, 4, 8, 9])
@pytest.mark.parametrize("B", [64, 128])
def test_segment_sweep_shapes(B, K, dev):
    """The persistent segment sweep at B in {64, 128} and K in {1, 2, 4, 8,
    9} (one and two drawer CTAs; BayesCpi at odd K, BayesR at even):
    against its plain version at the bar, bit-identical on a second launch,
    and chain k bit for bit its K=1 launch."""
    spec, seg, g, r, P = _segment_problem(B, K, dev, m=1024 if B == 128 else 1000)
    out = TB.sweep_s_segment(spec, seg, r, P, spec.n)
    plain = TB.sweep_s_segment_plain(spec, seg, r, P, spec.n)
    _assert_bar((g - plain[0], plain[1], None, plain[2]), (g - out[0], out[1], None, out[2]))
    assert all(torch.equal(a, b) for a, b in zip(out, TB.sweep_s_segment(spec, seg, r, P,
                                                                        spec.n)))
    for k in range(K):
        one = TB.sweep_s_segment(spec, seg, r[k], P[k], spec.n)
        assert all(torch.equal(a[k], b) for a, b in zip(out, one))


@pytest.mark.parametrize("B", [64, 128])
def test_segment_sweep_passes_over_chains(B, dev, monkeypatch):
    """Where shared memory holds r of the row owners' rows for fewer chains
    than the batch (a plan with 4 chains a pass, as 64 chains at B=128 and
    m=32,768 need), each block takes several passes, r of the owners' rows
    going back to global memory between them: 9 chains in 3 passes, chain
    k still bit for bit its K=1 launch, and the bar against the plain
    version."""
    plan = TB.segment_plan
    monkeypatch.setattr(TB, "segment_plan", lambda *a, **k: {**plan(*a, **k), "kch": 4})
    K = 9
    spec, seg, g, r, P = _segment_problem(B, K, dev, m=1024)
    out = TB.sweep_s_segment(spec, seg, r, P, spec.n)
    plain = TB.sweep_s_segment_plain(spec, seg, r, P, spec.n)
    _assert_bar((g - plain[0], plain[1], None, plain[2]), (g - out[0], out[1], None, out[2]))
    for k in (0, 4, 8):
        one = TB.sweep_s_segment(spec, seg, r[k], P[k], spec.n)
        assert all(torch.equal(a[k], b) for a, b in zip(out, one))


def test_segment_sweep_refuses_a_grid_not_resident(dev):
    """A grid larger than the CTAs the card holds at once is refused before
    it runs (cudaErrorCooperativeLaunchTooLarge), never run in parts."""
    spec, seg, g, r, P = _segment_problem(64, 1, dev)
    mc, B = seg.shape[0], 64
    lib = build.library("sgibbs.cu")
    props = torch.cuda.get_device_properties(dev)
    sms = props.multi_processor_count
    fl = torch.zeros(4 * sms + 8, dtype=torch.int32, device=dev)
    rr, dg, tr = r[0].clone(), torch.empty_like(r[0]), torch.empty_like(r[0])
    snap = torch.empty((2, 1, B), device=dev)
    with launches() as got:
        code = lib.hb_sweep_s_segment(
            seg.data_ptr(), P[0].data_ptr(), mc, B, TB.n_rows(spec), 1, spec.model_index,
            spec.n_fold, 0, float(spec.n), 0.0, None, rr.data_ptr(), dg.data_ptr(),
            tr.data_ptr(), snap.data_ptr(), fl.data_ptr(), 0, 1, 8, 4 * sms, 4, 1, 32, B + 4,
            None, None, torch.cuda.current_stream(dev).cuda_stream)
    assert code != 0 and "too many blocks" in lib.hb_error_string(code).decode()
    assert got["seg_sweep_kernel"] == 0


def test_segment_sweep_stamps(dev):
    """The segment sweep's stamps are filled and ordered in time."""
    spec, seg, g, r, P = _segment_problem(64, 1, dev)
    nb = seg.shape[0] // 64
    st = torch.zeros(12 * nb + 4, dtype=torch.int64, device=dev)
    out = TB.sweep_s_segment(spec, seg, r[0], P[0], spec.n, stamps=st)
    assert all(torch.equal(a, b) for a, b in zip(out, TB.sweep_s_segment(spec, seg, r[0], P[0],
                                                                        spec.n)))
    s = st.cpu().numpy()
    b = s[:12 * nb].reshape(nb, 12)
    assert (np.diff(b[:-1, :5], axis=1) >= 0).all() and (np.diff(b[:, 0]) > 0).all()
    assert (np.diff(b[:, [0, 10, 11, 1]], axis=1) >= 0).all()
    assert (np.diff(b[:, [5, 7, 8, 9, 6]], axis=1) >= 0).all() and s[12 * nb + 1] > s[12 * nb]



# ---------------------------------------------------------------------------
# the SBayesS guard on the segment sweep, tiles of 64, and sbrm on every
# layout ldmat makes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("low", [False, True], ids=["vary", "lowvary"])
@pytest.mark.parametrize("model", ["BayesCpi", "BayesR"])
def test_guarded_segment_sweep(model, low, K, dev):
    """The segment sweep with the SBayesS guard (GUARD instance) against its
    plain version: the bar, a bit-identical second launch, the guard's
    counts per chain (first draws rejected, all 8 candidates failed) equal
    to the plain version's, firing at a lowered vary, and chain k bit for
    bit its K=1 launch."""
    spec, data, g, r, P, _, _ = _s_problem(model, "dense", dev, m=1000, guard=True)
    assert TB.guard_on(spec) and P.shape[0] == TB.summary_rows(spec)
    if low:
        spec = dataclasses.replace(spec, vary=spec.vary * 1e-3)
    seg = data.ld_segs[0]
    if K > 1:
        scale = 1.0 + 0.1 * torch.rand((K, 1), generator=torch.Generator(device=dev)
                                       .manual_seed(5), device=dev)
        g, r, P = g[None] * scale, r[None] * scale, P[None].expand(K, -1, -1).contiguous()
    lead = (K,) if K > 1 else ()
    tal = [torch.zeros(lead + (2,), dtype=torch.int64, device=dev) for _ in range(3)]
    out = TB.sweep_s_segment(spec, seg, r, P, spec.n, tally=tal[0])
    plain = TB.sweep_s_segment_plain(spec, seg, r, P, spec.n, tally=tal[1])
    again = TB.sweep_s_segment(spec, seg, r, P, spec.n, tally=tal[2])
    _assert_bar((g - plain[0], plain[1], None, plain[2]), (g - out[0], out[1], None, out[2]))
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    assert torch.equal(tal[0], tal[1]) and torch.equal(tal[0], tal[2])
    assert (int(tal[0][..., 0].sum()) > 0) == low
    for k in range(K if K > 1 else 0):
        one = TB.sweep_s_segment(spec, seg, r[k], P[k], spec.n)
        assert all(torch.equal(a[k], b) for a, b in zip(out, one))


@pytest.mark.parametrize("model", MODELS)
def test_tiled_sweep_tile64(model, dev):
    """The tiled sweep at tile 64 (the tile ldmat(tiled=True) makes) for all
    six models, the guard on for BayesCpi and BayesR: the bar against its
    plain version, equal guard counts, a bit-identical second launch."""
    spec, data, g, r, P, _, _ = _s_problem(model, "tiled", dev, m=1000, tile=64)
    assert spec.block == 64
    args = (spec, data.ld_tiles, data.ld_cols, data.ld_valid, r, P, spec.n)
    tal = [torch.zeros(2, dtype=torch.int64, device=dev) for _ in range(2)]
    out = TB.sweep_s_tiled(*args, tally=tal[0])
    plain = TB.sweep_s_tiled_plain(*args, tally=tal[1])
    _assert_bar((g - plain[0], plain[1], None, plain[2]), (g - out[0], out[1], None, out[2]))
    assert torch.equal(tal[0], tal[1]) and int(out[3]) == int(plain[3])
    assert all(torch.equal(a, b) for a, b in zip(out, TB.sweep_s_tiled(*args)))


def test_sbrm_on_ldmat_layouts(dev):
    """read_plink's genotype -> ldmat on the card (BlockDiagLD, SparseLD,
    tile-64 TiledSparseLD) -> sbrm through the kernels only: one
    segment_sweep a segment and iteration, one tiled_sweep an iteration;
    two chains on the BlockDiagLD; finite fits."""
    import hibayes_tpu_torch as htt

    rng = np.random.default_rng(0)
    n, m = 800, 512
    X = rng.binomial(2, 0.3, size=(n, m)).astype(np.int8)
    for j in range(1, m):
        c = rng.random(n) < 0.7
        X[c, j] = X[c, j - 1]
    mp = {"SNP": np.array([f"s{j}" for j in range(m)]), "Chr": np.repeat(["1", "2"], m // 2),
          "Pos": np.arange(m) * 1000}
    b = np.where(rng.random(m) < 0.05, rng.normal(0, 0.2, m), 0.0)
    y = (X - X.mean(0)) @ b + rng.normal(0, 1, n)
    Xc = X - X.mean(0)
    beta = Xc.T @ (y - y.mean()) / (Xc ** 2).sum(0)
    se = np.sqrt(np.var(y) / (Xc ** 2).sum(0))
    ss = np.column_stack([np.full(m, 0.3), beta, se, np.full(m, float(n))])
    lds = {"blockdiag": (htt.ldmat(X, map=mp, ldchr=False, device=dev), 2),
           "sparse": (htt.ldmat(X, chisq=30.0, device=dev), 1),
           "tiled": (htt.ldmat(X, map=mp, chisq=30.0, tiled=True, device=dev), 0)}
    for key, (ld, nseg) in lds.items():
        for nchains in ((1, 2) if key == "blockdiag" else (1,)):
            with launches() as counts:
                fit = htt.sbrm(ss, ld, method="BayesCpi", niter=20, nburn=10, thin=2,
                               nchains=nchains, verbose=False, device=dev)
            if nseg:
                assert counts["seg_sweep_kernel"] == nseg * 20, (key, counts)
            else:
                assert counts["tiled_sweep_kernel"] == 20 and ld.tile == 64, (key, counts)
            assert np.isfinite([fit.Vg, fit.Ve]).all() and fit.guard.shape == (nchains, 2)


def _ld_cohort(n=203, m=150, seed=0):
    """An int8 cohort whose SNPs copy their left neighbour with probability
    0.6 (LD that decays along each chromosome), its map of three
    chromosomes, and a GWAS panel of other individuals over 70 of the SNPs
    (another order, two SNPs the reference lacks).  n = 203 is not a
    multiple of 8: the int8 product pads its contraction axis."""
    def geno(n, seed):
        rng = np.random.default_rng(seed)
        X = rng.binomial(2, rng.uniform(0.1, 0.5, m), (n, m)).astype(np.int8)
        for j in range(1, m):
            c = rng.random(n) < 0.6
            X[c, j] = X[c, j - 1]
        return X

    mp = {"SNP": np.array([f"s{i}" for i in range(m)]),
          "Chr": np.repeat(["1", "2", "3"], (60, 50, 40)), "Pos": np.arange(m) * 1000}
    pick = np.random.default_rng(seed + 4).permutation(m)[:70]
    Xg = geno(157, seed + 3)
    gmap = {"SNP": np.concatenate([mp["SNP"][pick], ["x1", "x2"]]), "Chr": np.ones(72, str),
            "Pos": np.arange(72)}
    return geno(n, seed), mp, np.concatenate([Xg[:, pick], Xg[:, :2]], axis=1), gmap


LD_KINDS = {
    "dense": dict(),
    "sparse": dict(chisq=10.0),
    "blockdiag": dict(map=True),
    "blockdiag_chisq": dict(map=True, chisq=10.0),
    "dense_overlay": dict(overlay=True, ldchr=True, map=True),
    "sparse_overlay": dict(overlay=True, ldchr=True, map=True, chisq=5.0),
    "blockdiag_overlay": dict(overlay=True, map=True, chisq=10.0),
}


@pytest.mark.parametrize("kind", list(LD_KINDS))
def test_ldmat_on_the_card_equals_the_cpu(kind, dev):
    """ldmat on the card (the int8 Gram through torch._int_mm, float64
    centring and chi-square mask) against ldmat on the CPU on one int8
    cohort: every layout's float64 values, nonzero counts and diagonal bit
    for bit."""
    from hibayes_tpu_torch.data.ld import as_numpy, ldmat

    X, mp, Xg, gmap = _ld_cohort()
    kw = dict(LD_KINDS[kind])
    if kw.pop("map", False):
        kw["map"] = mp
    if kw.pop("overlay", False):
        kw["gwas_geno"], kw["gwas_map"] = Xg, gmap
    on_cpu, on_card = ldmat(X, device="cpu", **kw), ldmat(X, device=dev, **kw)
    assert type(on_cpu) is type(on_card)
    if hasattr(on_cpu, "blocks"):
        assert list(on_cpu.sizes) == list(on_card.sizes)
        assert (on_cpu.nnz_col is None) == (on_card.nnz_col is None)
        pairs = list(zip(on_cpu.blocks, on_card.blocks))
    else:
        pairs = [(on_cpu.values, on_card.values)]
    for a, b in pairs:
        assert isinstance(b, torch.Tensor) and b.device.type == "cuda" and b.dtype == torch.float64
        np.testing.assert_array_equal(as_numpy(b), as_numpy(a))
    np.testing.assert_array_equal(on_card.nnz_per_col(), on_cpu.nnz_per_col())
    np.testing.assert_array_equal(on_card.diag, on_cpu.diag)


@pytest.mark.parametrize("path", ["device", "host"])
def test_tiled_ldmat_on_the_card_equals_the_cpu(path, dev):
    """ldmat(tiled=True) on the card against the CPU on one int8 cohort,
    tile 64 per chromosome: the device path (float32 store, tiles selected
    and assembled on the card) with the same tile indices, masks and
    counts and tiles within 1e-6; the host path (float64 store) bit for
    bit."""
    from hibayes_tpu_torch.data.ld import as_numpy, ldmat

    X, mp, _, _ = _ld_cohort(m=300)
    mp = {"SNP": np.array([f"s{i}" for i in range(300)]),
          "Chr": np.repeat(["1", "2", "3"], (130, 100, 70)), "Pos": np.arange(300) * 1000}
    kw = dict(map=mp, chisq=10.0, tiled=True, tile=64, stripe=128,
              dtype=torch.float32 if path == "device" else torch.float64)
    on_cpu, on_card = ldmat(X, device="cpu", **kw), ldmat(X, device=dev, **kw)
    assert on_cpu.tile == on_card.tile == 64 and on_cpu.m == on_card.m
    np.testing.assert_array_equal(as_numpy(on_card.col_idx), as_numpy(on_cpu.col_idx))
    np.testing.assert_array_equal(as_numpy(on_card.valid), as_numpy(on_cpu.valid))
    np.testing.assert_array_equal(on_card.nnz_col, on_cpu.nnz_col)
    if path == "device":
        assert isinstance(on_card.tiles, torch.Tensor) and on_card.tiles.device.type == "cuda"
        np.testing.assert_allclose(as_numpy(on_card.tiles), as_numpy(on_cpu.tiles),
                                   rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(as_numpy(on_card.tiles), as_numpy(on_cpu.tiles))


# ---------------------------------------------------------------------------
# checkpoint and resume, BSLMM, the GRM and the command line on the card
# ---------------------------------------------------------------------------


class _Killed(Exception):
    pass


def _kill_after(monkeypatch, saves):
    """The ``saves``-th checkpoint is written, then the run dies."""
    from hibayes_tpu_torch.engine import checkpoint as CK

    real, count = CK.save_checkpoint, [0]

    def save(path, state, samples):
        real(path, state, samples)
        count[0] += 1
        if count[0] == saves:
            raise _Killed()

    monkeypatch.setattr(CK, "save_checkpoint", save)


def _resume_case(case, dev, tmp_path):
    """(fit function taking checkpoint=, description) of one engine at a
    small size on the card: 100 iterations, burn-in 40, a checkpoint every
    20 iterations (printfreq 20, thin 5)."""
    import hibayes_tpu_torch as htt

    rng = np.random.default_rng(11)
    kw = dict(niter=100, nburn=40, thin=5, printfreq=20, verbose=False, device=dev,
              seed=3)
    if case.startswith("ibrm"):
        n, m = 600, 300
        M = rng.binomial(2, 0.3, size=(n, m)).astype(np.int8)
        ids = np.array([f"i{k}" for k in range(n)])
        data = {"id": ids, "y": M[:, :10] @ rng.normal(0, 0.3, 10) + rng.normal(size=n),
                "f": rng.choice(["a", "b", "c"], n)}
        nch = 4 if case == "ibrm_batch" else 1
        return lambda ck: htt.ibrm("y ~ (1|f)", data=data, M=M, M_id=ids, method="BayesR",
                                   nchains=nch, checkpoint=ck, **kw)
    if case.startswith("sbrm"):
        layout = "tiled" if case == "sbrm_tiled" else "dense"
        _, _, _, _, _, ss, ld = _s_problem("BayesCpi", layout, dev, tile=64)
        if case == "sbrm_blockdiag_batch":
            from hibayes_tpu_torch.data.ld import BlockDiagLD

            V = ld.values
            ld = BlockDiagLD(blocks=[V[:300, :300].contiguous(), V[300:, 300:].contiguous()],
                             sizes=[300, 300])
        nch = 4 if case == "sbrm_blockdiag_batch" else 1
        return lambda ck: htt.sbrm(ss, ld, method="BayesCpi", nchains=nch, checkpoint=ck,
                                   **kw)
    ids = np.array([f"p{k}" for k in range(600)])
    par = [rng.integers(0, max(k, 1), 2) for k in range(600)]
    sire = np.array(["0" if k < 60 else ids[p[0]] for k, p in enumerate(par)])
    dam = np.array(["0" if k < 60 else ids[p[1]] for k, p in enumerate(par)])
    gid = ids[rng.choice(600, 200, replace=False)]
    Mg = rng.binomial(2, 0.3, (200, 100)).astype(np.int8)
    phe = ids[rng.choice(600, 300, replace=False)]
    y = rng.normal(size=300)
    return lambda ck: htt.ssbrm("y ~ 1", data={"id": phe, "y": y}, M=Mg,
                                M_id=gid, pedigree={"id": ids, "sire": sire, "dam": dam},
                                impute="pcg", chunk_cols=32, checkpoint=ck, **kw)


@pytest.mark.parametrize("case", ["ibrm", "ibrm_batch", "sbrm_tiled", "sbrm_blockdiag_batch",
                                  "ssbrm"])
def test_resume_on_the_card_is_bit_identical(case, dev, tmp_path, monkeypatch):
    """Each engine on the card, one chain and a batch: a fit killed after its
    fourth checkpoint (iteration 80, past burn-in) and run again equals the
    uninterrupted fit bit for bit: every record, the GEBV, the guard's
    counts."""
    fit = _resume_case(case, dev, tmp_path)
    full = fit(None)
    ck = str(tmp_path / "ck")
    _kill_after(monkeypatch, 4)
    with pytest.raises(_Killed):
        fit(ck)
    monkeypatch.undo()
    resumed = fit(ck)
    assert resumed.MCMCsamples.keys() == full.MCMCsamples.keys()
    for k in full.MCMCsamples:
        np.testing.assert_array_equal(resumed.MCMCsamples[k], full.MCMCsamples[k], err_msg=k)
    if full.g is not None:
        np.testing.assert_array_equal(resumed.g["gebv"], full.g["gebv"])
    if full.guard is not None:
        np.testing.assert_array_equal(resumed.guard, full.guard)


def _bslmm_problem(dev, n=500, m=1024):
    from hibayes_tpu_torch.math.grm import make_grm

    rng = np.random.default_rng(12)
    M = rng.binomial(2, rng.uniform(0.1, 0.5, m), size=(n, m)).astype(np.int8)
    b = rng.normal(0, 0.03, m)
    b[rng.choice(m, 5, replace=False)] = rng.normal(0, 0.8, 5)
    y = M @ b + rng.normal(0, 1, n)
    Kval, K = make_grm(M, eigen=True, device=dev)
    data = TG.prepare_gibbs_data(y, M, K=K, Kval=Kval, block=64, geno_dtype="int8",
                                 device=dev)
    pi = np.array([0.95, 0.05])
    pr = TG.resolve_priors(y, float(data.vx.sum()), pi[0], nr=0)
    spec = TG.GibbsSpec(
        model="BSLMM", n=n, m=m, m_pad=int(data.xpx.shape[0]), block=64, nc=0,
        nlevels=(), n_fold=2, niter=40, nburn=20, thin=5,
        nvar0=int((data.vx[:m] == 0).sum()), dfvara=pr.dfvara, s2vara=pr.s2vara,
        dfvare=pr.dfvare, s2vare=pr.s2vare, s2varg=pr.s2varg,
        lambda_rate0=pr.lambda_rate0, use_bslmm=True)
    return M, y, spec, data, pr, pi


@pytest.mark.parametrize("K", [1, 4])
def test_bslmm_on_the_card_against_its_plain_version(K, dev, monkeypatch):
    """BSLMM on the card (n=500 rows, not padded; int8, B=64), one chain and
    a batch of 4: an iteration from a mid-run state through the kernels
    against the same iteration with the plain sweep, at the kernel bar
    (at most 1% of the mixture draws flip, effects within 5e-5 max|g|
    where they agree; with no flip the polygenic term and its variance
    within 1e-4); then the entry point through the kernels only."""
    import hibayes_tpu_torch as htt

    M, y, spec, data, pr, pi = _bslmm_problem(dev)
    state = TG.init_state(spec, data, pr, pi)
    step = TG.one_iteration
    if K > 1:
        state, step = TG.stack_state(state, K), TG.one_iteration_batch
    for _ in range(5):
        state = step(spec, data, 1, state)
    kern = step(spec, data, 1, state)
    monkeypatch.setattr(TB, "sweep_mc", plain_sweep_mc)
    plain = step(spec, data, 1, state)
    monkeypatch.undo()
    agree = (kern.track == plain.track)
    assert float(agree.float().mean()) >= 0.99
    scale = float(plain.g.abs().max())
    assert float((kern.g - plain.g)[agree].abs().max()) <= 5e-5 * scale
    if bool(agree.all()):
        for name in ("k_estR", "yadj"):
            a, b = getattr(kern, name), getattr(plain, name)
            assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()) + 1e-6, name
        torch.testing.assert_close(kern.vbtmp, plain.vbtmp, rtol=1e-4, atol=0)
    ids = np.array([f"i{k}" for k in range(len(y))])
    calls = counted(monkeypatch, "sweep_mc_plain")
    with launches() as got:
        fit = htt.ibrm("y ~ 1", data={"id": ids, "y": y}, M=M, M_id=ids, method="BSLMM",
                       niter=40, nburn=20, nchains=K, verbose=False, device=dev)
    assert not calls
    assert got["sweep1_kernel" if K == 1 else "draws_kernel"] > 0
    assert np.isfinite([fit.Va, fit.Vb]).all() and fit.Va >= 0 and fit.Vb >= 0
    assert np.isfinite(fit.g["gebv"]).all()


@pytest.mark.parametrize("n,m", [(333, 2050), (1000, 3000)])
def test_make_grm_on_the_card_equals_the_cpu(n, m, dev):
    """The exact int8 product MM' on the card equals the CPU's; the GRM in
    float32 agrees with the CPU's to float32 rounding (1e-5 of the
    largest entry: the mean corrections sum in other orders).  The card's
    eigenvalues of G + 0.2 I are those of its own G to float32 rounding
    (1e-5 of the largest, against a float64 eigh of the same matrix: two
    GRMs rounded apart differ most in the centred null direction) and its
    eigenvectors rebuild the matrix.  At n=333 the card's float32 eigh
    would take cuSOLVER's Jacobi solver (1.2e-4 off); make_grm solves that
    size in float64."""
    from hibayes_tpu_torch.data.ld import _int_mm
    from hibayes_tpu_torch.math.grm import make_grm

    rng = np.random.default_rng(13)
    M = rng.binomial(2, 0.3, size=(n, m)).astype(np.int8)
    Mt = torch.as_tensor(M)
    assert torch.equal(_int_mm(Mt.to(dev), Mt.to(dev)).cpu(), _int_mm(Mt, Mt))
    G_card, G_cpu = make_grm(M, device=dev), make_grm(M)
    assert G_card.device.type == "cuda" and G_card.dtype == torch.float32
    scale = float(G_cpu.abs().max())
    assert float((G_card.cpu() - G_cpu).abs().max()) <= 1e-5 * scale
    v_card, K_card = make_grm(M, lambda_=0.2, eigen=True, device=dev)
    eye = torch.eye(n, device=dev)
    v_ref = torch.linalg.eigvalsh((G_card + 0.2 * eye).double()).cpu()
    assert v_card.dtype == torch.float32
    assert float((v_card.cpu().double() - v_ref).abs().max()) <= 1e-5 * float(v_ref.abs().max())
    rec = (K_card * v_card) @ K_card.T
    assert float((rec - G_card - 0.2 * eye).abs().max()) <= 1e-4 * scale


def test_cli_subprocess_on_the_card(dev, tmp_path):
    """``python -m hibayes_tpu_torch ibrm`` on the card writes, byte for byte,
    what ibrm on the card writes through the CLI's writer in this process;
    ``ldmat --by-chr`` writes its npz."""
    import os
    import subprocess
    import sys

    import hibayes_tpu_torch as htt
    from hibayes_tpu_torch import cli
    from hibayes_tpu_torch.data.plink import encode_bed_bytes

    rng = np.random.default_rng(14)
    n, m = 500, 256
    X = rng.binomial(2, 0.3, size=(n, m)).astype(np.int8)
    stem = str(tmp_path / "c")
    open(stem + ".bed", "wb").write(encode_bed_bytes(X))
    open(stem + ".bim", "w").write("".join(f"{1 + 2 * j // m}\tM{j}\t0\t{1000 * (j + 1)}\tA\tG\n"
                                           for j in range(m)))
    open(stem + ".fam", "w").write("".join(f"F{i}\tI{i}\t0\t0\t1\t-9\n" for i in range(n)))
    y = X[:, :10] @ rng.normal(0, 0.3, 10) + rng.normal(size=n)
    open(stem + ".phe", "w").write("id y\n" + "".join(f"I{i} {float(v)!r}\n"
                                                       for i, v in enumerate(y)))
    out = str(tmp_path / "fit")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    args = ["ibrm", "--bfile", stem, "--pheno", stem + ".phe", "--formula", "y ~ 1",
            "--niter", "60", "--nburn", "20", "--quiet", "--out-prefix", out,
            "--checkpoint", str(tmp_path / "ck")]
    proc = subprocess.run([sys.executable, "-m", "hibayes_tpu_torch", *args], cwd=repo,
                          env={**os.environ, "PYTHONPATH": repo}, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    bed = htt.read_plink(stem)
    fit = htt.ibrm("y ~ 1", data=htt.read_pheno(stem + ".phe"), M=bed["geno"].values,
                   M_id=bed["fam"][1], niter=60, nburn=20, verbose=False, device=dev)
    cli.save_fit(fit, str(tmp_path / "api"), map_=bed["map"])
    for suffix in (".alpha.tsv", ".gebv.tsv", ".var.tsv"):
        assert open(out + suffix, "rb").read() == open(str(tmp_path / "api") + suffix,
                                                       "rb").read(), suffix
    proc = subprocess.run([sys.executable, "-m", "hibayes_tpu_torch", "ldmat", "--bfile", stem,
                           "--out", str(tmp_path / "ld.npz"), "--by-chr"], cwd=repo,
                          env={**os.environ, "PYTHONPATH": repo}, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    with np.load(str(tmp_path / "ld.npz")) as z:
        assert str(z["kind"]) == "blockdiag" and z["block_0"].shape == (128, 128)


# ---------------------------------------------------------------------------
# any block, fold count, tile and chain count (sub-blocks, the run-time fold
# instance, re-tiled stores, groups of chains)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("int8", [True, False], ids=["int8", "f32"])
@pytest.mark.parametrize("B", [30, 192, 250, 256])
def test_sub_block_sweeps_match_plain(B, int8, K, dev):
    """sweep_mc at blocks of 30, 192, 250 and 256 (two sub-blocks above
    128, pad slots at 30 and 250), one chain and K=3: against its plain
    version at the kernel bar, bit-identical on a second launch; one
    sweep1 launch at K=1, nbg S + 1 rows and nbg S draws launches at K=3;
    block_draws by the same sub-blocks against its plain version."""
    spec, args = _inputs("BayesR" if K == 1 else "BayesCpi", dev, K=K, n=1000, m=600,
                         B=B, int8=int8)
    sb = TB.mc_layout(spec, args[1])
    assert not sb.same and sb == TB.mc_sub_blocks(TB.n_rows(spec), 1000, B, 1 if int8 else 4)
    with launches() as got:
        out = TB.sweep_mc(spec, *args)
    nbk = spec.nblocks * sb.S
    want = ({"sweep1_kernel": 1} if K == 1
            else {"rows_mc_kernel": nbk + 1, "draws_kernel": nbk})
    assert {k: v for k, v in got.items() if v} == want
    _assert_bar(TB.sweep_mc_plain(spec, *args), out)
    assert all(torch.equal(a, b) for a, b in zip(out, TB.sweep_mc(spec, *args)))
    consts, X, W, xpx, vx, *per = args
    P = TB.pack_rows(spec, consts, xpx, vx, per[0], per[1], per[2], per[3], per[4], per[6],
                     torch.float32)
    P_b = TB.to_block_layout(P, spec.nblocks, B)[1].contiguous()
    Xb, Wb = _whole_block(spec, X, 1)
    r0 = (per[7] @ Xb).T.contiguous()
    logpi = consts["logpi"][:, :1].T.contiguous()
    g_old = P_b[:, 1, :]
    dg_k, tr_k = TB.block_draws(spec, logpi, P_b, Wb, r0)
    dg_p, tr_p = TB.block_draws_plain(spec, logpi, P_b, Wb, r0)
    _assert_bar((g_old - dg_p, tr_p), (g_old - dg_k, tr_k))


def _whole_block(spec, X, b):
    """Block b's B columns of a genotype in the sweeps' layout (its
    sub-blocks side by side, float32) and their Gram (integer sums, exact
    in float32): block_draws' inputs."""
    sb = TB.mc_layout(spec, X)
    Xb = X[b * sb.S:(b + 1) * sb.S].float().permute(1, 0, 2).reshape(X.shape[1], -1)
    Xb = Xb[:, :spec.block]
    return Xb, (Xb.T @ Xb).contiguous()


@pytest.mark.parametrize("nf", [12, 16, 40])
def test_many_folds_match_plain(nf, dev):
    """BayesR with 12, 16 and 40 folds (the draw chain's run-time fold
    instance; at 40 a lane evaluates two folds, and the rows narrow every
    sweep's sub-blocks) on every kernel: sweep_mc at one chain and K=2,
    block_draws, the guarded segment sweep and the guarded tiled sweep,
    each against its plain version at the bar and bit-identical on a second
    launch."""
    for K in (1, 2):
        spec, args = _inputs("BayesR", dev, K=K, n=2000, m=512, B=128, nf=nf)
        out = TB.sweep_mc(spec, *args)
        _assert_bar(TB.sweep_mc_plain(spec, *args), out)
        assert all(torch.equal(a, b) for a, b in zip(out, TB.sweep_mc(spec, *args)))
    consts, X, W, xpx, vx, *per = args
    P = TB.pack_rows(spec, consts, xpx, vx, per[0], per[1], per[2], per[3], per[4], per[6],
                     torch.float32)
    P_b = TB.to_block_layout(P, spec.nblocks, 128)[0].contiguous()
    Xb, Wb = _whole_block(spec, X, 0)
    r0 = (per[7] @ Xb).T.contiguous()
    logpi = consts["logpi"][:, :1].T.contiguous()
    dg_k, tr_k = TB.block_draws(spec, logpi, P_b, Wb, r0)
    dg_p, tr_p = TB.block_draws_plain(spec, logpi, P_b, Wb, r0)
    _assert_bar((P_b[:, 1] - dg_p, tr_p), (P_b[:, 1] - dg_k, tr_k))
    for layout in ("dense", "tiled"):
        spec, data, g, r, P, _, _ = _s_problem("BayesR", layout, dev, m=1000, guard=True,
                                               nf=nf)
        assert spec.n_fold == nf and TB.guard_on(spec)
        plain = (TB.sweep_s_segment_plain(spec, data.ld_segs[0], r, P, spec.n)
                 if layout == "dense" else
                 TB.sweep_s_tiled_plain(spec, data.ld_tiles, data.ld_cols, data.ld_valid,
                                        r, P, spec.n))
        out, again = _s_sweep(layout, spec, data, r, P), _s_sweep(layout, spec, data, r, P)
        _assert_bar((g - plain[0], plain[1], None, plain[2]),
                    (g - out[0], out[1], None, out[2]))
        assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("B", [30, 192, 250, 256])
def test_segment_sub_blocks_match_plain(B, K, dev):
    """The dense segment sweep at blocks of 30, 192, 250 and 256 (the
    segment as stored at 192 and 256, a copy with pad rows at 30 and 250),
    one chain and K=3: against its plain version at the bar, one launch,
    bit-identical on a second launch, chain k bit for bit its K=1 launch."""
    spec, data, g, r, P, _, _ = _s_problem("BayesCpi", "dense", dev, m=1000, block=B)
    seg = data.ld_segs[0]
    if K > 1:
        scale = 1.0 + 0.1 * torch.arange(K, device=dev, dtype=torch.float32)[:, None]
        g, r, P = g[None] * scale, r[None] * scale, P[None].expand(K, -1, -1).contiguous()
    with launches() as got:
        out = TB.sweep_s_segment(spec, seg, r, P, spec.n)
    assert got["seg_sweep_kernel"] == 1
    plain = TB.sweep_s_segment_plain(spec, seg, r, P, spec.n)
    _assert_bar((g - plain[0], plain[1], None, plain[2]), (g - out[0], out[1], None, out[2]))
    assert all(torch.equal(a, b) for a, b in zip(out, TB.sweep_s_segment(spec, seg, r, P,
                                                                        spec.n)))
    for k in range(1 if K == 1 else K):
        if K > 1:
            one = TB.sweep_s_segment(spec, seg, r[k], P[k], spec.n)
            assert all(torch.equal(a[k], b) for a, b in zip(out, one))


@pytest.mark.parametrize("model", ["BayesCpi", "BayesR"])
@pytest.mark.parametrize("tile", [10, 256])
def test_retiled_sweep_matches_plain(tile, model, dev):
    """The tiled sweep on stores of tiles of 10 (re-tiled to 12, pad slots)
    and 256 (re-tiled to 128), the guard on at a lowered vary: against its
    plain version at the bar with equal rejection counts, bit-identical on
    a second launch; a K=4 batch in one launch, each chain bit for bit its
    K=1 launch."""
    spec, data, g, r, P, _, _ = _s_problem(model, "tiled", dev, m=1500, tile=tile)
    spec = dataclasses.replace(spec, vary=spec.vary * 1e-3)
    lay = (data.ld_tiles, data.ld_cols, data.ld_valid)
    assert not TB.tiled_sub_blocks(spec, tile).same
    out = TB.sweep_s_tiled(spec, *lay, r, P, spec.n)
    plain = TB.sweep_s_tiled_plain(spec, *lay, r, P, spec.n)
    _assert_bar((g - plain[0], plain[1], None, plain[2]), (g - out[0], out[1], None, out[2]))
    assert int(out[3]) == int(plain[3]) and int(plain[3]) > 0
    assert all(torch.equal(a, b) for a, b in zip(out, TB.sweep_s_tiled(spec, *lay, r, P,
                                                                      spec.n)))
    K = 4
    Rs = r[None] * (1.0 + 0.05 * torch.arange(K, device=dev, dtype=torch.float32)[:, None])
    Ps = P[None].expand(K, -1, -1).contiguous()
    with launches() as got:
        batch = TB.sweep_s_tiled(spec, *lay, Rs, Ps, spec.n)
    assert got["tiled_sweep_kernel"] == 1
    for k in range(K):
        one = TB.sweep_s_tiled(spec, *lay, Rs[k], Ps[k], spec.n)
        assert all(torch.equal(a[k], b) for a, b in zip(batch, one))


def test_tiled_batch_larger_than_the_card_runs_in_groups(dev, monkeypatch):
    """A tiled batch of more chains than the card holds drawer CTAs at once
    (160 at tiles of 128 with the guard) runs in groups, a launch each,
    with the schedule its plans keep and counters for each group size:
    each chain bit for bit its K=1 launch, and a batch in groups of 3
    bit for bit the batch in one launch."""
    spec, data, g, r, P, _, _ = _s_problem("BayesCpi", "tiled", dev, m=1500)
    lay = (data.ld_tiles, data.ld_cols, data.ld_valid)
    plans = {}
    _, _, sched, key = TB.tiled_plan(spec, *lay, plans=plans)
    G = TB.tiled_group(spec, 128, sched.items.shape[0])
    C = 160
    assert G < C
    Rs = r[None] * (1.0 + 0.001 * torch.arange(C, device=dev, dtype=torch.float32)[:, None])
    Ps = P[None].expand(C, -1, -1).contiguous()
    tally = torch.zeros((C, 2), dtype=torch.int64, device=dev)
    with launches() as got:
        out = TB.sweep_s_tiled(spec, *lay, Rs, Ps, spec.n, tally=tally, plans=plans)
    assert got["tiled_sweep_kernel"] == -(-C // G)
    assert TB.tiled_plan(spec, *lay, plans=plans)[2] is sched
    sizes = {g.stop - g.start for g in TB._chain_groups(C, G)}
    assert {k[-1] for k in plans if k[-2:-1] == ("counters",)} == sizes
    for k in (0, G - 1, G, C - 1):
        t1 = torch.zeros(2, dtype=torch.int64, device=dev)
        one = TB.sweep_s_tiled(spec, *lay, Rs[k], Ps[k], spec.n, tally=t1)
        assert all(torch.equal(a[k], b) for a, b in zip(out, one))
        assert torch.equal(tally[k], t1)
    monkeypatch.setattr(TB, "tiled_group", lambda *a: 3)
    with launches() as got:
        few = TB.sweep_s_tiled(spec, *lay, Rs[:7], Ps[:7], spec.n)
    assert got["tiled_sweep_kernel"] == 3
    assert all(torch.equal(a[:7], b) for a, b in zip(out, few))


def test_segment_batch_larger_than_the_card_runs_in_groups(dev):
    """A segment batch whose drawer CTAs would leave no SM for the rows
    (1,100 chains at 8 a drawer) runs in groups, a launch each; each chain
    bit for bit its K=1 launch."""
    spec, seg, g, r, P = _segment_problem(64, 1, dev)
    C = 1100
    Rs = r * (1.0 + 1e-4 * torch.arange(C, device=dev, dtype=torch.float32)[:, None])
    Ps = P.expand(C, -1, -1).contiguous()
    props = torch.cuda.get_device_properties(dev)
    G = TB.segment_group(seg.shape[0], 64, C, TB.summary_rows(spec),
                         props.multi_processor_count)
    assert G < C
    with launches() as got:
        out = TB.sweep_s_segment(spec, seg, Rs, Ps, spec.n)
    assert got["seg_sweep_kernel"] == -(-C // G)
    for k in (0, G, C - 1):
        one = TB.sweep_s_segment(spec, seg, Rs[k], Ps[k], spec.n)
        assert all(torch.equal(a[k], b) for a, b in zip(out, one))


def test_device_trace_records_cuda_kernels(dev, tmp_path):
    """device_trace on the card records the CUDA kernels a sweep launches
    (by CUDA time in its totals) and the annotated phase."""
    from hibayes_tpu_torch.utils import annotate, device_trace

    spec, args = _inputs("BayesCpi", dev, K=1, n=1000, m=256, B=64)
    TB.sweep_mc(spec, *args)
    with device_trace(tmp_path) as prof:
        with annotate("sweep-phase"):
            TB.sweep_mc(spec, *args)
    keys = {e.key: e for e in prof.key_averages()}
    assert "sweep-phase" in keys
    kernels = [k for k in keys if "sweep1_kernel" in k]
    assert kernels, sorted(keys)[:40]
    dev_us = [getattr(keys[k], "device_time_total", getattr(keys[k], "cuda_time_total", 0))
              for k in kernels]
    assert max(dev_us) > 0
    assert (tmp_path / "trace.json").exists()


@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("kind", ["band", "gaps", "nonband"])
@pytest.mark.parametrize("S", [2, 4])
def test_tiled_sweep_row_base_shards(S, kind, C, dev):
    """TPU kernel 9 on a shard of tile rows: each shard of S swept at its
    row_base against the whole r_hat (the SNP-sharded sweep's turn, one
    chain or two), against the plain version at the kernel bar with equal
    guard counts, bit-identical on a second launch, one tiled_sweep launch
    a shard; the shards in turn reach the whole sweep's r_hat at the
    bar."""
    spec, data, g, r, P, _, _ = _s_problem("BayesR", "tiled", dev, m=2000)
    cols, valid = ((data.ld_cols, data.ld_valid) if kind == "band"
                   else _tiled_layout(data, kind, dev))
    B = spec.block
    nbr = cols.shape[0]
    if nbr % S:
        pytest.skip(f"{nbr} tile rows")
    if C > 1:
        r, P, g = (torch.stack([x, x * 0.5]).contiguous() for x in (r, P, g))
    nl = nbr // S
    r_k, r_p = r, r
    for k in range(S):
        b0 = k * nl
        rows = slice(b0, b0 + nl)
        args = (spec, data.ld_tiles[rows].contiguous(), cols[rows], valid[rows])
        Pk = P[..., b0 * B:(b0 + nl) * B].contiguous()
        with launches() as got:
            out = TB.sweep_s_tiled(*args, r_p, Pk, spec.n, row_base=b0)
        assert got["tiled_sweep_kernel"] == 1
        plain = TB.sweep_s_tiled_plain(*args, r_p, Pk, spec.n, row_base=b0)
        gk = g[..., b0 * B:(b0 + nl) * B]
        for c in range(C):
            pick = (lambda t: t) if C == 1 else (lambda t, c=c: t[c])
            _assert_bar((pick(gk) - pick(plain[0]), pick(plain[1]), None, pick(plain[2])),
                        (pick(gk) - pick(out[0]), pick(out[1]), None, pick(out[2])))
        assert torch.equal(out[3].cpu(), plain[3].cpu())
        again = TB.sweep_s_tiled(*args, r_p, Pk, spec.n, row_base=b0)
        assert all(torch.equal(a, b) for a, b in zip(out, again))
        r_k = TB.sweep_s_tiled(*args, r_k, Pk, spec.n, row_base=b0)[2]
        r_p = plain[2]
    whole = TB.sweep_s_tiled_plain(spec, data.ld_tiles, cols, valid, r, P, spec.n)
    assert torch.equal(r_p, whole[2]) or C > 0
    pick = (lambda t: t) if C == 1 else (lambda t: t[0])
    _assert_bar((pick(g), pick(g), None, pick(whole[2])), (pick(g), pick(g), None, pick(r_k)))


def test_tiled_sweep_reads_rows_from_global_memory(dev):
    """BayesR with 640 folds and the guard (30 KB of rows a SNP, more than
    a CTA's shared memory at 4 SNPs): the tiled sweep's draws read the
    packed rows from global memory; against the plain version at the bar,
    bit-identical on a second launch, and at a row_base."""
    spec, data, g, r, P, _, _ = _s_problem("BayesR", "tiled", dev, m=600, nf=640)
    assert TB.tiled_sub_blocks(spec, spec.block).rows_global
    args = (spec, data.ld_tiles, data.ld_cols, data.ld_valid, r, P, spec.n)
    out, again = TB.sweep_s_tiled(*args), TB.sweep_s_tiled(*args)
    plain = TB.sweep_s_tiled_plain(*args)
    _assert_bar((g - plain[0], plain[1], None, plain[2]), (g - out[0], out[1], None, out[2]))
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    assert int(out[3]) == int(plain[3])
    B, b0 = spec.block, 2
    rows = slice(b0, None)
    sh = (spec, data.ld_tiles[rows].contiguous(), data.ld_cols[rows], data.ld_valid[rows],
          r, P[:, b0 * B:].contiguous(), spec.n)
    out = TB.sweep_s_tiled(*sh, row_base=b0)
    plain = TB.sweep_s_tiled_plain(*sh, row_base=b0)
    _assert_bar((g[b0 * B:] - plain[0], plain[1], None, plain[2]),
                (g[b0 * B:] - out[0], out[1], None, out[2]))


@pytest.mark.parametrize("K", [1, 2])
def test_segment_sweep_reads_rows_from_global_memory(K, dev):
    """The guarded segment sweep at 640 folds reads the packed rows from
    global memory: one chain and two, against the plain version at the bar
    with equal guard counts, bit-identical on a second launch."""
    spec, data, g, r, P, _, _ = _s_problem("BayesR", "dense", dev, m=600, guard=True, nf=640)
    assert TB.segment_sub_blocks(spec, spec.block).rows_global
    if K > 1:
        r, P, g = (torch.stack([x, 0.5 * x]).contiguous() for x in (r, P, g))
    tk, tp = torch.zeros((K, 2) if K > 1 else (2,), dtype=torch.int64, device=dev), \
        torch.zeros((K, 2) if K > 1 else (2,), dtype=torch.int64, device=dev)
    out = TB.sweep_s_segment(spec, data.ld_segs[0], r, P, spec.n, tally=tk)
    again = TB.sweep_s_segment(spec, data.ld_segs[0], r, P, spec.n)
    plain = TB.sweep_s_segment_plain(spec, data.ld_segs[0], r, P, spec.n, tally=tp)
    for k in range(K):
        pick = (lambda t: t) if K == 1 else (lambda t, k=k: t[k])
        _assert_bar((pick(g) - pick(plain[0]), pick(plain[1]), None, pick(plain[2])),
                    (pick(g) - pick(out[0]), pick(out[1]), None, pick(out[2])))
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    assert torch.equal(tk.cpu(), tp.cpu())


@pytest.mark.parametrize("nf", [640, 2000])
def test_ibrm_sweeps_many_folds_match_plain(nf, dev):
    """BayesR with 640 folds on the individual-level sweeps (their rows
    narrow the sub-blocks, staged in shared memory) and 2,000 (past 4 SNPs
    a sub-block: the draws read the rows from global memory): sweep_mc at
    one chain and K=2, and block_draws, against the plain versions at the
    bar, bit-identical on a second launch."""
    for K in (1, 2):
        spec, args = _inputs("BayesR", dev, K=K, n=1000, m=64, B=32, nf=nf)
        assert TB.mc_layout(spec, args[1]).rows_global == (nf == 2000)
        out = TB.sweep_mc(spec, *args)
        _assert_bar(TB.sweep_mc_plain(spec, *args), out)
        assert all(torch.equal(a, b) for a, b in zip(out, TB.sweep_mc(spec, *args)))
    consts, X, W, xpx, vx, *per = args
    P = TB.pack_rows(spec, consts, xpx, vx, per[0], per[1], per[2], per[3], per[4], per[6],
                     torch.float32)
    P_b = TB.to_block_layout(P, spec.nblocks, 32)[0].contiguous()
    Xb = X[:1].float()[0] if TB.mc_layout(spec, X).same else _whole_block(spec, X, 0)[0]
    Wb = (Xb.T @ Xb).contiguous()
    r0 = (per[7] @ Xb).T.contiguous()
    logpi = consts["logpi"][:, :1].T.contiguous()
    dg_k, tr_k = TB.block_draws(spec, logpi, P_b, Wb, r0)
    dg_p, tr_p = TB.block_draws_plain(spec, logpi, P_b, Wb, r0)
    _assert_bar((P_b[:, 1] - dg_p, tr_p), (P_b[:, 1] - dg_k, tr_k))


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("S,Rm", [(2, 2), (4, 1)])
def test_concurrent_emulation_matches_plain(S, Rm, K, dev, monkeypatch):
    """The concurrent schedule's one-card emulation (S shards, Rm merge
    rounds: S Rm sweep_mc launches at their block ranges from the
    round-start residual) against the same emulation through the plain
    sweep, at the kernel bar; bit-identical on a second run; group 0 bit
    for bit the one-device sweep's first blocks."""
    spec, args = _inputs("BayesR", dev, K=K, m=128)
    spec = dataclasses.replace(spec, shard_schedule="concurrent", emulate_shards=S,
                               merge_rounds=Rm)
    with launches() as got:
        out = TG._sweep_concurrent_emu_mc(spec, *args)
    assert got["sweep1_kernel" if K == 1 else "draws_kernel"] == (S * Rm if K == 1 else 8)
    again = TG._sweep_concurrent_emu_mc(spec, *args)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    mg = spec.m_pad // (S * Rm)
    one = TB.sweep_mc(spec, *args)
    assert torch.equal(out[0][:, :mg], one[0][:, :mg])
    assert torch.equal(out[1][:, :mg], one[1][:, :mg])
    monkeypatch.setattr(TB, "sweep_mc", plain_sweep_mc)
    ref = TG._sweep_concurrent_emu_mc(spec, *args)
    for k in range(K):
        _assert_bar(tuple(t[k] for t in ref), tuple(t[k] for t in out))


def test_tiled_rounds_build_each_schedule_once(dev, monkeypatch):
    """sbrm's concurrent rounds (``_tiled_sweep_snp_sharded`` at Rm = 2 on a
    one-rank mesh: two tiled_sweep launches at row_base 0 and nl/2) against
    the same rounds through the plain sweep at the bar with equal guard
    counts; over three sweeps each round's schedule is built once, kept in
    the data's plans by its row_base."""
    from hibayes_tpu_torch.parallel.mesh import make_mesh

    spec, data, g, r, P, _, _ = _s_problem("BayesR", "tiled", dev, m=2000)
    spec = dataclasses.replace(spec, shard_schedule="concurrent", merge_rounds=2)
    if data.ld_tiles.shape[0] % 2:
        pytest.skip("odd tile rows")
    mesh = make_mesh(device=dev)
    built = []
    real = TB.tiled_schedule
    monkeypatch.setattr(TB, "tiled_schedule", lambda *a, **k: built.append(1) or real(*a, **k))
    tally = torch.zeros(2, dtype=torch.int64, device=dev)
    with launches() as got:
        outs = [TSG._tiled_sweep_snp_sharded(spec, data, r, P, mesh, tally) for _ in range(3)]
    assert got["tiled_sweep_kernel"] == 6 and len(built) == 2
    assert all(torch.equal(a, b) for a, b in zip(outs[0], outs[2]))
    ptally = torch.zeros(2, dtype=torch.int64, device=dev)
    monkeypatch.setattr(TB, "sweep_s_tiled", TB.sweep_s_tiled_plain)
    ref = TSG._tiled_sweep_snp_sharded(spec, data, r, P, mesh, ptally)
    _assert_bar((g - ref[0], ref[1], None, ref[2]), (g - outs[0][0], outs[0][1], None,
                                                     outs[0][2]))
    assert torch.equal(tally, 3 * ptally)
