"""Tests of the CUDA kernels that need the card.  They carry the ``gpu``
marker and skip without a CUDA device.  They import no JAX, so they run on
the GPU machine (which has none) without the JAX conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from hibayes_tpu_torch.engine import gibbs as TG
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


def _inputs(model, dev, K=2, n=300, m=80, B=16, int8=True):
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
                                 device=dev)
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
    a sweep over nbg blocks is nbg + 1 rows_kernel and nbg draws_kernel
    launches, and does not count as a block_draws call."""
    spec, args = _inputs("BayesCpi", dev, K=2)
    TB.sweep_mc(spec, *args)
    TB.reset_kernel_launches()
    before = (TB.sweep_mc.launches, TB.block_draws.launches)
    TB.sweep_mc(spec, *args)
    nbg = spec.nblocks
    assert TB.kernel_launches() == {"rows_kernel": nbg + 1, "draws_kernel": nbg}
    assert (TB.sweep_mc.launches, TB.block_draws.launches) == (before[0] + 1, before[1])


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
