"""End-to-end `sbrm` of the port on the CPU against the JAX package: MCMC
posterior agreement on dense and tiled LD, the CG solver on every LD layout,
and the configurations the port refuses."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hibayes_tpu as hj
import hibayes_tpu_torch as ht
from hibayes_tpu.data.ld import BlockDiagLD as JBlockDiagLD
from hibayes_tpu.data.sparse_ld import TiledSparseLD as JTiledSparseLD
from hibayes_tpu_torch.parallel.mesh import make_mesh

from .torch_parity import s_sumstats

torch.set_num_threads(2)


def _lds(layout, R, Rp):
    """(JAX LD, port LD) of one matrix: dense R, two chromosome blocks of R,
    or the pruned R in tiles of 128 (masked slots in the band)."""
    if layout == "dense":
        return R, R
    if layout == "blockdiag":
        h = R.shape[0] // 2
        blocks = [R[:h, :h], R[h:, h:]]
        return (JBlockDiagLD(blocks=blocks, sizes=[h, h]),
                ht.BlockDiagLD(blocks=blocks, sizes=[h, h]))
    csr = sp.csr_matrix(Rp)
    return (JTiledSparseLD.from_scipy(csr, tile=128),
            ht.TiledSparseLD.from_scipy(csr, tile=128))


@pytest.mark.parametrize("layout,m", [("dense", 256), ("tiled", 512)])
def test_posterior_agrees_with_jax(layout, m):
    """Same summary statistics and LD, BayesCpi, one chain each (200 of 300
    iterations kept, 40 records).  The packages draw different random
    streams, so the posterior means differ by Monte-Carlo error only: the
    posterior-mean effects correlate at >= 0.99 (measured 0.9998-0.9999),
    and the means of Vg and h2 differ by less than one posterior standard
    deviation (three Monte-Carlo errors at an effective sample size of 18
    per chain).  On tiled LD the guard is on (SBayesS semantics) in both."""
    ss, R, Rp, b = s_sumstats(m, pruned=layout == "tiled")
    ld_j, ld_t = _lds(layout, R, Rp)
    kw = dict(method="BayesCpi", niter=300, nburn=100, verbose=False)
    ref = hj.sbrm(ss, ld_j, **kw)
    out = ht.sbrm(ss, ld_t, device="cpu", **kw)
    assert out.alpha.shape == (m,) and np.isfinite(out.alpha).all()
    assert np.corrcoef(ref.alpha, out.alpha)[0, 1] >= 0.99
    for k in ("Vg", "h2"):
        sd = np.concatenate([ref.MCMCsamples[k], out.MCMCsamples[k]]).std()
        assert abs(getattr(ref, k) - getattr(out, k)) < sd, k
    assert ((out.pip >= 0) & (out.pip < 1)).all() and out.pip.shape == (m,)
    assert np.corrcoef(out.alpha, b)[0, 1] > 0.95


@pytest.mark.parametrize("layout,m,lam", [("dense", 200, None), ("dense", 200, 0.05),
                                          ("blockdiag", 500, None), ("tiled", 500, 0.2)])
def test_cg_matches_jax(layout, m, lam):
    """method="CG" against the JAX package's ``_fit_cg`` (float64 here): the
    solutions to 1e-6 (the solver's stopping rule is a residual norm of
    1e-6; the two may stop an iteration apart), Vg, Ve and h2 too.  The
    pruned tiled LD is not positive definite, so it is solved with a ridge."""
    ss, R, Rp, _ = s_sumstats(m, pruned=layout == "tiled")
    ld_j, ld_t = _lds(layout, R, Rp)
    ref = hj.sbrm(ss, ld_j, method="CG", lambda_=lam, verbose=False)
    out = ht.sbrm(ss, ld_t, method="CG", lambda_=lam, verbose=False, device="cpu")
    np.testing.assert_allclose(out.alpha, ref.alpha, rtol=0, atol=1e-6)
    for k in ("Vg", "Ve", "h2"):
        assert abs(getattr(out, k) - getattr(ref, k)) < 1e-6, k


def _refusal_inputs():
    ss, R, Rp, _ = s_sumstats(256)
    return ss, R, Rp


@pytest.mark.parametrize("kw,item", [
    (dict(nchains=2), None),
    (dict(mesh=make_mesh()), None),
    (dict(shard_schedule="concurrent"), "item 14"),
])
def test_sbrm_refuses_what_is_not_ported(kw, item):
    """Nothing is refused any more (the name and the ids are from when the
    concurrent schedule was, citing item 14): a chain batch runs on every
    layout, a tiled LD included, and so does a mesh (the fit runs, with
    each chain's guard counts); the concurrent schedule without a mesh runs
    the exact sweep, as the JAX package does: bit for bit the "turn" fit
    (on a mesh: tests/test_torch_concurrent.py)."""
    ss, R, Rp = _refusal_inputs()
    ld = ht.TiledSparseLD.from_scipy(sp.csr_matrix(Rp), tile=128) if item is None else R
    fit = ht.sbrm(ss, ld, niter=20, nburn=10, verbose=False, device="cpu", **kw)
    if item is None:
        assert fit.guard.shape == (kw.get("nchains", 1), 2)
        assert np.isfinite([fit.Vg, fit.Ve]).all()
        return
    turn = ht.sbrm(ss, ld, niter=20, nburn=10, verbose=False, device="cpu")
    for k in ("Vg", "Ve", "h2"):
        np.testing.assert_array_equal(fit.MCMCsamples[k], turn.MCMCsamples[k], err_msg=k)
    np.testing.assert_array_equal(fit.alpha, turn.alpha)


@pytest.mark.parametrize("layout", ["sparse", "blockdiag", "tile64"])
def test_sbrm_refuses_mcmc_on_guarded_scan_layouts(layout):
    """SparseLD and BlockDiagLD (the segment sweep with the guard) and a
    tiled LD of tile 64 (the tiled sweep at B=64) run MCMC, as CG does.
    The name is from when these layouts were refused; nothing is refused
    any more (tiles the tiled sweep does not take as they are:
    :func:`test_sbrm_runs_mcmc_on_retiled_tiles`)."""
    ss, R, Rp = _refusal_inputs()
    if layout == "sparse":
        ld = ht.SparseLD.from_scipy(sp.csr_matrix(Rp))
    elif layout == "blockdiag":
        ld = ht.BlockDiagLD(blocks=[R[:128, :128], R[128:, 128:]], sizes=[128, 128])
    else:
        ld = ht.TiledSparseLD.from_scipy(sp.csr_matrix(Rp), tile=64)
    fit = ht.sbrm(ss, ld, niter=20, nburn=10, verbose=False, device="cpu")
    assert np.isfinite([fit.Vg, fit.Ve]).all() and fit.guard.shape == (1, 2)
    fit = ht.sbrm(ss, ld, method="CG", lambda_=0.2, verbose=False, device="cpu")
    assert np.isfinite(fit.alpha).all()


@pytest.mark.parametrize("tile", [10, 256])
def test_sbrm_runs_mcmc_on_retiled_tiles(tile):
    """Tiled LDs of tiles the tiled sweep does not take as they are, 10 (not
    a multiple of 4) and 256 (above 128), run MCMC, re-tiled for it
    (ops/blockgibbs.py:sub_block_tiles); tests/test_torch_shapes_sbrm.py
    holds them to the JAX package."""
    ss, _, Rp = _refusal_inputs()
    fit = ht.sbrm(ss, ht.TiledSparseLD.from_scipy(sp.csr_matrix(Rp), tile=tile),
                  niter=20, nburn=10, verbose=False, device="cpu")
    assert np.isfinite([fit.Vg, fit.Ve]).all() and fit.alpha.shape == (Rp.shape[0],)
    assert fit.guard.shape == (1, 2)


def test_entry_points_need_a_gpu_unless_told_cpu(monkeypatch):
    """device=None means "cuda": without a CUDA device both entry points
    raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ss, R, _ = _refusal_inputs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ht.sbrm(ss, R, niter=20, nburn=10, verbose=False)
    rng = np.random.default_rng(0)
    M = rng.binomial(2, 0.3, size=(30, 16)).astype(np.int8)
    ids = np.array([f"i{k}" for k in range(30)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ht.ibrm("T1 ~ 1", data={"id": ids, "T1": rng.normal(size=30)}, M=M,
                M_id=ids, niter=20, nburn=10, verbose=False)
