"""Sums by level with no host read (engine/gibbs.py:_segment_sum,
_epsl_matvec): the factor's and the imputed rows' sort order and segment
offsets are made, and checked, once where the data is made; the iteration
then sums with no argsort, no bincount and no checked segment_reduce.  The
sums are bit for bit those of an argsort and a checked segment_reduce over
the level counts, the form they replace (kept here as the reference)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from hibayes_tpu_torch.engine import gibbs as TG
from hibayes_tpu_torch.parallel.mesh import Mesh, shard_gibbs_data

torch.set_num_threads(2)

NLEV = 6


def _reference_sum(values, codes, lengths):
    """An argsort of the codes and a checked segment_reduce over ``lengths``."""
    order = torch.argsort(codes, stable=True)
    if values.dim() == 1:
        return torch.segment_reduce(values[order], "sum", lengths=lengths)
    return torch.segment_reduce(values[:, order].T, "sum", lengths=lengths).T


def _values(K, n, seed):
    """Values of mixed magnitudes, so that another order of additions
    would round otherwise."""
    g = torch.Generator().manual_seed(seed)
    shape = (n,) if K == 1 else (K, n)
    return torch.randn(shape, generator=g) * 10.0 ** torch.randint(-3, 4, shape, generator=g)


def _ind_mesh(size, i):
    """Rank i's view of a mesh of ``size`` ranks on ``ind`` (no process
    group: shard_gibbs_data only cuts)."""
    return Mesh({"ind": size, "snp": 1}, i, {"ind": i, "snp": 0}, {}, {}, "cpu")


def _factor_data(case, seed=3):
    """GibbsData with one factor of NLEV levels: ``plain`` n=300; ``padded``
    n=600 padded to 1,024 rows (the padded rows in level 0);
    ``empty_level`` with no row at levels 2 and 5."""
    rng = np.random.default_rng(seed)
    n = 600 if case == "padded" else 300
    levels = [0, 1, 3, 4] if case == "empty_level" else list(range(NLEV))
    codes = rng.choice(levels, n)
    M = rng.binomial(2, 0.3, (n, 8)).astype(np.int8)
    y = rng.normal(size=n)
    data = TG.prepare_gibbs_data(y, M, r_codes=(codes,), r_nlevels=(NLEV,), block=8,
                                 geno_dtype="int8", pad_n=case == "padded")
    return data, n


def _epsl_data(seed=4, n_g=50, ne=40, qe=90):
    """GibbsData with the single-step term: ne imputed rows of qe sites
    (most sites hold no row, some hold two), A a sparse tridiagonal."""
    rng = np.random.default_rng(seed)
    n = n_g + ne
    A = sps.diags([np.full(qe - 1, -0.5), np.full(qe, 2.0), np.full(qe - 1, -0.5)],
                  [-1, 0, 1], format="csc")
    codes = rng.choice(qe, ne)
    M = rng.binomial(2, 0.3, (n, 8)).astype(np.float64)
    yJ = np.concatenate([-np.ones(n_g), rng.uniform(-1, 0, ne)])
    return TG.prepare_gibbs_data(
        rng.normal(size=n), M, r_codes=(rng.integers(0, 4, n),), r_nlevels=(4,),
        epsl_yJ=yJ, epsl_A=A, epsl_codes=codes, qe=qe, block=8,
        dtype=torch.float64), n, ne


def _assert_same(values, seg, codes, lengths):
    new, ref = TG._segment_sum(values, seg), _reference_sum(values, codes, lengths)
    assert new.shape == ref.shape and new.dtype == ref.dtype
    assert torch.equal(new, ref)


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("case", ["plain", "padded", "empty_level"])
def test_factor_sum_is_the_argsort_form_bit_for_bit(case, K):
    """The one-device factor sum, with the lengths the iteration used to
    make: the level counts, plus the padded rows in level 0."""
    data, n_obs = _factor_data(case)
    n = int(data.y.shape[0])
    lengths = data.r_counts[0].to(torch.int64)
    if n != n_obs:
        lengths = torch.cat([lengths[:1] + (n - n_obs), lengths[1:]])
    if case == "empty_level":
        assert (lengths[[2, 5]] == 0).all()
    _assert_same(_values(K, n, 7), data.r_segs[0], data.r_codes[0], lengths)


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("size", [2, 3])
def test_ind_part_factor_sum_is_the_argsort_form_bit_for_bit(size, K):
    """Each rank's part of padded rows (the last rank's holds the padded
    ones): the factor sum over its rows, with the lengths the iteration used
    to count there each time."""
    data, _ = _factor_data("padded")
    for i in range(size):
        part = shard_gibbs_data(data, _ind_mesh(size, i))
        codes = part.r_codes[0]
        _assert_same(_values(K, codes.shape[0], 11 + i), part.r_segs[0], codes,
                     torch.bincount(codes, minlength=NLEV))


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("size", [1, 2, 3])
def test_epsilon_sum_is_the_argsort_form_bit_for_bit(size, K):
    """The imputed rows' per-site sum on one device (size 1: the lengths
    were the site counts) and on each rank's part of an ind mesh (the
    rank's imputed rows, the lengths counted over them)."""
    data, n, ne = _epsl_data()
    qe_pad = int(data.epsl_counts.shape[0])
    for i in range(size):
        part = data if size == 1 else shard_gibbs_data(data, _ind_mesh(size, i))
        r0, nr = (0, n) if size == 1 else _ind_mesh(size, i).row_range(n)
        t0, c0 = TG.epsl_part(n, ne, r0, nr)
        codes = data.epsl_codes[c0:c0 + nr - t0]
        lengths = (data.epsl_counts.to(torch.int64) if size == 1
                   else torch.bincount(codes, minlength=qe_pad))
        values = _values(K, nr, 13 + i).to(torch.float64)[..., t0:]
        _assert_same(values, part.epsl_segs, codes, lengths)


def test_epsilon_matvec_is_the_checked_form_bit_for_bit():
    data, _, _ = _epsl_data()
    sp = data.epsl_sp
    for K in (1, 4):
        x = _values(K, sp.coo_len.shape[0], 17).to(torch.float64)
        xt = x[:, None] if K == 1 else x.T
        ref = TG.segment_matmul(sp.coo_len, sp.coo_cols, sp.coo_vals, xt)
        assert torch.equal(TG._epsl_matvec(sp, x), ref[:, 0] if K == 1 else ref.T)


def test_bad_lengths_are_refused_at_set_up():
    """A code outside its levels, or a row of A outside its sites, would
    make a length the iteration no longer checks: prepare_gibbs_data and
    the epsilon layout refuse them."""
    rng = np.random.default_rng(0)
    n = 40
    M = rng.binomial(2, 0.3, (n, 8)).astype(np.float64)
    y = rng.normal(size=n)
    for bad in (NLEV, -1):
        codes = rng.integers(0, NLEV, n)
        codes[5] = bad
        with pytest.raises(ValueError, match="level codes"):
            TG.prepare_gibbs_data(y, M, r_codes=(codes,), r_nlevels=(NLEV,), block=8)
    A = sps.identity(12, format="csc")     # blocks of 8: 16 sites, 4 of them padding
    for bad in (16, -1):
        codes = rng.integers(0, 12, 10)
        codes[2] = bad
        with pytest.raises(ValueError, match="level codes"):
            TG.prepare_gibbs_data(y, M, epsl_yJ=np.ones(n), epsl_A=A, epsl_codes=codes,
                                  qe=12, block=8)
    rows, cols = np.arange(16), np.arange(16)
    rows[3] = 16
    with pytest.raises(ValueError, match="A's row indices"):
        TG._epsl_layout(np.zeros((2, 8, 8)), [], (rows, cols, np.ones(16)), 16,
                        torch.float64, "cpu")


# ---------------------------------------------------------------------------
# a guard against the host reads coming back
# ---------------------------------------------------------------------------


ENGINE = (("engine", "gibbs.py"), ("math", "solvers.py"), ("parallel", "mesh.py"))


@pytest.fixture
def calls(monkeypatch):
    """Every torch.argsort, torch.bincount and torch.segment_reduce call:
    (name, the calling file's last two path parts, the calling function,
    whether segment_reduce checks its lengths)."""
    out = []
    for name in ("argsort", "bincount", "segment_reduce"):
        def wrap(*a, _real=getattr(torch, name), _name=name, **kw):
            f = sys._getframe(1).f_code
            out.append((_name, Path(f.co_filename).parts[-2:], f.co_name,
                        _name == "segment_reduce" and not kw.get("unsafe", False)))
            return _real(*a, **kw)
        monkeypatch.setattr(torch, name, wrap)
    return out


def _engine_calls(calls):
    return [c for c in calls if c[1] in ENGINE]


def _ibrm(n=120, m=40):
    rng = np.random.default_rng(5)
    M = rng.binomial(2, 0.3, (n, m)).astype(np.int8)
    y = M @ rng.normal(0, 0.1, m) + rng.normal(0, 1, n)
    data = TG.prepare_gibbs_data(y, M, C=rng.normal(size=(n, 1)),
                                 r_codes=(rng.integers(0, 4, n),), r_nlevels=(4,),
                                 block=16, geno_dtype="int8")
    pr = TG.resolve_priors(y, float(data.vx.sum()), 0.95, nr=1)
    spec = TG.GibbsSpec(
        model="BayesCpi", n=n, m=m, m_pad=int(data.xpx.shape[0]), block=16, nc=1,
        nlevels=(4,), n_fold=2, niter=4, nburn=2, thin=2, nvar0=0, dfvara=pr.dfvara,
        s2vara=pr.s2vara, dfvare=pr.dfvare, s2vare=pr.s2vare, dfr=pr.dfr, s2r=pr.s2r,
        s2varg=pr.s2varg)
    return spec, data, pr, np.array([0.95, 0.05])


def _ssbrm():
    data, n, ne = _epsl_data()
    y = data.y.numpy()
    pr = TG.resolve_priors(y, float(data.vx.sum()), 0.95, nr=1)
    spec = TG.GibbsSpec(
        model="BayesCpi", n=n, m=8, m_pad=int(data.xpx.shape[0]), block=8, nc=0,
        nlevels=(4,), n_fold=2, niter=4, nburn=2, thin=2, nvar0=0, dfvara=pr.dfvara,
        s2vara=pr.s2vara, dfvare=pr.dfvare, s2vare=pr.s2vare, dfr=pr.dfr, s2r=pr.s2r,
        s2varg=pr.s2varg, ne=ne, qe=90, qe_pad=int(data.epsl_counts.shape[0]))
    return spec, data, pr, np.array([0.95, 0.05])


@pytest.mark.parametrize("fit", ["ibrm", "ibrm_batch", "ssbrm"])
def test_iterations_make_no_checked_sum(fit, calls):
    """A few iterations of an ibrm with a factor (one chain and a batch) and
    of an ssbrm with the epsilon term: the engine's own sums call no
    argsort, no bincount and no checked segment_reduce.  (The epsilon
    sweep's plain CPU version, ops/blockgibbs.py, stands in for a CUDA
    kernel and is not the engine's.)"""
    spec, data, pr, pi = _ssbrm() if fit == "ssbrm" else _ibrm()
    calls.clear()
    if fit == "ibrm_batch":
        TG.run_chains(spec, data, pr, pi, seed=2, nchains=3)
    else:
        TG.run_chain(spec, data, pr, pi, seed=2)
    mine = _engine_calls(calls)
    assert [c for c in mine if c[0] != "segment_reduce" or c[3]] == []
    # the sums did run, unchecked: the factor's each iteration, and on
    # ssbrm the epsilon term's per-site sum and its two matvecs
    per_iter = {"_segment_sum": 2, "segment_matmul": 2} if fit == "ssbrm" else {
        "_segment_sum": 1}
    for fn, k in per_iter.items():
        assert sum(c[2] == fn for c in mine) == k * spec.niter, fn
