"""Where the port keeps what its sweeps make between calls, on the CPU.

Every builder of a ``GibbsData`` or ``SGibbsData`` gives it a fresh, empty
``plans`` dict, a part cut for a rank of a mesh gets one of its own, and the
engine passes its data's to the sweeps (ops/blockgibbs.py), which keep
their layouts there: made at the first sweep over a data object, for it
alone, so that two data objects swept in turn never share or rebuild one.
The stores here need re-tiling (tiles and blocks of 30, the kernels' width
32), so that the plain sweeps on the CPU build what the card's route keeps.
"""

import numpy as np
import torch

from hibayes_tpu_torch.data.ld import BlockDiagLD
from hibayes_tpu_torch.data.sparse_ld import TiledSparseLD
from hibayes_tpu_torch.engine import gibbs as TG
from hibayes_tpu_torch.engine import sgibbs as TSG
from hibayes_tpu_torch.engine.rng import IterNoise
from hibayes_tpu_torch.ops import blockgibbs as TB
from hibayes_tpu_torch.parallel.mesh import Mesh, shard_gibbs_data, shard_sgibbs_data

T = 30   # a tile and block the kernels take as 32 wide: every layout is a copy


def _ld(m, seed):
    idx = np.arange(m)
    R = 0.7 ** np.abs(idx[:, None] - idx[None, :])
    R[np.abs(idx[:, None] // T - idx[None, :] // T) > 1] = 0.0
    b = np.where(np.random.default_rng(seed).random(m) < 0.1, 0.1, 0.0)
    ss = np.column_stack([np.full(m, 0.3), R @ b, np.full(m, 0.01), np.full(m, 1e4)])
    return R, ss


def _summary(layout, seed, m=150):
    """A BayesCpi summary problem on a tiled LD in tiles of T, or on a
    BlockDiagLD of two blocks in blocks of T: (spec, data, priors, pi)."""
    R, ss = _ld(m, seed)
    if layout == "tiled":
        ld = TiledSparseLD.from_dense(R, tile=T)
    else:
        h = m // 2
        ld = BlockDiagLD(blocks=[R[:h, :h], R[h:, h:]], sizes=[h, m - h])
    data, n, vary, nvar0, seg_sizes, seg_real = TSG.prepare_sgibbs_data(
        ss, ld, block=T, dtype=torch.float64, device="cpu")
    pi = np.array([0.95, 0.05])
    pr = TG.resolve_priors(None, float(ld.diag.sum()), pi[0], nr=0, vary=vary)
    spec = TG.GibbsSpec(
        model="BayesCpi", n=n, m=m, m_pad=int(sum(seg_sizes)), block=T, nc=0, nlevels=(),
        n_fold=2, niter=6, nburn=2, thin=2, nvar0=nvar0, dfvara=pr.dfvara,
        s2vara=pr.s2vara, dfvare=pr.dfvare, s2vare=pr.s2vare, s2varg=pr.s2varg,
        lambda_rate0=pr.lambda_rate0, vargl_strict_pos=True, real_excl_nvar0=True,
        reject_guard=True, vary=vary, seg_sizes=seg_sizes, seg_real=seg_real)
    return spec, data, pr, pi


def _counted(monkeypatch, name):
    """Calls of ``blockgibbs.<name>`` from here on, one entry a call."""
    calls = []
    real = getattr(TB, name)
    monkeypatch.setattr(TB, name, lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


def _iterate(spec, data, pr, pi, its):
    st = TSG.init_s_state(spec, data, pr, pi)
    out = []
    for _ in range(its):
        st = TSG.one_s_iteration(spec, data, 7, st)
        out.append(st)
    return out


def _same_chain(a, b):
    for sa, sb in zip(a, b):
        for name in TSG.SChainState._fields[1:]:
            assert torch.equal(getattr(sa, name), getattr(sb, name)), name


def test_two_tiled_data_keep_separate_plans(monkeypatch):
    """Two tiled data objects swept in turn: each keeps its own re-tiled
    store in its own plans, made at its first sweep (two builds over three
    iterations of each), and each chain is bit for bit the chain of its
    data swept alone."""
    a, b = _summary("tiled", 1), _summary("tiled", 2)
    alone = [_iterate(*p, 3) for p in (_summary("tiled", 1), _summary("tiled", 2))]
    built = _counted(monkeypatch, "sub_block_tiles")
    sts = [TSG.init_s_state(spec, data, pr, pi) for spec, data, pr, pi in (a, b)]
    chains = [[], []]
    for _ in range(3):
        for k, (spec, data, _, _) in enumerate((a, b)):
            sts[k] = TSG.one_s_iteration(spec, data, 7, sts[k])
            chains[k].append(sts[k])
    assert len(built) == 2
    key = ("tiles", TB.tiled_sub_blocks(a[0], T), 0, a[1].ld_tiles.shape[0])
    assert set(a[1].plans) == set(b[1].plans) == {key}
    assert a[1].plans[key][0] is not b[1].plans[key][0]
    for chain, ref in zip(chains, alone):
        _same_chain(chain, ref)


def test_row_runs_at_one_row_base_keep_separate_stores(monkeypatch):
    """Two runs of a store's rows from one row_base (the first half, then
    every row) swept in turn with one plans dict: each keeps a re-tiled
    store of its own rows (two builds over two sweeps of each), and each
    sweep is bit for bit the same sweep with no plans."""
    spec, data, pr, pi = _summary("tiled", 8)
    st = TSG.init_s_state(spec, data, pr, pi)
    P = TSG._s_pre_sweep(spec, data, IterNoise(3, 0, "cpu"), st)["P"]
    tiles, cols, valid = data.ld_tiles, data.ld_cols, data.ld_valid
    h = tiles.shape[0] // 2
    runs = [(tiles[:h], cols[:h], valid[:h], P[:, :h * T]), (tiles, cols, valid, P)]
    alone = [TB.sweep_s_tiled(spec, *run[:3], data.xy, run[3], spec.n) for run in runs]
    built = _counted(monkeypatch, "sub_block_tiles")
    plans = {}
    for _ in range(2):
        for run, ref in zip(runs, alone):
            got = TB.sweep_s_tiled(spec, *run[:3], data.xy, run[3], spec.n, plans=plans)
            for x, y in zip(got, ref):
                assert torch.equal(x, y)
    assert len(built) == 2 and len(plans) == 2


def test_two_segment_data_keep_separate_plans(monkeypatch):
    """Two BlockDiagLD data objects of two segments swept in turn: each
    segment of each keeps its sub-blocked copy in plans of its own (four
    builds over three iterations of each), and each chain is bit for bit
    its data's swept alone."""
    a, b = _summary("blockdiag", 3), _summary("blockdiag", 4)
    alone = [_iterate(*p, 3) for p in (_summary("blockdiag", 3), _summary("blockdiag", 4))]
    built = _counted(monkeypatch, "sub_block_segment")
    sts = [TSG.init_s_state(spec, data, pr, pi) for spec, data, pr, pi in (a, b)]
    chains = [[], []]
    for _ in range(3):
        for k, (spec, data, _, _) in enumerate((a, b)):
            sts[k] = TSG.one_s_iteration(spec, data, 7, sts[k])
            chains[k].append(sts[k])
    assert len(built) == 4
    assert set(a[1].plans) == set(b[1].plans) == {("segment", 0), ("segment", 1)}
    sb = TB.segment_sub_blocks(a[0], T)
    copies = [d.plans[("segment", i)][("segment", sb)] for d in (a[1], b[1]) for i in (0, 1)]
    assert len({id(c) for c in copies}) == 4
    for chain, ref in zip(chains, alone):
        _same_chain(chain, ref)


def test_run_s_chain_twice_builds_its_layout_once(monkeypatch):
    """Two runs of one chain on one data object (a warm-up, then the run
    that counts) re-tile the store once, at the first run's first sweep,
    and give the same chain bit for bit."""
    spec, data, pr, pi = _summary("tiled", 5)
    built = _counted(monkeypatch, "sub_block_tiles")
    runs = [TSG.run_s_chain(spec, data, pr, pi, seed=11) for _ in range(2)]
    assert len(built) == 1
    _same_chain([runs[0][0]], [runs[1][0]])
    for k, v in runs[0][1].items():
        np.testing.assert_array_equal(v, runs[1][1][k], err_msg=k)


def _mesh(shape):
    """This process as rank 0 of a mesh of ``shape`` (ind, snp): what the
    cuts read of a mesh, with no process group."""
    return Mesh(dict(zip(("ind", "snp"), shape)), 0, {"ind": 0, "snp": 0}, {}, {}, "cpu")


def test_builders_and_cuts_give_fresh_plans():
    """prepare_gibbs_data and prepare_sgibbs_data give each data object an
    empty plans dict of its own; a part cut for a rank gets its own, never
    the whole data's; a part cut again, with nothing left to cut, is
    returned as it is, its plans with it."""
    rng = np.random.default_rng(0)
    M = rng.binomial(2, 0.3, (40, 64)).astype(np.int8)
    y = rng.normal(size=40)
    one, two = (TG.prepare_gibbs_data(y, M, block=16, device="cpu") for _ in range(2))
    assert one.plans == {} and two.plans == {} and one.plans is not two.plans
    one.plans["made"] = True
    for shape in ((1, 2), (2, 1)):
        part = shard_gibbs_data(one, _mesh(shape))
        assert part.plans == {} and part.plans is not one.plans
        assert shard_gibbs_data(part, _mesh(shape), TG.GibbsSpec(
            model="BayesCpi", n=40, m=64, m_pad=64, block=16, nc=0, nlevels=(), n_fold=2,
            niter=2, nburn=1, thin=1, nvar0=0, dfvara=4.0, s2vara=1.0, dfvare=4.0,
            s2vare=1.0, s2varg=1.0, lambda_rate0=1.0)) is part
    spec, data, _, _ = _summary("tiled", 6, m=120)
    data.plans["made"] = True
    part = shard_sgibbs_data(data, _mesh((1, 2)))
    assert part.plans == {} and part.plans is not data.plans
    assert shard_sgibbs_data(part, _mesh((1, 2))) is part
