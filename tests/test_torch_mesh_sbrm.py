"""The port's SNP-sharded summary sweep: TPU kernel 9 on a shard of tile
rows (``sweep_s_tiled(..., row_base=)``, ops/blockgibbs.py) and the turn
schedule of engine/sgibbs.py on gloo ranks, against the JAX package.

* The plain tiled sweep of each shard of 4 at its row_base, against JAX's
  tiled kernel (interpret mode) at that row_base, f32, at the kernel bar:
  with and without the guard, and on a store the kernels re-tile (tiles of
  256 run as 128); the shards of 2 and of 4 swept in turn are the whole
  sweep bit for bit (f64).
* A shard's schedule (``tiled_schedule(cols, valid, row_base, nblocks)``):
  need and total against the whole layout's by direct counting, and a
  float64 emulation of the kernel's events in any order its counters
  allow, equal to the plain sweep at that row_base.
* ``one_s_iteration`` on (1, 2) and (1, 4) against JAX's
  ``one_s_iteration(mesh=...)`` (its XLA scans, the guard on but silent)
  to rtol 1e-9, and a short ``run_s_chain`` on the mesh bit for bit the
  one-device chain.

Sizes: m=500 (4 tile rows of 128, masked slots in the band); m=1,000 at
tiles of 256 for the re-tiled store.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hibayes_tpu.engine import sgibbs as SG
from hibayes_tpu.ops import blockgibbs as JB
from hibayes_tpu.parallel.mesh import make_mesh as jax_mesh
from hibayes_tpu.parallel.mesh import shard_sgibbs_data as jax_shard
from hibayes_tpu_torch.engine import sgibbs as TSG
from hibayes_tpu_torch.engine.convert import s_chain_state_from_numpy, sgibbs_data_from_numpy
from hibayes_tpu_torch.ops import blockgibbs as TB

from .test_torch_sgibbs import _sweep_inputs
from .torch_dist import RecordNoise, spawn
from .torch_parity import JaxNoise, assert_kernel_bar, port_spec, s_setup, tt

torch.set_num_threads(2)


@functools.cache
def _setup(model, layout="tiled", m=500, dtype=jnp.float32):
    return s_setup(model, layout, m=m, dtype=dtype)


def _shards(nbr, S):
    nl = nbr // S
    return [(k * nl, nl) for k in range(S)]


@pytest.mark.parametrize("model,guard,layout,m", [
    ("BayesCpi", False, "tiled", 500), ("BayesCpi", True, "tiled", 500),
    ("BayesR", False, "tiled", 500), ("BayesCpi", True, "tiled256", 1000)],
    ids=["cpi", "cpi-guard", "R", "cpi-guard-tile256"])
def test_shard_sweep_plain_matches_pallas_at_row_base(model, guard, layout, m):
    """Each shard of 4 (row_base 0 .. 3) swept alone at its row_base
    against the whole r_hat: the plain sweep against JAX's tiled kernel
    (interpret mode) at that row_base, f32, the kernel bar on (g, track,
    r_hat).  With ``guard`` the bound is lowered so that the guard rejects
    draws."""
    s = _setup(model, layout, m)
    spec, data = s["spec"], s["data"]
    if guard:
        spec = dataclasses.replace(spec, vary=2e-4)
    elif TB.guard_on(port_spec(spec)):
        spec = dataclasses.replace(spec, reject_guard=False)
    consts, P, r, g = _sweep_inputs({**s, "spec": spec})
    B = spec.block
    nbr = spec.m_pad // B
    rejected = 0
    for S in (4,):
        for b0, nl in _shards(nbr, S):
            sl = slice(b0 * B, (b0 + nl) * B)
            Pk = P[:, sl]
            P_blocks = jnp.asarray(Pk.reshape(Pk.shape[0], nl, B).transpose(1, 0, 2))
            dg_j, tr_j, r_j = JB.sweep_s_tiled(
                spec, consts, data.ld_tiles[b0:b0 + nl], data.ld_cols[b0:b0 + nl],
                data.ld_valid[b0:b0 + nl], r, P_blocks, spec.n, row_base=b0,
                interpret=True)
            dg_t, tr_t, r_t, rej = TB.sweep_s_tiled(
                port_spec(spec), tt(data.ld_tiles[b0:b0 + nl]), tt(data.ld_cols[b0:b0 + nl]),
                tt(data.ld_valid[b0:b0 + nl]), tt(r), tt(Pk), spec.n, row_base=b0)
            assert dg_t.shape == (nl * B,) and r_t.shape == (spec.m_pad,)
            rejected += int(rej)
            assert_kernel_bar((g[sl] - np.asarray(dg_j), tr_j, r_j),
                              (g[sl] - dg_t.numpy(), tr_t, r_t),
                              names=["g", "track", "yadj"])
    assert (rejected > 0) == guard


@pytest.mark.parametrize("layout,m", [("tiled", 500), ("tiled256", 1000)])
def test_shards_in_turn_are_the_whole_sweep(layout, m):
    """In f64 the shards of 2 and of 4 swept in turn, each at its row_base
    against the r_hat the one before left, give the whole sweep's dg,
    track, r_hat and rejection count bit for bit (the guard firing)."""
    s = _setup("BayesCpi", layout, m, jnp.float64)
    spec = port_spec(dataclasses.replace(s["spec"], vary=2e-4))
    d = sgibbs_data_from_numpy(s["data"])
    st = TSG.init_s_state(spec, d, s["pr"], s["pi"])
    from hibayes_tpu_torch.engine.rng import IterNoise

    P = TSG._s_pre_sweep(spec, d, IterNoise(1, 3, "cpu", torch.float64), st)["P"]
    ref = TB.sweep_s_tiled(spec, d.ld_tiles, d.ld_cols, d.ld_valid, st.r_hat, P, spec.n)
    B, nbr = spec.block, spec.m_pad // spec.block
    for S in (2, 4):
        if nbr % S:
            continue
        r, parts, rej = st.r_hat, [], 0
        for b0, nl in _shards(nbr, S):
            rows = slice(b0, b0 + nl)
            dg, tr, r, k = TB.sweep_s_tiled(spec, d.ld_tiles[rows], d.ld_cols[rows],
                                            d.ld_valid[rows], r, P[:, b0 * B:(b0 + nl) * B],
                                            spec.n, row_base=b0)
            parts.append((dg, tr))
            rej += int(k)
        assert torch.equal(torch.cat([p[0] for p in parts]), ref[0])
        assert torch.equal(torch.cat([p[1] for p in parts]), ref[1])
        assert torch.equal(r, ref[2]) and rej == int(ref[3]) > 0


def _band(nbr=24, K=9, seed=0, kind="band"):
    rng = np.random.default_rng(seed)
    half = K // 2
    i = np.arange(nbr)[:, None]
    offs = np.array([0] + [s * o for o in range(1, half + 1) for s in (-1, 1)])
    cols = i + offs[None, :]
    valid = (cols >= 0) & (cols < nbr)
    if kind == "gaps":
        valid[:, 1:] &= rng.random((nbr, K - 1)) < 0.6
    return np.where(valid, cols, i), valid


@pytest.mark.parametrize("kind", ["band", "gaps"])
@pytest.mark.parametrize("S", [2, 3, 4])
def test_shard_schedule_counts(kind, S):
    """A shard's need counts the contributions to each of its blocks from
    its own earlier rows, by direct counting: the whole layout's need less
    those of the rows before the shard; the shards' totals add up to the
    whole total; the last row's contribution to the next shard's block is
    an item, not the drawer's."""
    cols, valid = _band(kind=kind, seed=S)
    nbr = cols.shape[0]
    whole = TB.tiled_schedule(cols, valid)
    total = np.zeros(nbr, int)
    for b0, nl in _shards(nbr, S):
        sh = TB.tiled_schedule(cols[b0:b0 + nl], valid[b0:b0 + nl], b0, nbr)
        assert sh.nbr == nl and sh.nblocks == nbr and sh.row_base == b0
        earlier = np.zeros(nbr, int)
        for r in range(b0):
            for k in range(cols.shape[1]):
                if valid[r, k]:
                    earlier[cols[r, k]] += r < cols[r, k]
        np.testing.assert_array_equal(sh.need, (whole.need - earlier)[b0:b0 + nl])
        own = np.zeros(nbr, int)
        for r in range(b0, b0 + nl):
            for k in range(cols.shape[1]):
                own[cols[r, k]] += bool(valid[r, k])
        np.testing.assert_array_equal(sh.total, own)
        total += sh.total
        assert sh.nxt[-1] == -1
        assert (sh.items[:, 0] < nl).all() and (sh.items[:, 2] < nbr).all()
    np.testing.assert_array_equal(total, whole.total)


def _emulate_shard(spec, tiles, cols, valid, r_hat, P, n, sched, rng):
    """The kernel's events of one shard's launch in a random order its
    counters allow (tests/test_torch_tiled_schedule.py:_emulate, with the
    shard's local rows, global targets and counters counted from the
    launch's start)."""
    nbr, K, B, _ = tiles.shape
    rb0 = sched.row_base
    dt = r_hat.dtype
    vary = torch.tensor(spec.vary, dtype=dt) if TB.guard_on(spec) else None
    P_blocks = TB._summary_blocks(P, nbr, B, dt)
    r = r_hat.clone()
    rb = r.view(-1, B)
    dg = torch.empty((nbr * B,), dtype=dt)
    track = torch.empty((nbr * B,), dtype=dt)
    guard = torch.zeros((1, 2), dtype=torch.int64)
    items = [tuple(x) for x in sched.items.tolist()]
    items += [(i, int(k), rb0 + i + 1, int(sched.need[i + 1]) - 1)
              for i, k in enumerate(sched.nxt) if k >= 0]
    cnt = np.zeros(sched.nblocks, int)
    dgs = {}
    nxt_row = 0
    while nxt_row < nbr or items:
        if nxt_row < nbr and cnt[rb0 + nxt_row] == sched.need[nxt_row]:
            i = nxt_row
            T = tiles[i].to(dt)
            _, d, t = TB._draws_plain(spec, P_blocks[i], n * T[0], rb[rb0 + i, :, None],
                                      vary, guard)
            dgs[i] = d[:, 0]
            dg[i * B:(i + 1) * B], track[i * B:(i + 1) * B] = d[:, 0], t[:, 0]
            nxt_row += 1
            continue
        ready = [x for x in items if x[0] in dgs and cnt[x[2]] == x[3]]
        assert ready, "the schedule deadlocks"
        row, k, tgt, seq = ready[rng.integers(len(ready))]
        items.remove((row, k, tgt, seq))
        rb[tgt] += n * (dgs[row] @ tiles[row, k].to(dt))
        cnt[tgt] += 1
    np.testing.assert_array_equal(cnt, sched.total)
    return dg, track.to(torch.int32), r, guard[0, 0]


@pytest.mark.parametrize("S", [2, 4])
def test_emulated_shard_schedule_equals_plain_sweep(S):
    """In f64, every shard's events in three random orders its schedule's
    counters allow give the plain sweep at its row_base bit for bit."""
    s = _setup("BayesCpi", "tiled", 500, jnp.float64)
    spec = port_spec(dataclasses.replace(s["spec"], vary=2e-4))
    d = sgibbs_data_from_numpy(s["data"])
    st = TSG.init_s_state(spec, d, s["pr"], s["pi"])
    from hibayes_tpu_torch.engine.rng import IterNoise

    P = TSG._s_pre_sweep(spec, d, IterNoise(2, 3, "cpu", torch.float64), st)["P"]
    B, nbr = spec.block, spec.m_pad // spec.block
    r = st.r_hat
    for b0, nl in _shards(nbr, S):
        rows = slice(b0, b0 + nl)
        args = (spec, d.ld_tiles[rows], d.ld_cols[rows], d.ld_valid[rows], r,
                P[:, b0 * B:(b0 + nl) * B], spec.n)
        ref = TB.sweep_s_tiled_plain(*args, row_base=b0)
        sched = TB.tiled_schedule(d.ld_cols[rows], d.ld_valid[rows], b0, nbr)
        for seed in range(3):
            out = _emulate_shard(*args, sched, np.random.default_rng(seed))
            for a, b in zip(ref, out):
                assert torch.equal(a, b)
        r = ref[2]


@functools.cache
def _iteration_case(model):
    """JAX's iteration 2 from its own iteration 1 (f64, the guard on and
    silent), JAX's numbers recorded through the port's one-device call."""
    s = _setup(model, "tiled", 500, jnp.float64)
    spec, data = s["spec"], s["data"]
    key = jax.random.PRNGKey(5)
    step = jax.jit(lambda st: SG.one_s_iteration(spec, data, key, st))
    state = step(SG.init_s_state(spec, data, s["pr"], s["pi"]))
    rec = RecordNoise(JaxNoise(key, int(state.it)))
    ref1 = TSG.one_s_iteration(port_spec(spec), sgibbs_data_from_numpy(data), 0,
                               s_chain_state_from_numpy(state), noise=rec)
    return s, state, rec.table, ref1


def _jax_mesh_iteration(spec, data, state, shape):
    mesh = jax_mesh(shape[0] * shape[1], shape=shape)
    with mesh:
        step = jax.jit(functools.partial(SG.one_s_iteration, spec, mesh=mesh))
        return step(jax_shard(data, mesh), jax.random.PRNGKey(5), state)


@pytest.mark.parametrize("model,shape", [("BayesCpi", (1, 2)), ("BayesR", (1, 4))],
                         ids=["cpi-1x2", "R-1x4"])
def test_one_s_iteration_on_mesh_matches_jax(model, shape, tmp_path):
    """One summary iteration on the snp mesh (each rank sweeping its tile
    rows in turn through the tiled sweep at its row_base) against JAX's
    ``one_s_iteration(mesh=...)`` on as many virtual devices: every field
    to rtol 1e-9, no guard rejection (JAX's scan and the port's
    candidates agree only then); and a short chain on the mesh, bit for
    bit the one-device chain, guard counts included."""
    s, state, table, _ = _iteration_case(model)
    spec, data = s["spec"], s["data"]
    ref = _jax_mesh_iteration(spec, data, state, shape)
    chain_spec = dataclasses.replace(spec, niter=9, thin=2)   # 4 records
    payload = dict(shape=shape, spec=dataclasses.asdict(chain_spec),
                   data=jax.tree_util.tree_map(np.array, data._asdict()),
                   state=jax.tree_util.tree_map(np.array, state._asdict()), table=table,
                   priors=dataclasses.asdict(s["pr"]), pi=s["pi"])
    outs = spawn("tests.torch_dist:sgibbs_cases", shape[0] * shape[1], tmp_path, payload)
    _, smp1, ex1 = TSG.run_s_chain(port_spec(chain_spec), sgibbs_data_from_numpy(data),
                                   s["pr"], s["pi"], seed=3)
    for o in outs:
        out, tally = o["one"]
        assert tally.tolist() == [0, 0]
        for name in TSG.SChainState._fields[1:]:
            a, b = np.asarray(getattr(ref, name)), out[name]
            if name == "track":
                np.testing.assert_array_equal(b, a)
            else:
                np.testing.assert_allclose(
                    b, a, rtol=1e-9, atol=1e-9 * (np.abs(a).max() if a.size else 0),
                    err_msg=name)
        smp, guard = o["chain"]
        for k in smp1:
            np.testing.assert_array_equal(smp[k], smp1[k], err_msg=k)
        np.testing.assert_array_equal(guard, ex1["guard"])
