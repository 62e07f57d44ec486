"""The relaxed ``concurrent`` shard schedule of the port against the JAX
package, float64 on the CPU with JAX's own random numbers.

* The one-device emulation (``emulate_shards`` S, ``merge_rounds`` Rm,
  engine/gibbs.py:_sweep_concurrent_emu_mc): the sweep against JAX's for
  S in {2, 4} each with Rm in {1, 2}, K in {1, 3}, BayesCpi and BayesR,
  and at blocks of 256 (run as sub-blocks of 128); one iteration and ten
  of ``one_iteration`` and ``one_iteration_batch`` against JAX's.
* The meshed sweep on gloo ranks (tests/torch_dist.py, one spawn a world
  size) against JAX's meshed run on its virtual CPU devices: (1, 2),
  (1, 4) and (2, 2) (the ind hybrid), Rm 1 and 2, K 1 and 3; on (1, 2) at
  Rm 1 bit for bit the emulation at S = 2; a 30-iteration chain on (1, 4)
  at Rm 2 against the emulation, the same Markov kernel, to rtol 1e-8.
* Identities of the schedule: group 0 is the exact sweep's first blocks
  bit for bit; the merged residuals are the recomputed ones; with neither
  shards nor emulation "concurrent" is the exact chain bit for bit.
* sbrm: the tiled sweep in merge rounds (engine/sgibbs.py) on (1, 2) at
  Rm 1 and (1, 4) at Rm 2 against JAX's meshed ``one_s_iteration``, the
  guard on, JAX's own first 8 redraws as its candidates and none
  exhausted; each round's schedule made once.
* The m > n warning and the ValueErrors, word for word JAX's.

Sizes: n=96, m=64 in blocks of 8 (8 blocks, so every S Rm divides them;
m <= n, so no warning); m=512 in blocks of 256 at n=600; sbrm m=500 in
tiles of 64 (8 tile rows).
"""

import dataclasses
import functools
import threading
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hibayes_tpu.engine import gibbs as G
from hibayes_tpu.engine import sgibbs as SG
from hibayes_tpu.parallel.mesh import make_mesh as jax_mesh
from hibayes_tpu.parallel.mesh import shard_gibbs_data as jax_shard
from hibayes_tpu.parallel.mesh import shard_sgibbs_data as jax_shard_s
from hibayes_tpu.parallel.mesh import shard_state as jax_shard_state
from hibayes_tpu_torch.engine import gibbs as TG
from hibayes_tpu_torch.engine import sgibbs as TSG
from hibayes_tpu_torch.engine.convert import (chain_state_from_numpy, gibbs_data_from_numpy,
                                              s_chain_state_from_numpy, sgibbs_data_from_numpy)
from hibayes_tpu_torch.engine.rng import IterNoise
from hibayes_tpu_torch.ops import blockgibbs as TB

from .test_torch_sgibbs_guard import JaxRedrawNoise
from .torch_dist import RecordNoise, as_numpy, spawn
from .torch_parity import (JaxNoise, model_setup, port_spec, s_setup, stack_states,
                           sweep_inputs, with_sparse_effects)

torch.set_num_threads(2)

KEY = 5
SWEEP_NAMES = ("g", "track", "vargL", "yadj", "u", "vargi", "vargR")


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x), tree)


@functools.cache
def _setup(model, B=8, m=64, n=96):
    """A mid-run BayesCpi or BayesR chain (float64)."""
    s = model_setup(model, n=n, m=m, B=B, dtype=jnp.float64, warm=0)
    s = with_sparse_effects(s, seed=7)
    return {**s, "spec": dataclasses.replace(s["spec"], niter=30, nburn=10)}


def _conc(spec, S=0, Rm=1):
    return dataclasses.replace(spec, shard_schedule="concurrent", emulate_shards=S,
                               merge_rounds=Rm)


def _close(ref, out, names, rtol=1e-10):
    """Each field to rtol (atol rtol of the field's scale); track equal."""
    for name in names:
        a, b = np.asarray(ref[name]), np.asarray(out[name])
        assert a.shape == b.shape, name
        if name == "track":
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=rtol,
                                       atol=rtol * (np.abs(a).max() if a.size else 0),
                                       err_msg=name)


def _state_close(ref, out, rtol=1e-10):
    ref = ref if isinstance(ref, dict) else _np(ref._asdict())
    out = out if isinstance(out, dict) else as_numpy(out)
    for name in TG.ChainState._fields[1:]:
        for a, b in (zip(ref[name], out[name]) if isinstance(out[name], tuple)
                     else [(ref[name], out[name])]):
            _close({name: a}, {name: b}, [name], rtol)


# ---------------------------------------------------------------------------
# the one-device emulation against JAX's
# ---------------------------------------------------------------------------

# every S with every Rm once, each K and model twice
GRID = [(2, 1, 1, "BayesCpi"), (2, 2, 3, "BayesR"), (4, 1, 3, "BayesCpi"),
        (4, 2, 1, "BayesR")]


@pytest.mark.parametrize("S,Rm,K,model,B", [g + (8,) for g in GRID] + [(2, 1, 1, "BayesR", 256)],
                         ids=[f"S{g[0]}-Rm{g[1]}-K{g[2]}-{g[3]}" for g in GRID] + ["block256"])
def test_emulated_sweep_matches_jax(S, Rm, K, model, B):
    """The concurrent emulation's sweep from the same inputs (each chain's
    pre-sweep drawn by JAX's engine) against JAX's
    ``_sweep_concurrent_emu_mc``: effects, mixture draws, local variances,
    merged residuals and the variance sums to rtol 1e-10.  At blocks of 256
    the port sweeps sub-blocks of 128, and S counts blocks of 256."""
    s = _setup(model, B, 512, 600) if B == 256 else _setup(model)
    spec = _conc(s["spec"], S, Rm)
    ja, ta = sweep_inputs({**s, "spec": spec}, K)
    ref = jax.jit(functools.partial(G._sweep_concurrent_emu_mc, spec, interpret=True))(*ja)
    d = gibbs_data_from_numpy(s["data"])
    if B == 256:
        assert d.X_blocks.shape[0] == 2 * spec.nblocks   # two sub-blocks a block
    out = TG._sweep_concurrent_emu_mc(port_spec(spec), ta[0], d.X_blocks, d.W_blocks, *ta[3:])
    _close(dict(zip(SWEEP_NAMES, _np(ref))), dict(zip(SWEEP_NAMES, as_numpy(out))),
           SWEEP_NAMES)


def _chain_states(s, K):
    states = stack_states([with_sparse_effects(s, seed=9 + k)["state"] for k in range(K)])
    return states, jax.random.split(jax.random.PRNGKey(6), K)


@pytest.mark.parametrize("kind,model,S,Rm", [("one", "BayesR", 2, 2),
                                             ("batch", "BayesCpi", 4, 1)])
def test_emulated_iterations_match_jax(kind, model, S, Rm):
    """``one_iteration`` (K = 1) and ``one_iteration_batch`` (K = 3) with
    concurrent and emulate_shards S route to the emulation, as JAX's do
    (hibayes_tpu/engine/gibbs.py:749-758, :2408-2418): the state after one
    iteration and after ten, each iteration with JAX's numbers, against
    JAX's to rtol 1e-10, track equal."""
    s = _setup(model)
    spec = _conc(s["spec"], S, Rm)
    data = gibbs_data_from_numpy(s["data"])
    if kind == "one":
        key = jax.random.PRNGKey(KEY)
        step = jax.jit(functools.partial(G.one_iteration, spec))
        jst, tst = s["state"], chain_state_from_numpy(_np(s["state"]))
        for it in range(10):
            noise = JaxNoise(key, int(jst.it))
            jst = step(s["data"], key, jst)
            tst = TG.one_iteration(port_spec(spec), data, 0, tst, noise=noise)
            if it in (0, 9):
                _state_close(jst, tst)
    else:
        jst, keys = _chain_states(s, 3)
        step = jax.jit(functools.partial(G.one_iteration_batch, spec))
        tst = chain_state_from_numpy(_np(jst))
        for it in range(10):
            noise = [JaxNoise(keys[k], int(jst.it[0])) for k in range(3)]
            jst = step(s["data"], keys, jst)
            tst = TG.one_iteration_batch(port_spec(spec), data, 0, tst, noise=noise)
            if it in (0, 9):
                _state_close(jst, tst)
    assert tst.it == 10 + int(s["state"].it)


# ---------------------------------------------------------------------------
# the meshed sweep on gloo ranks against JAX's meshes
# ---------------------------------------------------------------------------

# name: (mesh shape, chains, merge rounds); every mesh, Rm and K
MESH_CASES = {"1x2-Rm1-K1": ((1, 2), 1, 1), "1x2-Rm2-K3": ((1, 2), 3, 2),
              "1x4-Rm2-K1": ((1, 4), 1, 2), "2x2-Rm1-K3": ((2, 2), 3, 1)}
CHAIN_RM = 2     # the 30-iteration chain on (1, 4)


@functools.cache
def _mesh_case(name):
    """A case's states, keys and JAX's numbers, recorded through the port's
    emulation at S = the mesh's snp size (the same Markov kernel: the gamma
    draws' shape parameters, which count nonzero effects, are the
    concurrent sweep's), and that emulation's output."""
    (_, S), K, Rm = MESH_CASES[name]
    s = _setup("BayesR")
    spec = port_spec(_conc(s["spec"], S, Rm))
    data = gibbs_data_from_numpy(s["data"])
    if K == 1:
        st = s["state"]
        rec = RecordNoise(JaxNoise(jax.random.PRNGKey(KEY), int(st.it)))
        emu = TG.one_iteration(spec, data, 0, chain_state_from_numpy(_np(st)), noise=rec)
        return st, None, rec.table, as_numpy(emu)
    st, keys = _chain_states(s, K)
    recs = [RecordNoise(JaxNoise(keys[k], int(st.it[0]))) for k in range(K)]
    emu = TG.one_iteration_batch(spec, data, 0, chain_state_from_numpy(_np(st)), noise=recs)
    return st, keys, [r.table for r in recs], as_numpy(emu)


def _gibbs_jobs(world):
    s = _setup("BayesR")
    jobs = {}
    for name, (shape, K, Rm) in MESH_CASES.items():
        if shape[0] * shape[1] != world:
            continue
        st, _, table, _ = _mesh_case(name)
        case = dict(name=name, spec=dict(shard_schedule="concurrent", merge_rounds=Rm),
                    state=_np(st))
        case.update(dict(kind="one", table=table) if K == 1 else dict(kind="batch",
                                                                        tables=table))
        jobs.setdefault(shape, []).append(case)
    if world == 4:
        jobs[(1, 4)].append(dict(name="chain", kind="chains", priors=dataclasses.asdict(s["pr"]),
                                 pi=s["pi"], seed=7, nchains=1,
                                 spec=dict(shard_schedule="concurrent", merge_rounds=CHAIN_RM)))
    return [dict(shape=sh, cases=cs) for sh, cs in jobs.items()]


RANKS = "tests.torch_dist:concurrent_cases"


def _payload(world):
    """Every case of ``world`` ranks, individual-level and summary, for one
    spawn (JAX's numbers recorded here)."""
    s, ss = _setup("BayesR"), _s_setup()
    return dict(gibbs=dict(spec=dataclasses.asdict(s["spec"]), data=_np(s["data"]),
                           jobs=_gibbs_jobs(world)),
                sgibbs=dict(spec=dataclasses.asdict(ss["spec"]), data=_np(ss["data"]._asdict()),
                            jobs=_s_jobs(world)))


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory):
    """The spawns of 2 and 4 gloo ranks, run in a thread from the module's
    first test on, while this process computes JAX's references.
    ``ranks(world)`` waits for them and returns ({shape: [every rank's
    results]} of the individual-level jobs, the same of the summary ones)."""
    tmp = str(tmp_path_factory.mktemp("concurrent"))
    payloads = {w: _payload(w) for w in (2, 4)}
    outs, failed = {}, []

    def run():
        try:
            for w, p in payloads.items():
                outs[w] = spawn(RANKS, w, tmp, p, timeout=300)
        except BaseException as e:   # re-raised in the test that reads the ranks
            failed.append(e)

    th = threading.Thread(target=run)
    th.start()

    def get(world):
        th.join()
        if failed:
            raise failed[0]
        p = payloads[world]
        return tuple({j["shape"]: [o[key][i] for o in outs[world]]
                      for i, j in enumerate(p[key]["jobs"])} for key in ("gibbs", "sgibbs"))

    yield get
    th.join()


def _jax_mesh_step(name):
    """JAX's meshed iteration of a case of MESH_CASES."""
    shape, K, Rm = MESH_CASES[name]
    s = _setup("BayesR")
    spec = _conc(s["spec"], 0, Rm)
    st, keys, _, _ = _mesh_case(name)
    mesh = jax_mesh(shape[0] * shape[1], shape=shape)
    with mesh:
        if K == 1:
            return jax.jit(functools.partial(G.one_iteration, spec, mesh=mesh))(
                jax_shard(s["data"], mesh), jax.random.PRNGKey(KEY), jax_shard_state(st, mesh))
        return jax.jit(functools.partial(G.one_iteration_batch, spec, mesh=mesh))(
            jax_shard(s["data"], mesh), keys, st)


@pytest.mark.parametrize("name", list(MESH_CASES))
def test_meshed_sweep_matches_jax(name, ranks):
    """One iteration (K = 1) or one of a batch (K = 3) with the concurrent
    schedule on the mesh, every rank's whole state, against JAX's
    ``one_iteration(_batch)(mesh=...)`` on as many virtual devices: every
    field to rtol 1e-10, track equal; every rank holds the same state.  On
    (1, 2) at Rm = 1 the ranks' merge a + (d0 + d1) is the emulation's at
    S = 2 bit for bit; on (2, 2) every round runs the ind hybrid."""
    shape = MESH_CASES[name][0]
    ref = _np(_jax_mesh_step(name)._asdict())
    outs = ranks(shape[0] * shape[1])[0][shape]
    for o in outs:
        _state_close(ref, o[name])
    for o in outs[1:]:
        for k in ("g", "yadj", "vare"):
            np.testing.assert_array_equal(o[name][k], outs[0][name][k])
    if name == "1x2-Rm1-K1":
        emu = _mesh_case(name)[3]
        for k in ("g", "track", "yadj", "u", "vara", "vare", "pi"):
            np.testing.assert_array_equal(outs[0][name][k], emu[k], err_msg=k)


def test_emulation_and_mesh_are_one_markov_kernel(ranks):
    """A 30-iteration chain (BayesR, f64, seed 7) on (1, 4) with Rm = 2
    against the port's emulation at S = 4, Rm = 2 on one device
    (tests/test_concurrent.py::test_emulated_matches_distributed_concurrent):
    every record to rtol 1e-8."""
    s = _setup("BayesR")
    _, ref, _ = TG.run_chains(port_spec(_conc(s["spec"], 4, CHAIN_RM)),
                              gibbs_data_from_numpy(s["data"]), s["pr"], s["pi"], seed=7,
                              nchains=1)
    for o in ranks(4)[0][(1, 4)]:
        _, smp, _ = o["chain"]
        for k in ref:
            np.testing.assert_allclose(smp[k], ref[k], rtol=1e-8,
                                       atol=1e-8 * np.abs(ref[k]).max(initial=1e-300), err_msg=k)
        assert np.isfinite(smp["Vg"]).all()


# ---------------------------------------------------------------------------
# identities of the schedule
# ---------------------------------------------------------------------------


def test_group0_is_the_exact_sweep():
    """Group 0 (blocks [0, nbg)) sweeps from the iteration's residual in the
    blocks' own order: its effects and mixture draws are the one-device
    sweep's first nbg blocks bit for bit (S = 4, Rm = 2, K = 3); the later
    groups' are not."""
    s = _setup("BayesR")
    spec = port_spec(_conc(s["spec"], 4, 2))
    _, ta = sweep_inputs({**s, "spec": spec}, 3)
    emu = TG._sweep_concurrent_emu_mc(spec, *ta)
    one = TB.sweep_mc(spec, *ta)
    mg = spec.block * spec.nblocks // 8
    for i in (0, 1):
        assert torch.equal(emu[i][:, :mg], one[i][:, :mg])
    assert not torch.equal(emu[0][:, mg:], one[0][:, mg:])


def test_merged_residuals_are_the_recomputed_ones():
    """After one iteration of 3 chains under the emulation (S = 4, Rm = 2),
    from states whose residuals are their effects' (an exact iteration from
    the initial state), each chain's yadj and u are
    ``_recompute_residuals`` of its new effects to 1e-10 of their scale:
    the merge of the groups' deltas is the sum X dg over all blocks."""
    s = _setup("BayesR")
    spec = port_spec(s["spec"])
    data = gibbs_data_from_numpy(s["data"])
    states = TG.stack_state(TG.init_state(spec, data, s["pr"], s["pi"]), 3)
    states = TG.one_iteration_batch(spec, data, 1, states)    # exact: effects to merge
    out = TG.one_iteration_batch(port_spec(_conc(s["spec"], 4, 2)), data, 1, states)
    assert (out.track > 0).any()
    for k in range(3):
        y_k, u_k = TG._recompute_residuals(spec, data, out.mu[k], out.beta[k],
                                           tuple(e[k] for e in out.estR), out.g[k])
        for got, want in ((out.yadj[k], y_k), (out.u[k], u_k)):
            torch.testing.assert_close(got, want, rtol=0, atol=1e-10 * float(want.abs().max()))


@pytest.mark.parametrize("nchains", [1, 2])
def test_concurrent_without_shards_is_the_exact_chain(nchains):
    """With neither a mesh nor emulate_shards, "concurrent" runs the exact
    sweep, as the JAX package does: a chain (and a batch of 2) bit for bit
    the "turn" chain's records and final state."""
    s = _setup("BayesCpi")
    data = gibbs_data_from_numpy(s["data"])
    spec = port_spec(dataclasses.replace(s["spec"], niter=12, nburn=4, thin=2))
    runs = [TG.run_chains(sp, data, s["pr"], s["pi"], seed=3, nchains=nchains)
            for sp in (spec, dataclasses.replace(spec, shard_schedule="concurrent",
                                                 merge_rounds=2))]
    (st0, smp0, _), (st1, smp1, _) = runs
    for k in smp0:
        np.testing.assert_array_equal(smp1[k], smp0[k], err_msg=k)
    for k in ("g", "yadj", "u", "vare", "nzrate"):
        assert torch.equal(getattr(st1, k), getattr(st0, k)), k


# ---------------------------------------------------------------------------
# sbrm: the tiled sweep in merge rounds
# ---------------------------------------------------------------------------

# name: (mesh shape, merge rounds)
S_CASES = {"1x2-Rm1": ((1, 2), 1), "1x4-Rm2": ((1, 4), 2)}


# a vary at which the guard rejects a first draw that a later candidate
# passes, in both cases' iteration (a lower one exhausts a draw's 8)
S_VARY = 0.012


@functools.cache
def _s_setup():
    """BayesR on the pruned LD in tiles of 64 (8 tile rows, the guard on at
    S_VARY), and a state after one iteration of the port's own."""
    s = s_setup("BayesR", "tiled64", m=500, dtype=jnp.float64)
    s = {**s, "spec": dataclasses.replace(s["spec"], vary=S_VARY)}
    spec, data = port_spec(s["spec"]), sgibbs_data_from_numpy(s["data"])
    st = TSG.init_s_state(spec, data, s["pr"], s["pi"])
    st = TSG.one_s_iteration(spec, data, 0, st, noise=IterNoise(3, 0, "cpu", torch.float64))
    return {**s, "state": _np(st._asdict())}


def _tiled_rounds(S):
    """The ranks' concurrent tiled sweep in this process: in each round the
    S shards' rows swept one after another at their row_base from the
    round-start r_hat, their deltas summed."""
    def sweep(spec, data, r_hat, P, mesh, tally=None):
        B, nl = spec.block, data.ld_tiles.shape[0] // S
        nb_g = nl // spec.merge_rounds
        dg = torch.empty(spec.m_pad, dtype=r_hat.dtype)
        track = torch.empty(spec.m_pad, dtype=torch.int32)
        for r in range(spec.merge_rounds):
            delta = torch.zeros_like(r_hat)
            for s in range(S):
                b0 = s * nl + r * nb_g
                rows, sl = slice(b0, b0 + nb_g), slice(b0 * B, (b0 + nb_g) * B)
                dg[sl], track[sl], r2, _ = TB.sweep_s_tiled(
                    spec, data.ld_tiles[rows], data.ld_cols[rows], data.ld_valid[rows], r_hat,
                    P[..., sl], spec.n, tally=tally, row_base=b0)
                delta += r2 - r_hat
            r_hat = r_hat + delta
        return dg, track, r_hat
    return sweep


@functools.cache
def _s_case(name):
    """A summary case: JAX's numbers (its redraws as the guard's candidates)
    recorded through the concurrent tiled sweep emulated in this process,
    that iteration and its guard counts."""
    (_, S), Rm = S_CASES[name]
    s = _s_setup()
    spec = port_spec(dataclasses.replace(s["spec"], shard_schedule="concurrent",
                                         merge_rounds=Rm))
    data = sgibbs_data_from_numpy(s["data"])
    st = s_chain_state_from_numpy(s["state"])
    rec = RecordNoise(JaxRedrawNoise(jax.random.PRNGKey(KEY), st.it))
    tally = torch.zeros(2, dtype=torch.int64)
    real = (TSG._tiled_sweep_snp_sharded, TSG.tiles_cut)
    TSG._tiled_sweep_snp_sharded, TSG.tiles_cut = _tiled_rounds(S), lambda *a: True
    try:
        emu = TSG._s_iteration(spec, data, rec, st, tally, mesh=object())
    finally:
        TSG._tiled_sweep_snp_sharded, TSG.tiles_cut = real
    return rec.table, as_numpy(emu), tally.numpy()


def _s_jobs(world):
    s = _s_setup()
    jobs = {}
    for name, (shape, Rm) in S_CASES.items():
        if shape[0] * shape[1] == world:
            jobs.setdefault(shape, []).append(dict(
                name=name, spec=dict(shard_schedule="concurrent", merge_rounds=Rm),
                state=s["state"], table=_s_case(name)[0]))
    return [dict(shape=sh, cases=cs) for sh, cs in jobs.items()]


@pytest.mark.parametrize("name", list(S_CASES))
def test_tiled_rounds_match_jax(name, ranks):
    """One summary iteration with the concurrent schedule on the mesh (each
    rank's tile rows in Rm rounds of the tiled sweep at their row_base,
    every round from the round-start r_hat) against JAX's
    ``one_s_iteration(mesh=...)`` on as many virtual devices (its guarded
    XLA scans): every field to rtol 1e-10, track equal.  The guard fires;
    its candidates are JAX's own first 8 redraws and no draw exhausted
    them; every rank's guard counts are those of the rounds emulated in
    this process, whose iteration the ranks' equals too."""
    (shape, Rm) = S_CASES[name]
    s = _s_setup()
    spec = dataclasses.replace(s["spec"], shard_schedule="concurrent", merge_rounds=Rm)
    mesh = jax_mesh(shape[0] * shape[1], shape=shape)
    state = SG.SChainState(**jax.tree_util.tree_map(jnp.asarray, s["state"]))
    with mesh:
        ref = _np(jax.jit(functools.partial(SG.one_s_iteration, spec, mesh=mesh))(
            jax_shard_s(s["data"], mesh), jax.random.PRNGKey(KEY), state)._asdict())
    _, emu, tally = _s_case(name)
    assert tally[0] > 0, "the guard should fire at S_VARY"
    assert tally[1] == 0, "JAX would have redrawn past the 8th candidate"
    for o in ranks(shape[0] * shape[1])[1][shape]:
        out, t = o[name]
        np.testing.assert_array_equal(t, tally)
        _close(ref, out, TSG.SChainState._fields[1:])
        _close(emu, out, TSG.SChainState._fields[1:])


def test_tiled_rounds_make_each_schedule_once(monkeypatch):
    """sbrm's concurrent rounds (``_tiled_sweep_snp_sharded`` at Rm = 2 on a
    one-rank mesh) sweep with the data's plans, each round's rows at their
    row_base: over three iterations the card's route (``tiled_plan``) builds
    each round's schedule at the first iteration only, Rm builds; the same
    data with fresh plans builds them again."""
    from hibayes_tpu_torch.parallel.mesh import make_mesh

    s = _s_setup()
    spec = dataclasses.replace(port_spec(s["spec"]), shard_schedule="concurrent",
                               merge_rounds=2)
    data = sgibbs_data_from_numpy(s["data"])
    state = s_chain_state_from_numpy(s["state"])
    P = TSG._s_pre_sweep(spec, data, IterNoise(5, 1, "cpu", torch.float64), state)["P"]
    built = []
    schedule, sweep = TB.tiled_schedule, TB.sweep_s_tiled
    monkeypatch.setattr(TB, "tiled_schedule",
                        lambda *a, **k: built.append(a[2]) or schedule(*a, **k))

    def card_route(spec, tiles, cols, valid, r_hat, P, n, row_base=0, plans=None, **kw):
        TB.tiled_plan(spec, tiles, cols, valid, row_base, r_hat.shape[-1] // tiles.shape[2],
                      plans)
        return sweep(spec, tiles, cols, valid, r_hat, P, n, row_base=row_base, plans=plans,
                     **kw)

    monkeypatch.setattr(TB, "sweep_s_tiled", card_route)
    mesh = make_mesh(device="cpu")
    outs = [TSG._tiled_sweep_snp_sharded(spec, data, state.r_hat, P, mesh) for _ in range(3)]
    nl = data.ld_tiles.shape[0]
    assert built == [0, nl // 2]
    assert all(torch.equal(a, b) for a, b in zip(outs[0], outs[2]))
    TSG._tiled_sweep_snp_sharded(spec, data._replace(plans={}), state.r_hat, P, mesh)
    assert built == [0, nl // 2] * 2


# ---------------------------------------------------------------------------
# the warning and the errors, word for word JAX's
# ---------------------------------------------------------------------------


def _spec_kw(m, n, **kw):
    return dict(model="BayesCpi", n=n, m=m, m_pad=m, block=8, nc=0, nlevels=(), n_fold=2,
                niter=2, nburn=1, thin=1, nvar0=0, **kw)


def _warned(cls, **kw):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        cls(**kw)
    return [str(x.message) for x in w if issubclass(x.category, UserWarning)]


def test_m_above_n_warning_is_jax_text():
    """GibbsSpec warns for "concurrent" with m > n (the relaxed kernel's
    biased regime) with JAX's text, and only where JAX does: not at m <= n,
    not for a summary spec (seg_sizes), not for another schedule."""
    kw = _spec_kw(64, 32, shard_schedule="concurrent")
    want = _warned(G.GibbsSpec, **kw)
    assert len(want) == 1 and "m (64) > n (32)" in want[0]
    assert _warned(TG.GibbsSpec, **kw) == want
    for other in (_spec_kw(64, 32, shard_schedule="concurrent", n_real=70),
                  _spec_kw(32, 64, shard_schedule="concurrent"),
                  _spec_kw(64, 32, shard_schedule="concurrent", seg_sizes=(64,)),
                  _spec_kw(64, 32, shard_schedule="pipeline")):
        assert _warned(G.GibbsSpec, **other) == [] == _warned(TG.GibbsSpec, **other)


class _Rank0:
    """Rank 0 of a (1, S) mesh, for errors raised before any collective."""

    def __init__(self, S):
        self.S = S

    def size(self, axis):
        return self.S if axis == "snp" else 1

    def index(self, axis):
        return 0


def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_value_errors_are_jax_text():
    """The JAX package's ValueErrors, word for word: an emulation whose S Rm
    does not divide the blocks; merge rounds that do not divide a rank's
    blocks (ibrm) or tile rows (sbrm)."""
    s = _setup("BayesCpi")
    spec = _conc(s["spec"], 3, 1)
    ja, ta = sweep_inputs({**s, "spec": spec}, 1)
    want = _message(lambda: G._sweep_concurrent_emu_mc(spec, *ja, interpret=True))
    assert "(3x1) must divide the 8 SNP blocks" in want
    assert _message(lambda: TG._sweep_concurrent_emu_mc(port_spec(spec), *ta)) == want

    spec = _conc(s["spec"], 0, 3)
    mesh = jax_mesh(2, shape=(1, 2))
    st = s["state"]
    with mesh:
        want = _message(lambda: jax.jit(functools.partial(G.one_iteration, spec, mesh=mesh))(
            jax_shard(s["data"], mesh), jax.random.PRNGKey(KEY), jax_shard_state(st, mesh)))
    assert "merge_rounds (3) must divide the 4 local SNP blocks" in want
    pspec = port_spec(spec)
    data = gibbs_data_from_numpy(s["data"])
    _, ta = sweep_inputs({**s, "spec": spec}, 1)
    got = _message(lambda: TG._sweep_snp_sharded_mc(
        pspec, data, ta[0], ta[7:11], ta[5], ta[6], ta[11], ta[12], ta[13], _Rank0(2)))
    assert got == want

    ss = _s_setup()
    sspec = dataclasses.replace(ss["spec"], shard_schedule="concurrent", merge_rounds=3)
    state = SG.SChainState(**jax.tree_util.tree_map(jnp.asarray, ss["state"]))
    with mesh:
        want = _message(lambda: jax.jit(functools.partial(SG.one_s_iteration, sspec,
                                                          mesh=mesh))(
            jax_shard_s(ss["data"], mesh), jax.random.PRNGKey(KEY), state))
    assert "merge_rounds (3) must divide the 4 local LD tile rows" in want
    sdata = sgibbs_data_from_numpy(ss["data"])
    part = sdata._replace(ld_tiles=sdata.ld_tiles[:4], ld_cols=sdata.ld_cols[:4],
                          ld_valid=sdata.ld_valid[:4])
    got = _message(lambda: TSG._tiled_sweep_snp_sharded(
        port_spec(sspec), part, sdata.xy, torch.zeros(1, sspec.m_pad), _Rank0(2)))
    assert got == want
