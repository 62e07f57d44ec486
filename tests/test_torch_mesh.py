"""The port's device meshes (hibayes_tpu_torch/parallel/) and its sharded
individual-level sweeps, on gloo ranks on the CPU, against the JAX package's
meshes on its virtual CPU devices (tests/conftest.py) and against the
port's own one-device chain.

The ranks are spawned once per world size (tests/torch_dist.py), 2 for
(2, 1) and (1, 2), 4 for (2, 2) and (1, 4), and run every case of each of
those mesh shapes in that one spawn: one iteration of one chain (BayesR, a
covariate, a factor, windows) and of a batch of 2 chains, each
from the same mid-run state with JAX's random numbers, held to JAX's call
with ``mesh=make_mesh(...)`` to 1e-10; on (1, 2) the ring pipeline with 4
chains against JAX's pipeline to 1e-10 and against the port's one-device
emulation (``emulate_shards`` 2) bit for bit; whole f64 chains against the
port's one-device chain to rtol 1e-8; and a checkpointed chain stopped
after its second checkpoint and resumed, bit for bit the uninterrupted
chain.  Sizes: n=64, m=128 in blocks of 16 (8 blocks: 2 and 4 shards
divide them).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hibayes_tpu.engine import gibbs as G
from hibayes_tpu.parallel.mesh import make_mesh as jax_mesh
from hibayes_tpu.parallel.mesh import shard_gibbs_data as jax_shard
from hibayes_tpu.parallel.mesh import shard_state as jax_shard_state
from hibayes_tpu_torch.engine import gibbs as TG
from hibayes_tpu_torch.engine.convert import chain_state_from_numpy, gibbs_data_from_numpy

from .torch_dist import RecordNoise, as_numpy, spawn
from .torch_parity import JaxNoise, model_setup, port_spec, stack_states, with_sparse_effects

torch.set_num_threads(2)

SIZES = dict(n=64, m=128, B=16, nc=1, nfactor=1, windows=True, warm=0)
KEY = 5
SHAPES = [(2, 1), (1, 2), (2, 2), (1, 4)]
RANKS = "tests.torch_dist:gibbs_cases"


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x), tree)


@functools.cache
def _setup(model):
    s = model_setup(model, dtype=jnp.float64, **SIZES)
    return {**s, "spec": dataclasses.replace(s["spec"], niter=30, nburn=10)}


def _jax_one(spec, data, state, shape):
    mesh = jax_mesh(shape[0] * shape[1], shape=shape)
    with mesh:
        step = jax.jit(functools.partial(G.one_iteration, spec, mesh=mesh))
        return step(jax_shard(data, mesh), jax.random.PRNGKey(KEY),
                    jax_shard_state(state, mesh))


def _jax_batch(spec, data, states, keys, shape):
    mesh = jax_mesh(shape[0] * shape[1], shape=shape)
    with mesh:
        step = jax.jit(functools.partial(G.one_iteration_batch, spec, mesh=mesh))
        return step(jax_shard(data, mesh), keys, states)


@functools.cache
def _one_case():
    """BayesR, one chain from a mid-run state: the state and JAX's numbers
    of its iteration (recorded through the port's own one-device call)."""
    s = with_sparse_effects(_setup("BayesR"), seed=7)
    rec = RecordNoise(JaxNoise(jax.random.PRNGKey(KEY), int(s["state"].it)))
    TG.one_iteration(port_spec(s["spec"]), gibbs_data_from_numpy(s["data"]), 0,
                     chain_state_from_numpy(s["state"]), noise=rec)
    return s, rec.table


@functools.cache
def _batch_case(K=2, model="BayesR", key=6):
    s = _setup(model)
    states = stack_states([with_sparse_effects(s, seed=9 + k)["state"] for k in range(K)])
    keys = jax.random.split(jax.random.PRNGKey(key), K)
    it = int(states.it[0])
    recs = [RecordNoise(JaxNoise(keys[k], it)) for k in range(K)]
    TG.one_iteration_batch(port_spec(s["spec"]), gibbs_data_from_numpy(s["data"]), 0,
                           chain_state_from_numpy(states), noise=recs)
    return s, states, keys, [r.table for r in recs]


def _pipeline(spec):
    return dataclasses.replace(spec, shard_schedule="pipeline")


@functools.cache
def _pipeline_case():
    """4 BayesR chains for the ring pipeline on (1, 2): their states, keys,
    JAX's numbers recorded through the port's one-device emulation at
    emulate_shards=2 (group 1's gamma draws have shape parameters, nonzero
    counts, of its own block order), and that emulation's output."""
    s, st4, keys, _ = _batch_case(K=4, key=8)
    it = int(st4.it[0])
    recs = [RecordNoise(JaxNoise(keys[k], it)) for k in range(4)]
    emu = TG.one_iteration_batch(
        dataclasses.replace(port_spec(_pipeline(s["spec"])), emulate_shards=2),
        gibbs_data_from_numpy(s["data"]), 0, chain_state_from_numpy(st4), noise=recs)
    return s, st4, keys, [r.table for r in recs], as_numpy(emu)


def _cases(shape, tmp):
    s1, table = _one_case()
    cases = [dict(name="one", kind="one", state=_np(s1["state"]), table=table),
             dict(name="chain", kind="chains", priors=dataclasses.asdict(s1["pr"]),
                  pi=s1["pi"], seed=3, nchains=1)]
    if shape in ((2, 2), (1, 2)):
        _, states, _, tables = _batch_case()
        cases += [dict(name="batch", kind="batch", state=_np(states), tables=tables)]
    if shape == (1, 2):
        _, st4, _, tab4, _ = _pipeline_case()
        cases += [dict(name="pipeline", kind="batch", spec=dict(shard_schedule="pipeline"),
                       state=_np(st4), tables=tab4)]
    if shape == (2, 2):
        cases += [dict(name="resume", kind="resume", priors=dataclasses.asdict(s1["pr"]),
                       pi=s1["pi"], seed=3, stop_after=2, path=f"{tmp}/ck")]
    return cases


@functools.cache
def _run_world(world, tmp):
    """Every case of every mesh shape of ``world`` ranks, in one spawn."""
    s1, _ = _one_case()
    shapes = [sh for sh in SHAPES if sh[0] * sh[1] == world]
    outs = spawn(RANKS, world, tmp,
                 dict(spec=dataclasses.asdict(s1["spec"]), data=_np(s1["data"]),
                      jobs=[dict(shape=sh, cases=_cases(sh, tmp)) for sh in shapes]),
                 timeout=300)
    return {sh: [o[i] for o in outs] for i, sh in enumerate(shapes)}


def _run(shape, tmp):
    """Every rank's results of one mesh shape's cases."""
    return _run_world(shape[0] * shape[1], tmp)[shape]


@functools.cache
def _one_device_chain():
    s, _ = _one_case()
    return TG.run_chains(port_spec(s["spec"]), gibbs_data_from_numpy(s["data"]), s["pr"],
                         s["pi"], seed=3, nchains=1)


def _assert_close(ref, out, rtol=1e-10):
    for name in TG.ChainState._fields[1:]:
        a, b = ref[name], out[name]
        for x, y in (zip(a, b) if isinstance(b, tuple) else [(a, b)]):
            x, y = np.asarray(x), np.asarray(y)
            assert x.shape == y.shape, name
            if name == "track":
                np.testing.assert_array_equal(y, x, err_msg=name)
            else:
                np.testing.assert_allclose(
                    y, x, rtol=rtol, atol=rtol * (np.abs(x).max() if x.size else 0),
                    err_msg=name)


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("mesh")


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_one_iteration_on_mesh_matches_jax(shape, tmp):
    """One iteration of one BayesR chain on the mesh, every rank's whole
    state gathered, against JAX's ``one_iteration(mesh=...)`` on the same
    shape of virtual devices: every field to 1e-10; and every rank holds
    the same state."""
    s, _ = _one_case()
    ref = _np(_jax_one(s["spec"], s["data"], s["state"], shape)._asdict())
    outs = _run(shape, str(tmp))
    for o in outs:
        _assert_close(ref, o["one"])
    for o in outs[1:]:
        for k in ("g", "yadj", "vare"):
            np.testing.assert_array_equal(o["one"][k], outs[0]["one"][k])


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_chain_on_mesh_matches_one_device(shape, tmp):
    """A whole f64 chain (30 iterations, 4 recorded; BayesR with a
    covariate, a factor and windows) on the mesh against the port's
    one-device chain: every record, PIP and WPPA to rtol 1e-8."""
    _, ref, ex = _one_device_chain()
    for o in _run(shape, str(tmp)):
        _, smp, ex_m = o["chain"]
        for k in ref:
            np.testing.assert_allclose(smp[k], ref[k], rtol=1e-8,
                                       atol=1e-8 * (np.abs(ref[k]).max() + 1e-300),
                                       err_msg=k)
        np.testing.assert_allclose(ex_m["pip"], ex["pip"], rtol=1e-8)


@pytest.mark.parametrize("shape", [(2, 2), (1, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_batch_on_mesh_matches_jax(shape, tmp):
    """One iteration of a batch of 2 BayesR chains, each from its own
    mid-run state, against JAX's ``one_iteration_batch(mesh=...)``: every
    field to 1e-10."""
    s, states, keys, _ = _batch_case()
    ref = _np(_jax_batch(s["spec"], s["data"], states, keys, shape)._asdict())
    for o in _run(shape, str(tmp)):
        _assert_close(ref, o["batch"])


def test_pipeline_matches_jax_and_its_emulation(tmp):
    """The ring pipeline on (1, 2) with 4 chains (groups of 2): against
    JAX's pipeline on 2 virtual devices to 1e-10; bit for bit the port's
    one-device emulation at emulate_shards=2; and its group 0's sweep bit
    for bit the one-device batch's (its chains sweep the blocks in their
    own order): effects, mixture draws and residuals.  JAX's numbers are
    recorded through the emulation: group 1's gamma draws have shape
    parameters (nonzero counts) of its own block order."""
    s, st4, keys, _, emu = _pipeline_case()
    ref = _np(_jax_batch(_pipeline(s["spec"]), s["data"], st4, keys, (1, 2))._asdict())
    outs = _run((1, 2), str(tmp))
    for o in outs:
        _assert_close(ref, o["pipeline"])
    for k, v in emu.items():
        if k != "it":
            for a, b in (zip(v, outs[0]["pipeline"][k]) if isinstance(v, tuple)
                         else [(v, outs[0]["pipeline"][k])]):
                np.testing.assert_array_equal(b, a, err_msg=k)
    it = int(st4.it[0])
    plain = TG.one_iteration_batch(port_spec(s["spec"]), gibbs_data_from_numpy(s["data"]), 0,
                                   chain_state_from_numpy(st4),
                                   noise=[JaxNoise(keys[k], it) for k in range(4)])
    for k in ("g", "track", "yadj", "u"):
        np.testing.assert_array_equal(outs[0]["pipeline"][k][:2], as_numpy(plain)[k][:2],
                                      err_msg=k)
    assert not np.array_equal(outs[0]["pipeline"]["g"][2:], as_numpy(plain)["g"][2:])


def test_checkpointed_chain_on_mesh_resumes_bit_for_bit(tmp):
    """On (2, 2) a chain with a checkpoint after every record is stopped on
    every rank after its second checkpoint (rank 0 writes it, the fields
    over individuals gathered) and run again: it resumes from the file, and
    its records and final state are the uninterrupted chain's bit for
    bit."""
    outs = _run((2, 2), str(tmp))
    for o in outs:
        killed, st, smp = o["resume"]
        assert killed
        ref_st, ref_smp, _ = o["chain"]
        for k in ref_smp:
            np.testing.assert_array_equal(smp[k], ref_smp[k][0], err_msg=k)
        for k in ("g", "yadj", "u", "vare", "nzrate"):
            np.testing.assert_array_equal(st[k], ref_st[k][0], err_msg=k)
