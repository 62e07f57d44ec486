"""Ranks of the port's multi-process tests, on the CPU: gloo process groups
spawned from a test, without JAX.

A spawned rank imports this module afresh (torch.multiprocessing's spawn
start method), so it imports neither JAX nor the JAX package: a test
computes the JAX reference in its own process and hands the ranks numpy
arrays, JAX's random numbers included (:class:`TableNoise`).  The ranks
meet at a ``file://`` rendezvous under the test's tmp_path (no port for
parallel test workers to race for), and :func:`spawn` joins them under a
time limit, so a hang fails the test.
"""

from __future__ import annotations

import importlib
import os
import pickle
import traceback

import numpy as np
import torch

from hibayes_tpu_torch.engine.rng import IterNoise


class TableNoise(IterNoise):
    """The draws of one iteration read from a table {stream: array}, each
    stream's numbers as some other source drew them (JAX's, recorded by
    :class:`RecordNoise` in the test's process).  A gamma draw's entry
    holds its shape parameter too, which must be the one asked for: the
    numbers were drawn for it."""

    def __init__(self, table, it=0, dtype=torch.float64):
        super().__init__(0, it, "cpu", dtype)
        self.table = table

    def _get(self, stream, shape):
        a = torch.from_numpy(np.array(self.table[stream]))
        assert tuple(a.shape) == tuple(shape), (stream, a.shape, shape)
        return a

    def normal(self, stream, shape=()):
        return self._get(stream, shape)

    def uniform(self, stream, shape=()):
        return self._get(stream, shape)

    def gamma(self, stream, alpha, shape=None):
        want, x = self.table[stream]
        got = torch.as_tensor(alpha, dtype=torch.float64).cpu().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, err_msg=f"stream {stream}")
        shape = tuple(got.shape) if shape is None else tuple(shape)
        assert tuple(np.shape(x)) == shape, (stream, np.shape(x), shape)
        return torch.from_numpy(np.array(x))


class RecordNoise(IterNoise):
    """Wraps another IterNoise and records every draw by stream, for a
    :class:`TableNoise` elsewhere."""

    def __init__(self, inner):
        super().__init__(0, inner.it, "cpu", inner.dtype)
        self.inner, self.table = inner, {}

    def _keep(self, stream, x):
        assert stream not in self.table, f"stream {stream} drawn twice"
        self.table[stream] = x.numpy().copy()
        return x

    def normal(self, stream, shape=()):
        return self._keep(stream, self.inner.normal(stream, shape))

    def uniform(self, stream, shape=()):
        return self._keep(stream, self.inner.uniform(stream, shape))

    def gamma(self, stream, alpha, shape=None):
        x = self.inner.gamma(stream, alpha, shape)
        assert stream not in self.table, f"stream {stream} drawn twice"
        self.table[stream] = (torch.as_tensor(alpha, dtype=torch.float64).cpu().numpy(),
                              x.numpy().copy())
        return x


def _rank_main(rank, world, init, target, payload, out, threads):
    import torch.distributed as dist

    torch.set_num_threads(threads)
    try:
        if isinstance(payload, dict) and payload.get("init") == "own":
            payload = dict(payload, init=init)   # the rank joins by itself
        else:
            dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
        mod, name = target.rsplit(":", 1)
        result = getattr(importlib.import_module(mod), name)(rank, world, payload)
        if dist.is_initialized():   # a rank that joined by itself may have left
            dist.barrier()
            dist.destroy_process_group()
        with open(f"{out}.{rank}", "wb") as f:
            pickle.dump(("ok", result), f)
    except BaseException:
        with open(f"{out}.{rank}", "wb") as f:
            pickle.dump(("error", traceback.format_exc()), f)
        raise


def spawn(target: str, world: int, tmp_path, payload=None, timeout=120, threads=1):
    """Run ``target`` ("module:function", called as fn(rank, world,
    payload)) on ``world`` gloo ranks, each a spawned process joined to
    the others by a file:// rendezvous in ``tmp_path``; returns each rank's
    result, in rank order.  Raises with the rank's traceback if a rank
    fails, and kills the ranks if they have not finished in ``timeout``
    seconds.

    The ranks fork from a server process that has imported this module (and
    so torch and the port) once, not JAX: a rank starts in a fraction of a
    second instead of importing torch anew."""
    import multiprocessing

    import torch.multiprocessing as mp

    multiprocessing.set_forkserver_preload([__name__])
    tmp = str(tmp_path)
    init = "file://" + os.path.join(tmp, f"rendezvous_{os.getpid()}_{id(payload)}")
    out = os.path.join(tmp, f"result_{os.getpid()}_{id(payload)}")
    ctx = mp.start_processes(_rank_main, args=(world, init, target, payload, out, threads),
                             nprocs=world, join=False, start_method="forkserver")
    import time

    t_end = time.time() + timeout
    try:
        while not ctx.join(timeout=max(0.1, t_end - time.time())):
            if time.time() > t_end:
                raise TimeoutError(f"{target} on {world} ranks: no end in {timeout} s")
    except mp.ProcessRaisedException:
        pass
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    results = []
    for r in range(world):
        try:
            with open(f"{out}.{r}", "rb") as f:
                kind, val = pickle.load(f)
        except FileNotFoundError:
            raise RuntimeError(f"{target}: rank {r} left no result") from None
        if kind != "ok":
            raise RuntimeError(f"{target}: rank {r} failed:\n{val}")
        results.append(val)
    return results


def as_numpy(x):
    """A state, tuple or dict of tensors as numpy, for the test process."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if hasattr(x, "_asdict"):
        return {k: as_numpy(v) for k, v in x._asdict().items()}
    if isinstance(x, dict):
        return {k: as_numpy(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(as_numpy(v) for v in x)
    return x


# ---------------------------------------------------------------------------
# the ranks of tests/test_torch_mesh.py and tests/test_torch_mesh_sbrm.py
# ---------------------------------------------------------------------------


class Killed(Exception):
    """Raised on every rank after a checkpoint, to stop a chain mid-run."""


def _gibbs_case(mesh, spec, data, case):
    import dataclasses

    from hibayes_tpu_torch.engine import gibbs as TG
    from hibayes_tpu_torch.engine.convert import chain_state_from_numpy
    from hibayes_tpu_torch.parallel.mesh import gather_state

    sp = dataclasses.replace(spec, **case.get("spec", {}))
    kind = case["kind"]
    if kind == "one":
        out = TG.one_iteration(sp, data, 0, chain_state_from_numpy(case["state"]),
                               noise=TableNoise(case["table"], dtype=data.y.dtype), mesh=mesh)
        return as_numpy(gather_state(out, mesh, sp.n))
    if kind == "batch":
        noise = [TableNoise(t, dtype=data.y.dtype) for t in case["tables"]]
        out = TG.one_iteration_batch(sp, data, 0, chain_state_from_numpy(case["state"]),
                                     noise=noise, mesh=mesh)
        return as_numpy(gather_state(out, mesh, sp.n))
    pr = TG.Priors(**case["priors"])
    if kind == "chains":
        st, smp, ex = TG.run_chains(sp, data, pr, case["pi"], seed=case["seed"],
                                    nchains=case["nchains"], mesh=mesh)
        return as_numpy(st), smp, {k: ex[k] for k in ("pip", "wppa")}
    if kind == "resume":
        path = case["path"]
        real = TG.barrier
        calls = [0]

        def stop(m):
            real(m)
            calls[0] += 1
            if calls[0] == case["stop_after"]:
                raise Killed()

        TG.barrier = stop
        try:
            TG.run_chain(sp, data, pr, case["pi"], seed=case["seed"], mesh=mesh,
                         checkpoint_path=path, chunk_records=1)
            killed = False
        except Killed:
            killed = True
        finally:
            TG.barrier = real
        st, smp, _ = TG.run_chain(sp, data, pr, case["pi"], seed=case["seed"], mesh=mesh,
                                  checkpoint_path=path, chunk_records=1)
        return killed, as_numpy(st), smp
    raise ValueError(kind)


def gibbs_cases(rank, world, payload):
    """For each job of ``payload["jobs"]`` ({"shape", "cases"}), every case
    of it (one_iteration, one_iteration_batch, run_chains, a killed and
    resumed run_chain) on a mesh of that shape over these ranks: one spawn
    serves every mesh shape of its world size.  Returns [{name: result}],
    a dict per job."""
    from hibayes_tpu_torch.engine import gibbs as TG
    from hibayes_tpu_torch.engine.convert import gibbs_data_from_numpy
    from hibayes_tpu_torch.parallel.mesh import make_mesh

    spec = TG.GibbsSpec(**payload["spec"])
    data = gibbs_data_from_numpy(payload["data"])
    out = []
    for job in payload["jobs"]:
        mesh = make_mesh(shape=job["shape"], device="cpu")
        out.append({c["name"]: _gibbs_case(mesh, spec, data, c) for c in job["cases"]})
    return out


def sgibbs_cases(rank, world, payload):
    """One summary iteration (``one_s_iteration`` with JAX's numbers) and a
    short chain (``run_s_chain``) on a mesh of ``payload["shape"]``;
    returns {"one": (state, tally), "chain": (samples, guard)}."""
    from hibayes_tpu_torch.engine import gibbs as TG
    from hibayes_tpu_torch.engine import sgibbs as TSG
    from hibayes_tpu_torch.engine.convert import s_chain_state_from_numpy, sgibbs_data_from_numpy
    from hibayes_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(shape=payload["shape"], device="cpu")
    spec = TG.GibbsSpec(**payload["spec"])
    data = sgibbs_data_from_numpy(payload["data"])
    tally = torch.zeros(2, dtype=torch.int64)
    one = TSG.one_s_iteration(spec, data, 0, s_chain_state_from_numpy(payload["state"]),
                              noise=TableNoise(payload["table"]), mesh=mesh, tally=tally)
    _, smp, ex = TSG.run_s_chain(spec, data, TG.Priors(**payload["priors"]), payload["pi"],
                                 seed=3, mesh=mesh)
    return {"one": (as_numpy(one), tally.numpy()), "chain": (smp, ex["guard"])}


def concurrent_cases(rank, world, payload):
    """tests/test_torch_concurrent.py, in one spawn a world size: the
    individual-level jobs of ``payload["gibbs"]`` (:func:`gibbs_cases`) and
    the summary ones of ``payload["sgibbs"]`` ({"spec", "data", "jobs":
    [{"shape", "cases"}]}, each case one ``one_s_iteration`` from its
    state with a spec override and JAX's numbers).  Returns {"gibbs":
    [{name: result}], "sgibbs": [{name: (state, tally)}]}, a dict per job."""
    import dataclasses

    from hibayes_tpu_torch.engine import gibbs as TG
    from hibayes_tpu_torch.engine import sgibbs as TSG
    from hibayes_tpu_torch.engine.convert import s_chain_state_from_numpy, sgibbs_data_from_numpy
    from hibayes_tpu_torch.parallel.mesh import make_mesh

    out = {"gibbs": gibbs_cases(rank, world, payload["gibbs"]), "sgibbs": []}
    sp = payload["sgibbs"]
    spec = TG.GibbsSpec(**sp["spec"])
    data = sgibbs_data_from_numpy(sp["data"])
    for job in sp["jobs"]:
        mesh = make_mesh(shape=job["shape"], device="cpu")
        res = {}
        for c in job["cases"]:
            tally = torch.zeros(2, dtype=torch.int64)
            st = TSG.one_s_iteration(dataclasses.replace(spec, **c["spec"]), data, 0,
                                     s_chain_state_from_numpy(c["state"]),
                                     noise=TableNoise(c["table"]), mesh=mesh, tally=tally)
            res[c["name"]] = (as_numpy(st), tally.numpy())
        out["sgibbs"].append(res)
    return out


def cli_fit_case(rank, world, payload):
    """tests/test_torch_cli.py: the CLI's ``ibrm`` call through the API on a
    (1, world) mesh with the concurrent schedule; rank 0 writes the fit
    through the CLI's writer under ``payload["prefix"]``."""
    import hibayes_tpu_torch as ht
    from hibayes_tpu_torch import cli
    from hibayes_tpu_torch.parallel.mesh import make_mesh

    stem = payload["stem"]
    bed = ht.read_plink(stem)
    fit = ht.ibrm("y ~ x1 + (1|grp)", data=ht.read_pheno(stem + ".phe"),
                  M=bed["geno"].values, M_id=bed["fam"][1], map=bed["map"], windsize=20000.0,
                  windnum=None, method="BayesCpi", niter=60, nburn=20, thin=5, seed=7,
                  verbose=False, device="cpu", mesh=make_mesh(shape=(1, world), device="cpu"),
                  shard_schedule="concurrent")
    if rank == 0:
        cli.save_fit(fit, payload["prefix"], map_=bed["map"])


def multihost_case(rank, world, payload):
    """tests/test_torch_multihost.py: join the group by ``init_multihost``
    (a file:// address), read this rank's rows of a PLINK fileset, run a
    short chain on the (2, 1) mesh and an ibrm fit on (1, 2)."""
    import hibayes_tpu_torch as htt
    from hibayes_tpu_torch.data.plink import read_plink
    from hibayes_tpu_torch.engine import gibbs as TG
    from hibayes_tpu_torch.parallel.distributed import (init_multihost,
                                                        load_plink_host_sharded,
                                                        process_row_range)
    from hibayes_tpu_torch.parallel.mesh import make_mesh

    nproc, me = init_multihost(payload["init"], world, rank, backend="gloo")
    assert (nproc, me) == (world, rank)
    mesh = make_mesh(shape=(world, 1), device="cpu")
    bfile = payload["bfile"]
    fileset, local = load_plink_host_sharded(bfile, mesh)
    M = read_plink(bfile)["geno"].values
    n = M.shape[0]
    rows = process_row_range(n, mesh)
    rng = np.random.default_rng(0)
    y = M.astype(np.float64) @ rng.normal(0, 0.2, M.shape[1]) + rng.normal(0, 1, n)
    spec, data, pr, pi = _multihost_chain(y, M)
    _, smp, ex = TG.run_chain(spec, data, pr, pi, seed=5, mesh=mesh)
    ids = np.array([f"i{k}" for k in range(n)])
    fit = htt.ibrm("y ~ 1", data={"id": ids, "y": y}, M=M, M_id=ids, method="BayesCpi",
                   niter=30, nburn=10, block=8, dtype=torch.float64, verbose=False,
                   device="cpu", mesh=make_mesh(shape=(1, world), device="cpu"))
    return {"rows": rows, "local": local.numpy(), "values": fileset["geno"].values,
            "samples": smp, "pip": ex["pip"], "fit_alpha": fit.alpha, "fit_vg": fit.Vg}


def _multihost_chain(y, M):
    """The short BayesCpi chain of multihost_case, in float64, blocks of 8."""
    from hibayes_tpu_torch.engine import gibbs as TG

    pi = np.array([0.95, 0.05])
    data = TG.prepare_gibbs_data(y, M, block=8, dtype=torch.float64, geno_dtype="int8")
    pr = TG.resolve_priors(y, float(data.vx.sum()), pi[0], nr=0)
    m = M.shape[1]
    spec = TG.GibbsSpec(model="BayesCpi", n=len(y), m=m, m_pad=int(data.xpx.shape[0]),
                        block=8, nc=0, nlevels=(), n_fold=2, niter=40, nburn=20, thin=5,
                        nvar0=int((data.vx[:m] == 0).sum()), dfvara=pr.dfvara,
                        s2vara=pr.s2vara, dfvare=pr.dfvare, s2vare=pr.s2vare,
                        s2varg=pr.s2varg, lambda_rate0=pr.lambda_rate0)
    return spec, data, pr, pi


# ---------------------------------------------------------------------------
# the ranks of tests/test_torch_snp_shards.py
# ---------------------------------------------------------------------------


def _snp_shard_layout(mesh, p):
    """(a): the set-up of this rank's columns against the whole set-up's
    cut, for each genotype type of ``p["layouts"]``."""
    from hibayes_tpu_torch.engine import gibbs as TG
    from hibayes_tpu_torch.parallel.mesh import SnpShard, shard_gibbs_data

    y, M, B = p["y"], p["M"], p["block"]
    out = {}
    for name, geno, dtype in p["layouts"]:
        Mg = M.astype(np.float64) if geno is None else M
        kw = dict(block=B, dtype=getattr(torch, dtype), geno_dtype=geno,
                  fold=p["fold"], nblocks_multiple=mesh.size("snp"))
        whole = shard_gibbs_data(TG.prepare_gibbs_data(y, Mg, **kw), mesh)
        c0, cnt = mesh.snp_range(M.shape[1], B)
        part = TG.prepare_gibbs_data(y, SnpShard(Mg[:, c0:c0 + cnt], c0, M.shape[1]),
                                     mesh=mesh, **kw)
        out[name] = {f: (getattr(whole, f).numpy(), getattr(part, f).numpy())
                     for f in ("X_blocks", "W_blocks", "C_blocks", "xpx", "vx", "real")}
        Xd = part.X_blocks.to(torch.float64)
        ref = torch.zeros_like(part.C_blocks, dtype=torch.float64)
        ref[1:] = torch.bmm(Xd[1:].transpose(1, 2), Xd[:-1])
        out[name]["C_blocks_float64"] = (ref.numpy(), part.C_blocks.to(torch.float64).numpy())
    return out


def _snp_shard_fits(mesh, p):
    """(b): a 4-chain pipeline run (run_chains, then ibrm) from the whole
    genotype and from this rank's columns."""
    import hibayes_tpu_torch as htt
    from hibayes_tpu_torch.engine import gibbs as TG
    from hibayes_tpu_torch.parallel.distributed import load_plink_snp_sharded

    y, M, B, ids = p["fit_y"], p["fit_M"], p["block"], p["ids"]
    m = M.shape[1]
    _, shard = load_plink_snp_sharded(p["bfile"], mesh, B)   # a .bed of M
    c0, cnt = mesh.snp_range(m, B)
    assert (shard.start, shard.m) == (c0, m)
    assert np.array_equal(shard.values.numpy(), M[:, c0:c0 + cnt])
    pi, fold = np.array([0.95, 0.02, 0.02, 0.01]), np.array([0.0, 1e-4, 1e-3, 1e-2])
    runs = {}
    for name, geno, kw in (("whole", M, {}), ("shard", shard, {"mesh": mesh})):
        data = TG.prepare_gibbs_data(y, geno, block=B, dtype=torch.float32,
                                     geno_dtype="int8", fold=fold, nblocks_multiple=4, **kw)
        vx = data.vx.numpy()
        pr = TG.resolve_priors(y, float(vx.sum()), pi[0], nr=0)
        spec = TG.GibbsSpec(model="BayesR", n=len(y), m=m, m_pad=int(data.xpx.shape[0]),
                            block=B, nc=0, nlevels=(), n_fold=4, niter=12, nburn=4, thin=2,
                            nvar0=int((vx[:m] == 0).sum()), dfvara=pr.dfvara,
                            s2vara=pr.s2vara, dfvare=pr.dfvare, s2vare=pr.s2vare,
                            s2varg=pr.s2varg, lambda_rate0=pr.lambda_rate0,
                            shard_schedule="pipeline", resync_every=5)
        st, smp, _ = TG.run_chains(spec, data, pr, pi, seed=11, nchains=4, mesh=mesh)
        fit = htt.ibrm("y ~ 1", data={"id": ids, "y": p["y_na"]}, M=geno, M_id=ids,
                       method="BayesR", niter=12, nburn=4, thin=2, block=B,
                       dtype=torch.float64, nchains=4, seed=13, verbose=False,
                       device="cpu", mesh=mesh, shard_schedule="pipeline")
        runs[name] = {"state": as_numpy(st), "samples": smp, "gebv": fit.g["gebv"],
                      "g": fit.MCMCsamples["g"], "e": fit.e["e"], "alpha": fit.alpha,
                      "X_rows": int(data.X_blocks.shape[0])}
    return runs


def snp_shard_cases(rank, world, payload):
    """tests/test_torch_snp_shards.py on a (1, world) mesh: {"layout": (a),
    "fits": (b)}."""
    from hibayes_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(shape=(1, world), device="cpu")
    return {"layout": _snp_shard_layout(mesh, payload), "fits": _snp_shard_fits(mesh, payload)}


def collective_spans(rank, world, payload):
    """tests/test_torch_spans.py: each collective of parallel/distributed.py
    on a (1, world) mesh, and a SnpShard set-up, under torch.profiler;
    returns the spans as (name, parent's name, counts), and the spans of
    the same calls on a one-rank axis (ind)."""
    from torch.profiler import ProfilerActivity, profile

    from hibayes_tpu_torch.engine import gibbs as TG
    from hibayes_tpu_torch.parallel import distributed as D
    from hibayes_tpu_torch.parallel.mesh import SnpShard, make_mesh
    from hibayes_tpu_torch.utils.profiling import span, spans

    mesh = make_mesh(shape=(1, world), device="cpu")
    x = torch.arange(6, dtype=torch.float64) + rank
    M, y = payload["M"], payload["y"]
    c0, cnt = mesh.snp_range(M.shape[1], 8)

    def calls(axis):
        with span("test.calls"):
            D.axis_sum(x, mesh, axis)
            D.broadcast(x, mesh, axis, 0)
            D.broadcast(x[:2], mesh, axis, 1 % mesh.size(axis))
            D.all_gather(x.to(torch.int32), mesh, axis)
            D.all_gather(x[:4 - rank], mesh, axis, total=7)
            D.ring_hop((x, x[:1].to(torch.float32)), mesh, axis)

    with profile(activities=[ProfilerActivity.CPU]):
        calls("snp")
        TG.prepare_gibbs_data(y, SnpShard(M[:, c0:c0 + cnt], c0, M.shape[1]), block=8,
                              geno_dtype="int8", mesh=mesh)
    recs = spans()
    with profile(activities=[ProfilerActivity.CPU]):
        calls("ind")
    one = spans()
    name = lambda recs, i: None if i is None else recs[i].name
    return ([(r.name, name(recs, r.parent), r.counts) for r in recs],
            [(r.name, name(one, r.parent), r.counts) for r in one])


def _altered_rank(rank, *args):
    """port_bench's ibrm_mesh rank with one effect of its shard altered
    after each of its sweeps, on rank 2 alone."""
    from hibayes_tpu_torch.ops import blockgibbs
    from port_bench.entries import ibrm_mesh

    if rank == 2:
        orig = blockgibbs.sweep_mc

        def altered(*a, **kw):
            out = list(orig(*a, **kw))
            g = out[0].clone()
            g[..., 7] += 0.5
            return (g, *out[1:])

        blockgibbs.sweep_mc = altered
    return ibrm_mesh.rank_main(rank, *args)


def harness_mesh_case(rank, world, payload):
    """tests/test_torch_snp_shards.py: port_bench's harness on the CPU at a
    small size of the SNP-sharded cell (its ranks 1-3 spawned by the entry,
    over gloo); with ``payload["alter"]`` rank 2's sweeps altered.  Returns
    the result line and the ranks' processes left alive."""
    import multiprocessing

    from port_bench import harness
    from port_bench.entries import ibrm_mesh

    if payload["alter"]:
        ibrm_mesh.Fit.rank_main = staticmethod(_altered_rank)
    r = harness.run(payload["cell"]["name"], payload["seed"], 1.0, False, device="cpu",
                    require_chip=False, cell=payload["cell"], cfg=payload["cfg"])
    return r, [p.pid for p in multiprocessing.active_children()]
