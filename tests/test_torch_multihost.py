"""Multi-process runs of the port on the CPU (gloo), the counterpart of
tests/test_multihost.py, and the mesh keywords of the entry points and the
command line.

Two ranks join by ``init_multihost`` (a file:// address), each decodes only
its own rows of a PLINK fileset (``load_plink_host_sharded``: the row-range
.bed decode with the global major-allele imputation), then runs a short
n-sharded chain on the (2, 1) mesh and an ``ibrm`` fit on (1, 2).  Both
ranks must agree with each other and with one process.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import hibayes_tpu_torch as htt
from hibayes_tpu_torch import cli
from hibayes_tpu_torch.data.plink import encode_bed_bytes, read_plink
from hibayes_tpu_torch.engine import gibbs as TG
from hibayes_tpu_torch.parallel import distributed
from hibayes_tpu_torch.parallel.mesh import make_mesh

from .torch_dist import _multihost_chain, spawn

torch.set_num_threads(2)


def _fileset(tmp_path, n=16, m=32):
    rng = np.random.default_rng(4)
    g = rng.integers(0, 3, size=(n, m)).astype(np.int8)
    g[rng.random(g.shape) < 0.1] = -9
    (tmp_path / "t.bed").write_bytes(encode_bed_bytes(g))
    with open(tmp_path / "t.bim", "w") as f:
        for j in range(m):
            f.write(f"1\tM{j}\t0\t{j + 1}\tA\tG\n")
    with open(tmp_path / "t.fam", "w") as f:
        for i in range(n):
            f.write(f"F{i}\tI{i}\t0\t0\t0\t-9\n")
    return str(tmp_path / "t")


def test_two_process_host_sharded_load(tmp_path):
    """Each rank's rows are its half of the whole read bit for bit; the
    n-sharded chain's records agree across ranks and with one process to
    rtol 1e-8 (f64); the ibrm fit on (1, 2) agrees with a one-process fit."""
    bfile = _fileset(tmp_path)
    outs = spawn("tests.torch_dist:multihost_case", 2, tmp_path,
                 {"init": "own", "bfile": bfile})
    full = read_plink(bfile)["geno"].values
    assert outs[0]["rows"] == (0, 8) and outs[1]["rows"] == (8, 8)
    for o in outs:
        r0, rc = o["rows"]
        np.testing.assert_array_equal(o["values"], full[r0:r0 + rc])
        np.testing.assert_array_equal(o["local"], full[r0:r0 + rc])
    M = full
    rng = np.random.default_rng(0)
    y = M.astype(np.float64) @ rng.normal(0, 0.2, M.shape[1]) + rng.normal(0, 1, M.shape[0])
    spec, data, pr, pi = _multihost_chain(y, M)
    _, smp, ex = TG.run_chain(spec, data, pr, pi, seed=5)
    for k in smp:
        np.testing.assert_array_equal(outs[0]["samples"][k], outs[1]["samples"][k])
        np.testing.assert_allclose(outs[0]["samples"][k], smp[k], rtol=1e-8,
                                   atol=1e-8 * np.abs(smp[k]).max(initial=0), err_msg=k)
    assert np.isfinite(outs[0]["samples"]["Vg"]).all()
    ids = np.array([f"i{k}" for k in range(M.shape[0])])
    fit = htt.ibrm("y ~ 1", data={"id": ids, "y": y}, M=M, M_id=ids, method="BayesCpi",
                   niter=30, nburn=10, block=8, dtype=torch.float64, verbose=False,
                   device="cpu")
    for o in outs:
        np.testing.assert_allclose(o["fit_alpha"], fit.alpha, rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(o["fit_vg"], fit.Vg, rtol=1e-8)


def _ibrm_inputs(n=60, m=64, seed=0):
    rng = np.random.default_rng(seed)
    M = rng.binomial(2, 0.3, size=(n, m)).astype(np.int8)
    y = M @ rng.normal(0, 0.1, m) + rng.normal(0, 1, n)
    ids = np.array([f"i{k}" for k in range(n)])
    return dict(data={"id": ids, "T1": y}, M=M, M_id=ids)


def test_mesh_keywords_run_on_one_rank():
    """The mesh keywords of ibrm, sbrm and ssbrm run: a one-rank mesh
    (make_mesh without a process group) is the one-device fit bit for bit;
    the pipeline emulation runs a chain batch (emulate_shards=2, the blocks
    padded to a multiple of the shards)."""
    mesh = make_mesh()
    assert mesh.shape == {"ind": 1, "snp": 1} and mesh.world == 1
    kw = dict(_ibrm_inputs(), niter=20, nburn=10, verbose=False, device="cpu",
              dtype=torch.float64)
    a = htt.ibrm("T1~1", mesh=mesh, **kw)
    b = htt.ibrm("T1~1", **kw)
    np.testing.assert_array_equal(a.alpha, b.alpha)
    p = htt.ibrm("T1~1", nchains=4, shard_schedule="pipeline", emulate_shards=2,
                 method="BayesCpi", block=24, **kw)
    assert p.MCMCsamples["alpha"].shape == (8, 64) and np.isfinite(p.alpha).all()
    m = 64
    R = 0.5 ** np.abs(np.arange(m)[:, None] - np.arange(m)[None, :])
    beta = R @ np.where(np.arange(m) % 9 == 0, 0.1, 0.0)
    ss = np.column_stack([np.full(m, .3), beta, np.full(m, .01), np.full(m, 1e4)])
    skw = dict(method="BayesCpi", niter=20, nburn=10, seed=3, verbose=False, device="cpu")
    np.testing.assert_array_equal(htt.sbrm(ss, R, mesh=mesh, **skw).alpha,
                                  htt.sbrm(ss, R, **skw).alpha)
    with pytest.raises(ValueError, match="nchains>1, mesh"):
        htt.sbrm(ss, R, mesh=mesh, nchains=2, **skw)


@pytest.mark.parametrize("call", ["ibrm", "sbrm", "run_chains", "emulate"])
def test_concurrent_schedule_cites_item_14(call):
    """shard_schedule='concurrent' runs wherever the JAX package runs it
    (the name is from when it was refused, citing ROADMAP item 14).
    Without a mesh or emulate_shards ibrm, sbrm and run_chains run the
    exact sweep, as the JAX package does: bit for bit the "turn" fit.  With
    emulate_shards=2 one iteration is the JAX package's emulation on JAX's
    numbers to rtol 1e-10, and both specs warn of m > n (every case:
    tests/test_torch_concurrent.py)."""
    if call == "ibrm":
        kw = dict(niter=20, nburn=10, verbose=False, device="cpu", **_ibrm_inputs(n=80))
        np.testing.assert_array_equal(htt.ibrm("T1~1", shard_schedule="concurrent", **kw).alpha,
                                      htt.ibrm("T1~1", **kw).alpha)
    elif call == "sbrm":
        m = 16
        ss = np.column_stack([np.full(m, .3), np.zeros(m), np.full(m, .01), np.full(m, 1e4)])
        kw = dict(niter=20, nburn=10, verbose=False, device="cpu")
        np.testing.assert_array_equal(
            htt.sbrm(ss, np.eye(m), shard_schedule="concurrent", merge_rounds=2, **kw).alpha,
            htt.sbrm(ss, np.eye(m), **kw).alpha)
    elif call == "run_chains":
        spec, data, pr, pi = _multihost_chain(*_chain_inputs())
        with pytest.warns(UserWarning, match="block-Jacobi"):   # m (32) > n (20)
            conc = dataclasses.replace(spec, shard_schedule="concurrent")
        _, a, _ = TG.run_chains(conc, data, pr, pi, seed=2, nchains=1)
        _, b, _ = TG.run_chains(spec, data, pr, pi, seed=2, nchains=1)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    else:
        import jax

        from hibayes_tpu.engine import gibbs as G
        from hibayes_tpu_torch.engine.convert import chain_state_from_numpy

        from .torch_parity import JaxNoise, port_spec

        jspec, data, pr, pi = _jax_chain(*_chain_inputs())
        with pytest.warns(UserWarning, match="block-Jacobi"):   # m (32) > n (20)
            jspec = dataclasses.replace(jspec, shard_schedule="concurrent", emulate_shards=2)
        with pytest.warns(UserWarning, match="block-Jacobi"):
            pspec = port_spec(jspec)
        st = G.init_state(jspec, data, pr, pi)
        key = jax.random.PRNGKey(4)
        ref = jax.jit(lambda s: G.one_iteration(jspec, data, key, s))(st)
        out = TG.one_iteration(pspec, TG.prepare_gibbs_data(
            *_chain_inputs(), block=8, dtype=torch.float64, geno_dtype="int8"), 0,
            chain_state_from_numpy(jax.tree_util.tree_map(np.asarray, st)),
            noise=JaxNoise(key, 0))
        for k in ("g", "yadj", "u", "vara", "vare"):
            np.testing.assert_allclose(getattr(out, k).numpy(), np.asarray(getattr(ref, k)),
                                       rtol=1e-10, atol=1e-12, err_msg=k)
        np.testing.assert_array_equal(out.track.numpy(), np.asarray(ref.track))


def _jax_chain(y, M):
    """The JAX package's counterpart of ``_multihost_chain``'s chain."""
    import jax.numpy as jnp

    from hibayes_tpu.engine import gibbs as G

    pi = np.array([0.95, 0.05])
    data = G.prepare_gibbs_data(y, M, block=8, dtype=jnp.float64, geno_dtype="int8")
    pr = G.resolve_priors(y, float(np.asarray(data.vx).sum()), pi[0], nr=0)
    m = M.shape[1]
    spec = G.GibbsSpec(model="BayesCpi", n=len(y), m=m, m_pad=int(data.xpx.shape[0]),
                       block=8, nc=0, nlevels=(), n_fold=2, niter=40, nburn=20, thin=5,
                       nvar0=int((np.asarray(data.vx)[:m] == 0).sum()), dfvara=pr.dfvara,
                       s2vara=pr.s2vara, dfvare=pr.dfvare, s2vare=pr.s2vare,
                       s2varg=pr.s2varg, lambda_rate0=pr.lambda_rate0)
    return spec, data, pr, pi


def test_pipeline_refusals():
    """The JAX package's refusals: a single chain has no groups to rotate;
    the pipeline emulation needs the chains a multiple of the shards."""
    spec, data, pr, pi = _multihost_chain(*_chain_inputs())
    pipe = dataclasses.replace(spec, shard_schedule="pipeline", emulate_shards=2)
    st = TG.init_state(pipe, data, pr, pi)
    with pytest.raises(ValueError, match="multi-chain"):
        TG.one_iteration(pipe, data, 1, st)
    with pytest.raises(ValueError, match="multiple"):
        TG.one_iteration_batch(pipe, data, 1, TG.stack_state(st, 3))


def _chain_inputs():
    rng = np.random.default_rng(1)
    M = rng.integers(0, 3, size=(20, 32)).astype(np.int8)
    return M.astype(np.float64) @ rng.normal(0, 0.2, 32) + rng.normal(0, 1, 20), M


def test_cli_shards_outside_torchrun(tmp_path):
    """``ibrm --shards 2`` outside torchrun errors, naming torchrun; so does
    a process group of another size."""
    bfile = _fileset(tmp_path)
    phe = tmp_path / "t.phe"
    with open(phe, "w") as f:
        f.write("FID IID T1\n")
        for i in range(16):
            f.write(f"F{i} I{i} {0.1 * i}\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")}
    proc = subprocess.run(
        [sys.executable, "-m", "hibayes_tpu_torch", "ibrm", "--bfile", bfile, "--pheno",
         str(phe), "--formula", "T1 ~ 1", "--shards", "2", "--device", "cpu",
         "--niter", "4", "--nburn", "2", "--out-prefix", str(tmp_path / "fit")],
        capture_output=True, text=True, timeout=120, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode != 0
    assert "torchrun --nproc-per-node 2" in proc.stderr
    assert not os.path.exists(tmp_path / "fit.alpha.tsv")
    with pytest.raises(RuntimeError, match="torchrun"):
        cli._shard_mesh(2, "cpu")
    assert not distributed.COLLECTIVES["timed"]
