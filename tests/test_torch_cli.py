"""The port's command line (hibayes_tpu_torch/cli.py, ``python -m
hibayes_tpu_torch``) on a synthetic PLINK fileset with ``--device cpu``:
the JAX CLI's files and columns for ibrm, sbrm and ssbrm, values equal to
the port's API called with the same arguments, ``ldmat --out`` equal to
the JAX CLI's npz bit for bit on int8 input, a ``--checkpoint`` run killed
and resumed through ``main`` and through a subprocess, the shard
refusals, and ``--shards 2 --shard-schedule concurrent`` under torchrun."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import hibayes_tpu_torch as ht
from hibayes_tpu.cli import main as jax_main
from hibayes_tpu_torch import cli
from hibayes_tpu_torch.data.pedigree import read_pedigree

from .test_torch_checkpoint import Killed, kill_after
from .test_torch_ldmat import _fileset
from .torch_dist import spawn

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, M = 300, 128


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The fileset of tests/test_torch_ldmat.py (two chromosomes with LD,
    1% missing genotypes) at n=300, m=128; a phenotype of its simulated
    genetic values with a covariate and a 4-level factor for 280 ids; the
    cohort's COJO statistics; a pedigree of the 300 genotyped ids and 60
    founders without genotypes, 20 of them phenotyped."""
    tmp = tmp_path_factory.mktemp("cli")
    stem, ss, b = _fileset(tmp, n=N, m=M)
    rng = np.random.default_rng(5)
    bed = ht.read_plink(stem)
    g = bed["geno"].values.astype(np.float64) @ b
    ids = bed["fam"][1]
    founders = np.array([f"F{i}" for i in range(60)])
    par = rng.integers(0, 60, (N, 2))
    with open(stem + ".ped", "w") as f:
        f.write("id sire dam\n")
        f.write("".join(f"{i} 0 0\n" for i in founders))
        f.write("".join(f"{i} {founders[p]} {founders[q]}\n" for i, (p, q) in zip(ids, par)))
    phe_ids = np.concatenate([ids[:260], founders[:20]])
    gv = np.concatenate([g[:260], rng.normal(0, g.std(), 20)])
    y = gv + rng.normal(0, gv.std(), len(gv))
    with open(stem + ".phe", "w") as f:
        f.write("id y x1 grp\n")
        f.write("".join(f"{i} {float(v)!r} {rng.normal()!r} g{rng.integers(4)}\n"
                        for i, v in zip(phe_ids, y)))
    with open(stem + ".ma", "w") as f:
        f.write("SNP A1 A2 MAF BETA SE P NMISS\n")
        f.write("".join(f"{s} A G {' '.join(repr(float(x)) for x in r[:3])} 0.5 "
                        f"{float(r[3])!r}\n" for s, r in zip(bed["map"]["SNP"], ss)))
    return stem


def fit_args(cmd, stem):
    common = ["--niter", "60", "--nburn", "20", "--seed", "7", "--quiet"]
    if cmd == "ibrm":
        return ["ibrm", "--bfile", stem, "--pheno", stem + ".phe", "--formula",
                "y ~ x1 + (1|grp)", "--method", "BayesCpi", "--windsize", "20000"] + common
    if cmd == "sbrm":
        return ["sbrm", "--sumstat", stem + ".ma", "--bfile", stem, "--by-chr",
                "--method", "BayesCpi"] + common
    return ["ssbrm", "--bfile", stem, "--pheno", stem + ".phe", "--formula", "y ~ x1",
            "--ped", stem + ".ped", "--method", "BayesCpi"] + common


def written(prefix):
    d, base = os.path.split(prefix)
    return sorted(f[len(base):] for f in os.listdir(d) if f.startswith(base + "."))


def table(path):
    rows = [line.split("\t") for line in open(path).read().splitlines()]
    return rows[0], rows[1:]


@pytest.mark.parametrize("cmd", ["ibrm", "sbrm", "ssbrm"])
def test_fit_files_and_columns_match_the_jax_cli(cmd, files, tmp_path):
    """The port's CLI writes the JAX CLI's files, each with its columns in
    its order, one row a SNP or an id, the same SNPs and ids in the same
    order, and the same variance-component names."""
    jp, tp = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jax_main(fit_args(cmd, files) + ["--out-prefix", jp]) == 0
    assert cli.main(fit_args(cmd, files) + ["--out-prefix", tp, "--device", "cpu"]) == 0
    want = {"ibrm": [".alpha.tsv", ".gebv.tsv", ".gwas.tsv", ".var.tsv"],
            "sbrm": [".alpha.tsv", ".var.tsv"],
            "ssbrm": [".alpha.tsv", ".gebv.tsv", ".var.tsv"]}[cmd]
    assert written(jp) == written(tp) == want
    for suffix in want:
        (hj, rj), (ht_, rt) = table(jp + suffix), table(tp + suffix)
        assert ht_ == hj, suffix
        assert len(rt) == len(rj), suffix
        keys = [c for c in ("SNP", "Chr", "Pos", "id", "param", "Chr", "Start", "End")
                if c in hj]
        for c in keys:
            k = hj.index(c)
            assert [r[k] for r in rt] == [r[k] for r in rj], (suffix, c)


@pytest.mark.parametrize("cmd", ["ibrm", "sbrm", "ssbrm"])
def test_fit_values_equal_the_api(cmd, files, tmp_path):
    """The CLI's files are, byte for byte, what the port's API writes through
    the CLI's writer for a fit with the same arguments."""
    out = str(tmp_path / "cli")
    assert cli.main(fit_args(cmd, files) + ["--out-prefix", out, "--device", "cpu"]) == 0
    bed = ht.read_plink(files)
    kw = dict(method="BayesCpi", niter=60, nburn=20, thin=5, seed=7, verbose=False,
              device="cpu")
    if cmd == "ibrm":
        fit = ht.ibrm("y ~ x1 + (1|grp)", data=ht.read_pheno(files + ".phe"),
                      M=bed["geno"].values, M_id=bed["fam"][1], map=bed["map"],
                      windsize=20000.0, windnum=None, **kw)
    elif cmd == "sbrm":
        ld = ht.ldmat(bed["geno"], map=bed["map"], ldchr=False, device="cpu")
        fit = ht.sbrm(ht.read_sumstat(files + ".ma"), ld, **kw)
    else:
        pid, ps, pd_ = read_pedigree(files + ".ped")
        fit = ht.ssbrm("y ~ x1", data=ht.read_pheno(files + ".phe"), M=bed["geno"].values,
                       M_id=bed["fam"][1], pedigree={"id": pid, "sire": ps, "dam": pd_},
                       **kw)
    api = str(tmp_path / "api")
    cli.save_fit(fit, api, map_=bed["map"])
    assert written(api) == written(out)
    for suffix in written(out):
        assert open(api + suffix, "rb").read() == open(out + suffix, "rb").read(), suffix


@pytest.mark.parametrize("flags", [[], ["--by-chr"], ["--chisq", "5"],
                                   ["--tiled", "--chisq", "5", "--tile", "64"]],
                         ids=["dense", "by_chr", "chisq", "tiled"])
def test_ldmat_out_equals_the_jax_cli(flags, files, tmp_path):
    """``ldmat --out`` writes the JAX CLI's npz: the same keys, each array of
    the same dtype and shape and equal bit for bit (int8 genotypes), but
    the tiled store's float32 tiles: both packages build them on their
    device path, whose float32 sums run in other orders, so they agree to
    1e-6 (tests/test_torch_ldmat.py), its columns, masks and counts bit for
    bit."""
    jo, to = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    assert jax_main(["ldmat", "--bfile", files, "--out", jo, "--quiet"] + flags) == 0
    assert cli.main(["ldmat", "--bfile", files, "--out", to, "--quiet", "--device", "cpu"]
                    + flags) == 0
    with np.load(jo) as zj, np.load(to) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            assert zt[k].dtype == zj[k].dtype and zt[k].shape == zj[k].shape, k
            if k == "tiles":
                np.testing.assert_allclose(zt[k], zj[k], rtol=0, atol=1e-6)
            else:
                np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)


def _ck_args(files, out, ck):
    """ibrm at 300 iterations: with the default printfreq (100) a checkpoint
    every 100 iterations."""
    args = fit_args("ibrm", files)
    args[args.index("60")] = "300"
    args[args.index("20", args.index("--nburn"))] = "100"
    return args + ["--out-prefix", out, "--device", "cpu", "--checkpoint", ck]


def _same_files(a, b):
    assert written(a) == written(b)
    for suffix in written(a):
        assert open(a + suffix, "rb").read() == open(b + suffix, "rb").read(), suffix


def test_checkpoint_kill_and_resume_through_main(files, tmp_path, monkeypatch):
    """A CLI run killed after its second checkpoint (iteration 200, past
    burn-in) and run again with the same arguments writes, byte for byte,
    the files of an uninterrupted run."""
    full, out, ck = (str(tmp_path / x) for x in ("full", "out", "ck"))
    assert cli.main(_ck_args(files, full, str(tmp_path / "ck_full"))) == 0
    kill_after(monkeypatch, 2)
    with pytest.raises(Killed):
        cli.main(_ck_args(files, out, ck))
    monkeypatch.undo()
    assert not os.path.exists(out + ".alpha.tsv")
    assert cli.main(_ck_args(files, out, ck)) == 0
    _same_files(full, out)


def test_checkpoint_resume_through_a_subprocess(files, tmp_path, monkeypatch):
    """``python -m hibayes_tpu_torch`` resumes a run killed after its second
    checkpoint, says so, and writes the uninterrupted run's files."""
    full, out, ck = (str(tmp_path / x) for x in ("full", "out", "ck"))
    assert cli.main(_ck_args(files, full, str(tmp_path / "ck_full"))) == 0
    kill_after(monkeypatch, 2)
    with pytest.raises(Killed):
        cli.main(_ck_args(files, out, ck))
    monkeypatch.undo()
    args = [a for a in _ck_args(files, out, ck) if a != "--quiet"]
    # the CPU's reductions split by thread count: the subprocess takes this
    # process's two threads
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": str(torch.get_num_threads())}
    proc = subprocess.run([sys.executable, "-m", "hibayes_tpu_torch", *args], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "resumed from iteration 200 (20 records collected)" in proc.stdout
    assert "read_plink" in proc.stdout and "chain " in proc.stdout
    _same_files(full, out)


def test_shard_options_are_refused(files, capsys):
    """A shard schedule other than 'turn' with one shard is refused with a
    clear error (the JAX CLI runs the plain sweep there silently); more
    than one shard outside torchrun is refused, naming torchrun (it runs
    under torchrun: tests/test_torch_multihost.py)."""
    base = fit_args("ibrm", files) + ["--device", "cpu"]
    with pytest.raises(SystemExit) as e:
        cli.main(base + ["--shards", "1", "--shard-schedule", "pipeline"])
    assert e.value.code == 2
    assert "--shard-schedule pipeline needs --shards > 1" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        cli.main(base + ["--shards", "2"])


def test_shards_concurrent_under_torchrun(files, tmp_path):
    """``torchrun --nproc-per-node 2 -m hibayes_tpu_torch ibrm --shards 2
    --shard-schedule concurrent`` (gloo on the CPU) writes the JAX CLI's
    files, each byte for byte what rank 0 of a (1, 2) mesh writes through
    the CLI's writer for ``ibrm(mesh=..., shard_schedule="concurrent")``
    with the same arguments (ranks of tests/torch_dist.py, one torch
    thread each, as torchrun's workers)."""
    out, api = str(tmp_path / "cli"), str(tmp_path / "api")
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         "2", "-m", "hibayes_tpu_torch"] + fit_args("ibrm", files)
        + ["--shards", "2", "--shard-schedule", "concurrent", "--device", "cpu",
           "--out-prefix", out],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    spawn("tests.torch_dist:cli_fit_case", 2, tmp_path, {"stem": files, "prefix": api})
    assert written(out) == written(api) == [".alpha.tsv", ".gebv.tsv", ".gwas.tsv", ".var.tsv"]
    for suffix in written(out):
        assert open(api + suffix, "rb").read() == open(out + suffix, "rb").read(), suffix


@pytest.mark.parametrize("tile", [256, 10])
def test_sbrm_tiled_at_any_tile_writes_the_jax_cli_files(tile, files, tmp_path):
    """``sbrm --tiled --tile 256`` (and 10) runs: the tiled sweep takes the
    store re-tiled into tiles of 128 (and 12), and the CLI writes the JAX
    CLI's files with its columns, the same SNPs in the same order, finite
    effects and variances."""
    args = ["sbrm", "--sumstat", files + ".ma", "--bfile", files, "--tiled", "--chisq", "5",
            "--tile", str(tile), "--method", "BayesCpi", "--niter", "40", "--nburn", "20",
            "--seed", "7", "--quiet"]
    jp, tp = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jax_main(args + ["--out-prefix", jp]) == 0
    assert cli.main(args + ["--out-prefix", tp, "--device", "cpu"]) == 0
    assert written(jp) == written(tp) == [".alpha.tsv", ".var.tsv"]
    for suffix in written(tp):
        (hj, rj), (ht_, rt) = table(jp + suffix), table(tp + suffix)
        assert ht_ == hj and len(rt) == len(rj), suffix
        for c in ("SNP", "param"):
            if c in hj:
                assert [r[hj.index(c)] for r in rt] == [r[hj.index(c)] for r in rj]
    _, rows = table(tp + ".var.tsv")
    assert rows and all(np.isfinite(float(v)) for r in rows for v in r[1:])
