"""Command-line interface for batch runs on the card.

    python -m hibayes_tpu_torch ibrm  --bfile demo --pheno demo.phe --formula "T1~sex" ...
    python -m hibayes_tpu_torch sbrm  --sumstat demo.ma --bfile demo [--chisq 5] ...
    python -m hibayes_tpu_torch ssbrm --bfile demo --pheno demo.phe --ped demo.ped ...
    python -m hibayes_tpu_torch ldmat --bfile demo --out ld.npz [--chisq 5] [--by-chr]

The port of hibayes_tpu/cli.py: the same subcommands, flags, defaults and
output files.  Fits are written as TSVs under --out-prefix:
<prefix>.alpha.tsv (SNP effects + PIP), <prefix>.gebv.tsv, <prefix>.var.tsv
(variance components), <prefix>.gwas.tsv (window WPPA, when windows are
asked for); ``ldmat --out`` writes the JAX CLI's npz keys.  ``--checkpoint
PATH`` saves the chain to PATH.npz / PATH.meta.json as it runs, and a run
started again with the same arguments resumes from there.

Two deviations: ``--device`` (default cuda; cpu runs the kernels' plain
versions) names the device every entry point runs on; and a shard
schedule other than ``turn`` with ``--shards 1`` is refused, where the JAX
CLI silently runs the plain sweep.  ``ibrm --shards S`` runs on S cards
under ``torchrun --nproc-per-node S -m hibayes_tpu_torch ibrm --shards S
...``: every rank joins the process group (parallel/distributed.py,
``env://``), the fit runs on a (1, S) mesh (``make_mesh(shape=(1, S))``,
as the JAX CLI's) and rank 0 alone prints and writes the files, under
any ``--shard-schedule`` (``concurrent``: one merge round an iteration,
as the JAX CLI's; it warns where m > n, its biased regime).
Besides the JAX CLI's lines, each fitting run prints the read_plink
seconds, the iteration it resumes at, and the chain's seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

import hibayes_tpu_torch as ht

from .data.ld import as_numpy
from .data.pedigree import read_pedigree


def _write_tsv(path, cols: dict):
    keys = list(cols)
    n = len(np.asarray(cols[keys[0]]))
    with open(path, "w") as f:
        f.write("\t".join(keys) + "\n")
        for i in range(n):
            f.write("\t".join(str(np.asarray(cols[k])[i]) for k in keys) + "\n")


def save_fit(fit, prefix, map_=None):
    """Write a fit's TSVs, as the JAX CLI's ``_save_fit``."""
    alpha_cols = {"alpha": fit.alpha}
    if map_ is not None:
        alpha_cols = {"SNP": map_["SNP"], "Chr": map_["Chr"], "Pos": map_["Pos"],
                      "alpha": fit.alpha}
    if fit.pip is not None:
        alpha_cols["pip"] = fit.pip
    _write_tsv(prefix + ".alpha.tsv", alpha_cols)
    if fit.g is not None:
        _write_tsv(prefix + ".gebv.tsv", fit.g)
    var = {"param": ["mu", "Vg", "Ve", "h2"],
           "value": [fit.mu, fit.Vg, fit.Ve, fit.h2]}
    if fit.Veps is not None:
        var["param"].append("Veps")
        var["value"].append(fit.Veps)
    _write_tsv(prefix + ".var.tsv", var)
    if fit.gwas is not None:
        _write_tsv(prefix + ".gwas.tsv", fit.gwas)
    print(f"written {prefix}.alpha.tsv / .gebv.tsv / .var.tsv"
          + (" / .gwas.tsv" if fit.gwas is not None else ""))


def _save_plots(fit, prefix, map_):
    import matplotlib

    matplotlib.use("Agg")
    from . import plot

    written = []
    if fit.pip is not None and map_ is not None:
        fig, _ = plot.manhattan_pip(fit, map_)
        fig.savefig(prefix + ".pip.png", dpi=150)
        written.append(".pip.png")
    if fit.gwas is not None:
        fig, _ = plot.manhattan_wppa(fit)
        fig.savefig(prefix + ".wppa.png", dpi=150)
        written.append(".wppa.png")
    fig, _ = plot.trace(fit)
    fig.savefig(prefix + ".trace.png", dpi=150)
    written.append(".trace.png")
    print("written " + " / ".join(prefix + w for w in written))


def _common_mcmc_args(p):
    p.add_argument("--method", default="BayesCpi")
    p.add_argument("--niter", type=int, default=None)
    p.add_argument("--nburn", type=int, default=None)
    p.add_argument("--thin", type=int, default=5)
    p.add_argument("--seed", type=int, default=666666)
    p.add_argument("--windsize", type=float, default=None)
    p.add_argument("--windnum", type=int, default=None)
    p.add_argument("--out-prefix", default="fit")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--plots", action="store_true",
                   help="also write <prefix>.{pip,wppa,trace}.png (matplotlib)")
    _device_arg(p)


def _device_arg(p):
    p.add_argument("--device", default="cuda",
                   help="device every entry point runs on: cuda (default), or cpu "
                        "for the kernels' plain versions")


def _parser():
    ap = argparse.ArgumentParser(prog="hibayes_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_i = sub.add_parser("ibrm", help="individual-level Bayesian regression")
    p_i.add_argument("--bfile", required=True)
    p_i.add_argument("--pheno", required=True)
    p_i.add_argument("--formula", required=True)
    p_i.add_argument("--nchains", type=int, default=1)
    p_i.add_argument("--shards", type=int, default=1,
                     help="SNP-axis model-parallel shards (devices, one rank each: "
                          "run under torchrun --nproc-per-node SHARDS)")
    p_i.add_argument("--shard-schedule", default="turn",
                     choices=("turn", "pipeline", "concurrent"),
                     help="m-MP sweep schedule across --shards devices; with one "
                          "shard only 'turn' runs")
    _common_mcmc_args(p_i)

    p_s = sub.add_parser("sbrm", help="summary-level Bayesian regression")
    p_s.add_argument("--sumstat", required=True)
    p_s.add_argument("--bfile", required=True, help="LD reference panel")
    p_s.add_argument("--chisq", type=float, default=None)
    p_s.add_argument("--by-chr", action="store_true")
    p_s.add_argument("--tiled", action="store_true",
                     help="O(nnz) tiled-sparse LD (large m)")
    p_s.add_argument("--tile", type=int, default=128)
    p_s.add_argument("--stripe", type=int, default=4096)
    _common_mcmc_args(p_s)

    p_ss = sub.add_parser("ssbrm", help="single-step Bayesian regression")
    p_ss.add_argument("--bfile", required=True)
    p_ss.add_argument("--pheno", required=True)
    p_ss.add_argument("--formula", required=True)
    p_ss.add_argument("--ped", required=True)
    p_ss.add_argument("--maf", type=float, default=0.01)
    p_ss.add_argument("--impute", default="auto", choices=("auto", "direct", "pcg"),
                      help="imputation operator: pcg = matrix-free scale path")
    _common_mcmc_args(p_ss)

    p_l = sub.add_parser("ldmat", help="LD matrix construction")
    p_l.add_argument("--bfile", required=True)
    p_l.add_argument("--out", required=True)
    p_l.add_argument("--chisq", type=float, default=None)
    p_l.add_argument("--by-chr", action="store_true")
    p_l.add_argument("--tiled", action="store_true",
                     help="stream stripes into an O(nnz) tile store")
    p_l.add_argument("--tile", type=int, default=128)
    p_l.add_argument("--stripe", type=int, default=4096)
    p_l.add_argument("--quiet", action="store_true")
    _device_arg(p_l)
    return ap


def save_ld(ld, out):
    """``ldmat --out``: the JAX CLI's npz keys for each layout."""
    if hasattr(ld, "tiles"):
        np.savez(out, kind="tiled", tile=ld.tile, m=ld.m, col_idx=as_numpy(ld.col_idx),
                 valid=as_numpy(ld.valid), tiles=as_numpy(ld.tiles),
                 nnz_col=as_numpy(ld.nnz_col))
    elif hasattr(ld, "blocks"):
        np.savez(out, kind="blockdiag",
                 **{f"block_{i}": as_numpy(b) for i, b in enumerate(ld.blocks)})
    else:
        np.savez(out, kind=type(ld).__name__, values=as_numpy(ld.values))


def _shard_mesh(shards: int, device: str):
    """The (1, shards) mesh of an ``ibrm --shards`` run under torchrun, or
    None for one shard.  Raises where the process group is not ``shards``
    ranks (one rank a card)."""
    if shards <= 1:
        return None
    from .parallel.distributed import init_multihost
    from .parallel.mesh import make_mesh

    backend = "nccl" if device.startswith("cuda") else "gloo"
    world, _ = init_multihost(backend=backend)
    if world != shards:
        raise RuntimeError(
            f"--shards {shards} needs {shards} ranks, one a device: run it as torchrun "
            f"--nproc-per-node {shards} -m hibayes_tpu_torch ibrm --shards {shards} ... "
            f"(this process group has {world})")
    dev = None if device.startswith("cuda") else "cpu"
    return make_mesh(shards, shape=(1, shards), device=dev)


def main(argv=None):
    ap = _parser()
    a = ap.parse_args(argv)
    if getattr(a, "shards", 1) == 1 and getattr(a, "shard_schedule", "turn") != "turn":
        ap.error(f"--shard-schedule {a.shard_schedule} needs --shards > 1; with one shard "
                 "only 'turn' runs (the JAX CLI runs the plain sweep there silently)")
    mesh = _shard_mesh(getattr(a, "shards", 1), a.device)
    lead = mesh is None or mesh.rank == 0

    if a.cmd == "ldmat":
        binr = ht.read_plink(a.bfile)
        ld = ht.ldmat(binr["geno"], map=binr["map"], chisq=a.chisq,
                      ldchr=not a.by_chr, tiled=a.tiled, tile=a.tile,
                      stripe=a.stripe, progress=a.tiled and not a.quiet,
                      device=a.device)
        save_ld(ld, a.out)
        print(f"LD matrix ({type(ld).__name__}) written to {a.out}")
        return 0

    t0 = time.perf_counter()
    binr = ht.read_plink(a.bfile)
    n, m = binr["geno"].values.shape
    if lead:
        print(f"read_plink {a.bfile}: {n} x {m} in {time.perf_counter() - t0!r} s")
    if lead and a.checkpoint and os.path.exists(a.checkpoint + ".meta.json"):
        with open(a.checkpoint + ".meta.json") as f:
            print(f"checkpoint {a.checkpoint}: resuming at iteration {json.load(f)['it']}")
    verbose = not a.quiet
    common = dict(method=a.method, niter=a.niter, nburn=a.nburn, thin=a.thin,
                  seed=a.seed, verbose=verbose, checkpoint=a.checkpoint, device=a.device)
    if a.windsize or a.windnum:
        common.update(map=binr["map"], windsize=a.windsize, windnum=a.windnum)

    if a.cmd == "ibrm":
        pheno = ht.read_pheno(a.pheno)
        if mesh is not None:
            common.update(mesh=mesh, shard_schedule=a.shard_schedule,
                          device=str(mesh.device))
        fit = ht.ibrm(a.formula, data=pheno, M=binr["geno"].values,
                      M_id=binr["fam"][1], nchains=a.nchains, **common)
    elif a.cmd == "sbrm":
        ma = ht.read_sumstat(a.sumstat)
        ld = ht.ldmat(binr["geno"], map=binr["map"], chisq=a.chisq,
                      ldchr=not a.by_chr, tiled=a.tiled, tile=a.tile,
                      stripe=a.stripe, device=a.device)
        fit = ht.sbrm(ma, ld, **common)
    else:  # ssbrm
        pheno = ht.read_pheno(a.pheno)
        pid, ps, pd_ = read_pedigree(a.ped)
        fit = ht.ssbrm(a.formula, data=pheno, M=binr["geno"].values,
                       M_id=binr["fam"][1],
                       pedigree={"id": pid, "sire": ps, "dam": pd_},
                       maf=a.maf, impute=a.impute, **common)
    if not lead:
        return 0
    print(f"chain {fit.chain_seconds!r} s")

    save_fit(fit, a.out_prefix, map_=binr["map"])
    if a.plots:
        _save_plots(fit, a.out_prefix, binr["map"])
    if fit.rhat:
        print("R-hat:", json.dumps({k: round(v, 4) for k, v in fit.rhat.items()
                                    if isinstance(v, float)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
