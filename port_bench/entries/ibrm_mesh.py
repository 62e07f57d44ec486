"""The individual-level fit (ibrm) of a cell on a SNP-sharded mesh of
several cards: one process a card, joined by ``torch.distributed`` (NCCL
between cards, gloo on the CPU), every rank running the fit alike, as
``ibrm(mesh=...)`` runs on a mesh (model/ibrm.py), each rank given its own
SNP columns alone (parallel/mesh.py:SnpShard).

Rank 0 is the harness's own process: its inputs (its columns and the
phenotype) are the harness's, and so are the window's hook, the trace, the
memory peak and the check.  ``Fit.__init__`` builds the kernels (rank 0,
before any other rank starts, so that no two ranks run nvcc into the
package's build directory at once), starts ranks 1 .. S - 1 (a ``spawn``
context), joins them in one process group, and prepares every rank through
``prepare_gibbs_data`` of its own columns.  ``run(spec)`` hands the spec
to the other ranks and calls the chain runner ``run_chains(..., mesh=...)``
on every rank.  ``free`` ends the other ranks, each reporting its memory
peak (printed to standard error).

A rank that fails ends the run with an error: its traceback reaches rank 0
through its pipe, and a collective left waiting ends at the process
group's timeout (``TIMEOUT_S``; NCCL's watchdog aborts the process).  The
other ranks are daemons that the kernel kills when rank 0 ends
(``PR_SET_PDEATHSIG``): none outlives the run.
"""

from __future__ import annotations

import ctypes
import datetime
import signal
import socket
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from hibayes_tpu_torch.engine import gibbs as G
from hibayes_tpu_torch.model.formula import build_model_frame
from hibayes_tpu_torch.model.ibrm import _align_data_to_ids
from hibayes_tpu_torch.parallel.mesh import SnpShard, make_mesh

from . import mixture
from .ibrm import Fit as IbrmFit
from ..inputs import cohort_sharded
from ..reference.ibrm_mesh import IbrmMeshReference

TIMEOUT_S = 300   # the process group's: a collective that waits longer ends the run


def _prepare(cfg: dict, cell: dict, data: dict, start: int, M, mesh, dev) -> tuple:
    """One rank's set-up of its columns ``M`` (from column ``start``), as
    ibrm prepares a SnpShard: (data, priors, spec, Pi), the spec's
    iteration counts the window's to set."""
    Pi, fold = mixture(cfg, int(cell["traffic"]["thin"]))
    aligned = _align_data_to_ids(data, np.asarray(data["id"]).astype(str))
    mf = build_model_frame(cfg["formula"], aligned)
    nlevels = tuple(int(len(lv)) for lv in mf.R_levels)
    gdata = G.prepare_gibbs_data(
        mf.y, SnpShard(M, start, cfg["m"]), C=mf.X, r_codes=tuple(mf.R_codes),
        r_nlevels=nlevels, fold=fold, block=cfg["block"], dtype=getattr(torch, cfg["dtype"]),
        geno_dtype=cfg["geno_dtype"], device=dev, nblocks_multiple=mesh.size("snp"),
        mesh=mesh)
    m = cfg["m"]
    vx = gdata.vx.cpu().numpy()
    pr = G.resolve_priors(mf.y, float(vx.sum()), float(Pi[0]), nr=len(nlevels))
    spec = G.GibbsSpec(
        model=cfg["method"], n=int(gdata.y.shape[0]), n_real=len(mf.y), m=m,
        m_pad=int(gdata.xpx.shape[0]), block=gdata.block,
        nc=mf.X.shape[1] if mf.X is not None else 0, nlevels=nlevels,
        n_fold=len(Pi), niter=50, nburn=30, thin=int(cell["traffic"]["thin"]),
        nvar0=int((vx[:m] == 0).sum()), fixpi=False, dfvara=pr.dfvara,
        s2vara=pr.s2vara, dfvare=pr.dfvare, s2vare=pr.s2vare, dfr=pr.dfr, s2r=pr.s2r,
        s2varg=pr.s2varg, lambda_rate0=pr.lambda_rate0,
        shard_schedule=cfg["shard_schedule"])
    return gdata, pr, spec, Pi


def _group(backend: str, init: str, world: int, rank: int, timeout_s: float) -> None:
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


def rank_main(rank: int, world: int, init: str, cfg: dict, cell: dict, seed: int,
              data: dict, conn, dev_type: str, timeout_s: float) -> None:
    """Rank ``rank`` (not 0) of the fit: its columns made from the seed on
    its card, its set-up, then each spec rank 0 sends run through the chain
    runner, until rank 0 says "free" (its memory peak sent back)."""
    try:
        # killed with rank 0 (Linux; PR_SET_PDEATHSIG = 1)
        ctypes.CDLL(None, use_errno=True).prctl(1, int(signal.SIGKILL), 0, 0, 0)
    except (OSError, AttributeError):
        pass
    try:
        torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"])
        torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"])
        cuda = dev_type == "cuda"
        if cuda:
            torch.cuda.set_device(rank)
            dev = torch.device("cuda", rank)
        else:
            torch.set_num_threads(1)
            dev = torch.device("cpu")
        start, M = cohort_sharded.shard(cfg, seed, rank, dev)
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        conn.send(("joining", None))
        _group("nccl" if cuda else "gloo", init, world, rank, timeout_s)
        mesh = make_mesh(shape=tuple(cfg["mesh"]), device=dev)
        gdata, pr, _, Pi = _prepare(cfg, cell, data, start, M, mesh, dev)
        conn.send(("ready", None))
        K = int(cell["traffic"]["chains"])
        while True:
            cmd, spec = conn.recv()
            if cmd == "run":
                G.run_chains(spec, gdata, pr, Pi, seed=seed, nchains=K, mesh=mesh)
                conn.send(("done", None))
            else:
                conn.send(("free", torch.cuda.max_memory_allocated(dev) if cuda else 0))
                return
    except BaseException:
        try:
            conn.send(("error", traceback.format_exc()))
        except OSError:
            pass
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Fit(IbrmFit):
    """One cell's fit on a (1, S) mesh of S cards: this process is rank 0,
    ``inputs`` its part of the cohort (cohort_sharded.make)."""

    rank_main = staticmethod(rank_main)   # what ranks 1 .. S - 1 run

    def __init__(self, cfg: dict, cell: dict, inputs: dict, seed: int, dev):
        import multiprocessing

        self.cfg, self.cell, self.inputs, self.seed = cfg, cell, inputs, int(seed)
        self.K = int(cell["traffic"]["chains"])
        self.step_name = "one_iteration" if self.K == 1 else "one_iteration_batch"
        shape = tuple(cfg["mesh"])
        if shape[0] != 1:
            raise ValueError(f"ibrm_mesh runs a (1, S) mesh, not {shape}")
        S = shape[1]
        cuda = dev.type == "cuda"
        if cuda:
            from hibayes_tpu_torch.ops import build

            build.build()   # once, here: the other ranks load what this built
            dev = torch.device("cuda", torch.cuda.current_device())
        self.dev, self.procs, self.conns = dev, [], []
        t0 = time.perf_counter()
        ctx = multiprocessing.get_context("spawn")
        init = f"tcp://127.0.0.1:{_free_port()}"
        try:
            for r in range(1, S):
                ours, theirs = ctx.Pipe()
                p = ctx.Process(target=self.rank_main, daemon=True, args=(
                    r, S, init, cfg, cell, self.seed, inputs["data"], theirs, dev.type,
                    TIMEOUT_S))
                p.start()
                theirs.close()
                self.procs.append(p)
                self.conns.append(ours)
            self._replies("joining")   # a rank that failed to start raises here
            _group("nccl" if cuda else "gloo", init, S, 0, TIMEOUT_S)
            self.mesh = make_mesh(shape=shape, device=dev)
            t1 = time.perf_counter()
            self.gdata, self.priors, self.spec0, self.Pi = _prepare(
                cfg, cell, inputs["data"], inputs["start"], inputs["M"], self.mesh, dev)
            self._replies("ready")
            print(f"ranks 1-{S - 1} started and joined in {t1 - t0:.1f} s, every rank "
                  f"prepared in {time.perf_counter() - t1:.1f} s", file=sys.stderr)
        except BaseException:
            self._end(wait=0)
            raise

    def _replies(self, want: str) -> list:
        """Each other rank's next message, which must be ``want``: a rank's
        error, or its end without a message, raises; so does no message in
        TIMEOUT_S."""
        out = []
        for r, (p, c) in enumerate(zip(self.procs, self.conns), start=1):
            t_end = time.monotonic() + TIMEOUT_S
            while not c.poll(1.0):
                if not p.is_alive():
                    raise RuntimeError(f"rank {r} ended (exit code {p.exitcode}) "
                                       f"before it sent {want!r}")
                if time.monotonic() > t_end:
                    raise TimeoutError(f"rank {r} sent no {want!r} in {TIMEOUT_S} s")
            kind, val = c.recv()
            if kind != want:
                raise RuntimeError(f"rank {r}: {kind}, not {want!r}:\n{val}")
            out.append(val)
        return out

    def run(self, spec):
        """One call to the chain runner on every rank, as ibrm makes it on a
        mesh (quiet); rank 0's result."""
        try:
            for c in self.conns:
                c.send(("run", spec))
            out = G.run_chains(spec, self.gdata, self.priors, self.Pi, seed=self.seed,
                               nchains=self.K, mesh=self.mesh)
            self._replies("done")
            return out
        except BaseException:
            self._end(wait=0)
            raise

    def free(self):
        """Ends the other ranks (each sends its memory peak, printed here);
        the check that follows runs in this process alone."""
        self.gdata = None
        peaks = [torch.cuda.max_memory_allocated(self.dev) if self.dev.type == "cuda" else 0]
        t0 = time.perf_counter()
        try:
            for c in self.conns:
                c.send(("free", None))
            peaks += self._replies("free")
            self._leave()   # with the other ranks, which leave the group as they end
        finally:
            self._end()
        print(f"ranks 1-{len(peaks) - 1} ended in {time.perf_counter() - t0:.1f} s",
              file=sys.stderr)
        for r, b in enumerate(peaks):
            print(f"rank {r} peak_mem_gib {b / 2 ** 30!r}", file=sys.stderr)

    def _end(self, wait: float = 30):
        """Joins the other ranks (``wait`` seconds each, then kills them) and
        leaves the process group."""
        for p in self.procs:
            p.join(timeout=wait)
            if p.is_alive():
                p.kill()
                p.join()
        for c in self.conns:
            c.close()
        self.procs, self.conns = [], []
        self._leave()

    @staticmethod
    def _leave():
        if dist.is_initialized():
            dist.destroy_process_group()

    def reference(self, dtype, operands=None):
        return IbrmMeshReference(self.cfg, self.inputs["seed"], self.inputs["data"], self.dev,
                                 dtype, operands)
