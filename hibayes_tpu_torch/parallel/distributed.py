"""Multi-process execution: the process group, the collectives of the
sharded sweeps, and host-sharded PLINK ingestion.

Port of hibayes_tpu/parallel/distributed.py.  The JAX package runs one
controller per host over jax.distributed; here every rank is a process
with one device (``torchrun --nproc-per-node S``), joined by
torch.distributed: NCCL between cards, gloo on the CPU (and where two ranks
share one card, which NCCL refuses).

* :func:`init_multihost` joins the process group (``env://`` under
  torchrun) and returns (world size, rank).
* :func:`axis_sum`, :func:`broadcast`, :func:`all_gather` and
  :func:`ring_hop` are the only collectives the engines use, each over one
  axis of a :class:`~hibayes_tpu_torch.parallel.mesh.Mesh`: a sum over
  individuals, the hand-over of a shard's turn, the assembly of per-shard
  outputs and the ring-pipeline's hop to the next shard.  Gloo (two ranks
  on one card) runs the first three on CUDA tensors but not send/recv
  (scripts/gloo_cuda_probe.py on an H100), so :func:`ring_hop` stages its
  tensors through the host there, explicitly and for gloo only.
* :func:`process_row_range` and :func:`load_plink_host_sharded` read only
  this rank's individuals of a .bed file; :func:`load_plink_snp_sharded`
  only this rank's SNPs.

Each collective that runs (an axis of more than one rank) is a span of
the program's store (utils/profiling.py): ``parallel.axis_sum``,
``parallel.broadcast``, ``parallel.all_gather`` or ``parallel.ring_hop``,
around the copies it makes and the call into torch.distributed, with the
counter ``parallel.bytes``: the bytes of this rank's own part (the tensor
it sums, its part of a gather, what it sends a hop; a broadcast's bytes on
its source rank alone).  ``COLLECTIVES``, when ``timed`` is set, sums the
seconds spent in the collectives (the device synchronised before and after
each, so a rank's wait for another is counted): a measurement hook, off in
use.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..utils.profiling import count, span

COLLECTIVES = {"timed": False, "seconds": 0.0}


def reset_collective_timer(timed: bool = False) -> None:
    COLLECTIVES.update(timed=timed, seconds=0.0)


def init_multihost(coordinator_address=None, num_processes=None, process_id=None,
                   backend=None):
    """Join the default process group and return (world size, rank).

    Under torchrun (WORLD_SIZE in the environment) with no arguments it
    reads ``env://``; otherwise ``coordinator_address`` ("host:port" or a
    URL such as tcp://... or file://...), ``num_processes`` and
    ``process_id`` name the group.  A single process with neither returns
    (1, 0) and joins nothing; an initialised group is returned as it is.
    ``backend`` defaults to nccl where a card is present, gloo on the CPU."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    if coordinator_address is None and num_processes is None and "WORLD_SIZE" not in os.environ:
        return 1, 0
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is None:
        url = "env://"
    else:
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
    kw = {}
    if num_processes is not None:
        kw["world_size"] = int(num_processes)
    if process_id is not None:
        kw["rank"] = int(process_id)
    dist.init_process_group(backend, init_method=url, **kw)
    return dist.get_world_size(), dist.get_rank()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _timed(fn, dev):
    if not COLLECTIVES["timed"]:
        return fn()
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize(dev)
    COLLECTIVES["seconds"] += time.perf_counter() - t0
    return out


def axis_sum(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``axis`` (every rank gets it);
    ``t`` itself where the axis has one rank."""
    if mesh is None or mesh.size(axis) <= 1:
        return t
    import torch.distributed as dist

    with span("parallel.axis_sum"):
        count("parallel.bytes", _nbytes(t))
        buf = t.contiguous().clone()

        def run():
            dist.all_reduce(buf, group=mesh.group(axis))
            return buf

        return _timed(run, t.device)


def broadcast(t: torch.Tensor, mesh, axis: str, src: int) -> torch.Tensor:
    """Rank ``src`` (its coordinate on ``axis``)'s ``t`` on every rank of
    the axis: the hand-over after a shard's turn, exact (the owner's values
    bit for bit)."""
    if mesh is None or mesh.size(axis) <= 1:
        return t
    import torch.distributed as dist

    with span("parallel.broadcast"):
        count("parallel.bytes", _nbytes(t) if mesh.index(axis) == src else 0)
        buf = t.contiguous().clone()

        def run():
            dist.broadcast(buf, src=mesh.ranks(axis)[src], group=mesh.group(axis))
            return buf

        return _timed(run, t.device)


def all_gather(t: torch.Tensor, mesh, axis: str, dim: int = -1,
               total: int | None = None) -> torch.Tensor:
    """Every rank's ``t`` of ``axis`` concatenated along ``dim`` in
    coordinate order.  ``total``: the length of the whole along ``dim``
    where the parts are the chunks of :meth:`Mesh.row_range` (the last may
    be shorter); else all parts have ``t``'s shape."""
    S = mesh.size(axis) if mesh is not None else 1
    if S <= 1:
        return t
    import torch.distributed as dist

    with span("parallel.all_gather"):
        count("parallel.bytes", _nbytes(t))
        dim = dim % t.dim()
        per = t.shape[dim] if total is None else -(-total // S)
        x = t
        if x.shape[dim] < per:
            pad = list(x.shape)
            pad[dim] = per - x.shape[dim]
            x = torch.cat([x, torch.zeros(pad, dtype=x.dtype, device=x.device)], dim=dim)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(S)]

        def run():
            dist.all_gather(parts, x, group=mesh.group(axis))
            return parts

        _timed(run, t.device)
        if total is not None:
            parts = [p.narrow(dim, 0, max(0, min(per, total - i * per)))
                     for i, p in enumerate(parts)]
        return torch.cat(parts, dim=dim)


def barrier(mesh) -> None:
    """Wait for every rank of the mesh (after rank 0 writes a file the
    others may read)."""
    if mesh is not None and mesh.world > 1:
        import torch.distributed as dist

        dist.barrier()


def ring_hop(tensors, mesh, axis: str) -> tuple:
    """Each rank of ``axis`` sends ``tensors`` to the next rank of the ring
    and gets the previous rank's (the ring pipeline's hop)."""
    S = mesh.size(axis)
    if S <= 1:
        return tuple(tensors)
    import torch.distributed as dist

    with span("parallel.ring_hop"):
        count("parallel.bytes", sum(_nbytes(t) for t in tensors))
        i = mesh.index(axis)
        nxt, prv = mesh.ranks(axis)[(i + 1) % S], mesh.ranks(axis)[(i - 1) % S]
        grp = mesh.group(axis)
        dev = tensors[0].device
        host = dev.type == "cuda" and dist.get_backend(grp) == "gloo"   # no CUDA send/recv
        send = [t.contiguous().cpu() if host else t.contiguous() for t in tensors]
        recv = [torch.empty_like(t) for t in send]

        def run():
            ops = []
            for s, r in zip(send, recv):
                ops.append(dist.P2POp(dist.isend, s, nxt, grp))
                ops.append(dist.P2POp(dist.irecv, r, prv, grp))
            for w in dist.batch_isend_irecv(ops):
                w.wait()
            return recv

        _timed(run, dev)
        return tuple(r.to(dev) if host else r for r in recv)


# ---------------------------------------------------------------------------
# host-sharded genotype loading
# ---------------------------------------------------------------------------


def process_row_range(global_n: int, mesh, axis="ind") -> tuple:
    """(start, count) of the individual rows this rank holds over ``axis``
    of ``mesh`` (one rank a device: its own chunk)."""
    return mesh.row_range(global_n, axis)


def host_sharded_genotype(local_rows, mesh, axis="ind", device=None) -> torch.Tensor:
    """This rank's rows of the (n, m) genotype, from :func:`process_row_range`,
    as a tensor on ``device`` (the mesh's by default).  The JAX package
    assembles a global sharded array; here each rank keeps its own rows,
    which is the whole of what an SPMD rank holds."""
    return torch.as_tensor(np.ascontiguousarray(local_rows),
                           device=mesh.device if device is None else device)


def load_plink_host_sharded(bfile: str, mesh, axis="ind", mode="A", impute=True,
                            max_chunk_bytes=1 << 30, threads=0):
    """Host-sharded PLINK ingestion: this rank decodes only its own row range
    of the .bed payload (``read_plink(rows=...)``, the global major-allele
    imputation included).  Returns ``(fileset, local_geno)``: the read_plink
    dict whose ``geno.values`` is this rank's rows, and those rows as an
    int8 tensor on the mesh's device."""
    from ..data.plink import read_fam, read_plink

    fam = read_fam(bfile + ".fam")
    n = len(fam[0])
    rows = process_row_range(n, mesh, axis=axis)
    fileset = read_plink(bfile, impute=impute, mode=mode, max_chunk_bytes=max_chunk_bytes,
                         threads=threads, rows=rows)
    return fileset, host_sharded_genotype(fileset["geno"].values, mesh, axis=axis)


def load_plink_snp_sharded(bfile: str, mesh, block: int, mode="A", impute=True,
                           max_chunk_bytes=1 << 30, threads=0, multiple: int = 1):
    """SNP-sharded PLINK ingestion for a genotype larger than one device:
    this rank decodes only its own columns, :meth:`Mesh.snp_range` of the
    .bim's m SNPs in blocks of ``block`` (``multiple`` as ibrm's block
    padding: the merge rounds of the concurrent schedule), by
    ``read_plink(snps=...)``.  Returns ``(fileset, shard)``: the read_plink
    dict (fam and map whole, ``geno.values`` this rank's columns) and a
    :class:`~hibayes_tpu_torch.parallel.mesh.SnpShard` of those columns as
    an int8 tensor on the mesh's device, which ``ibrm(M=shard, mesh=mesh,
    block=block)`` takes."""
    from ..data.plink import read_bim, read_plink
    from .mesh import SnpShard

    m = len(read_bim(bfile + ".bim")["SNP"])
    start, cnt = mesh.snp_range(m, block, multiple)
    fileset = read_plink(bfile, impute=impute, mode=mode, max_chunk_bytes=max_chunk_bytes,
                         threads=threads, snps=(start, cnt))
    values = torch.as_tensor(np.ascontiguousarray(fileset["geno"].values), device=mesh.device)
    return fileset, SnpShard(values, start, m)
