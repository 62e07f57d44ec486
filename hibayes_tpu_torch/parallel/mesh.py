"""Device mesh and sharding rules over torch.distributed.

Port of hibayes_tpu/parallel/mesh.py.  The JAX package lays a 2-D mesh of
devices over one program (GSPMD); here every rank is one process on one
device, all running the same fit (SPMD, as ``torchrun`` launches them), and
the mesh says which part of the data each rank holds:

* ``ind`` -- individuals (n).  A rank holds a contiguous run of rows of y,
  X, C, the factor codes, K, epsl_yJ and of the residuals yadj, u and
  k_estR.  Every sum over individuals is a sum over the axis
  (distributed.axis_sum), so the chain is the same Markov kernel.
* ``snp`` -- markers (m).  A rank holds a contiguous run of SNP blocks of X
  and W, or of tile rows of a tiled LD (their columns stay global); the
  sweep visits the shards in turn, in a ring of chain groups, or all at
  once in merge rounds (the schedules of engine/gibbs.py and
  engine/sgibbs.py).

Everything else is replicated.  A genotype too large for one device is
given to each rank as its own columns alone (:class:`SnpShard`, the range
of :func:`snp_column_range`), and ``prepare_gibbs_data`` lays out only
those.  Ranks are laid out row-major over
``shape`` (rank r at (r // S, r % S) on (ind, snp)), as the JAX package
reshapes its device list; each rank belongs to one group per axis: the
ranks that differ from it on that axis alone.
"""

from __future__ import annotations

import os
import warnings
from typing import NamedTuple

import numpy as np
import torch


class Mesh:
    """A 2-D mesh of the default process group's ranks.  ``shape`` maps
    each axis name to its size; :meth:`index` is this rank's coordinate on
    an axis, :meth:`group` the process group of its line along it (None
    where the axis has one rank) and :meth:`ranks` that line's global ranks
    in coordinate order.  ``device`` is this rank's device."""

    def __init__(self, shape: dict, rank: int, coords: dict, groups: dict,
                 lines: dict, device):
        self.shape = dict(shape)
        self.rank = rank
        self._coords = coords
        self._groups = groups
        self._lines = lines
        self.device = torch.device(device)

    def size(self, axis: str) -> int:
        return int(self.shape.get(axis, 1))

    def index(self, axis: str) -> int:
        return int(self._coords.get(axis, 0))

    def group(self, axis: str):
        return self._groups.get(axis)

    def ranks(self, axis: str) -> list:
        return list(self._lines.get(axis, [self.rank]))

    @property
    def world(self) -> int:
        return int(np.prod(list(self.shape.values())))

    def row_range(self, n: int, axis: str = "ind") -> tuple:
        """(start, count) of the rows of an n-long axis this rank holds:
        chunks of ceil(n / size), the last one shorter (the JAX package's
        split of a sharded axis)."""
        return _chunk(n, self.size(axis), self.index(axis))

    def snp_range(self, m: int, block: int, multiple: int = 1) -> tuple:
        """(start, count) of the SNP columns this rank holds over ``snp``:
        :func:`snp_column_range` of this rank's coordinate."""
        return snp_column_range(m, block, self.size("snp"), self.index("snp"), multiple)

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, rank={self.rank}, coords={self._coords}, "
                f"device={self.device})")


def _chunk(n: int, parts: int, i: int) -> tuple:
    per = -(-n // max(parts, 1))
    lo = min(n, i * per)
    return lo, min(n, lo + per) - lo


def snp_blocks(m: int, block: int, shards: int, multiple: int = 1) -> tuple:
    """(block, blocks): the block size ``prepare_gibbs_data`` takes for m
    SNPs (``block`` at most m rounded up to 8) and the block count, ceil(m /
    block) padded with all-zero blocks to a multiple of ``shards`` and of
    ``multiple`` (its ``nblocks_multiple``)."""
    block = int(min(block, -(-m // 8) * 8))
    step = int(np.lcm(max(int(shards), 1), max(int(multiple), 1)))
    nb = -(-m // block)
    return block, -(-nb // step) * step


def snp_column_range(m: int, block: int, shards: int, index: int,
                     multiple: int = 1) -> tuple:
    """(start, count) of the columns of an m-SNP genotype that SNP shard
    ``index`` of ``shards`` holds: whole blocks, shard s holding blocks
    [s nb / S, (s + 1) nb / S) of the nb of :func:`snp_blocks`, less the
    padding past m (the last shards may hold fewer columns, or none)."""
    block, nb = snp_blocks(m, block, shards, multiple)
    per = nb // max(int(shards), 1) * block
    lo = min(m, int(index) * per)
    return lo, min(m, lo + per) - lo


class SnpShard(NamedTuple):
    """Columns [start, start + values.shape[1]) of an (n, m) genotype: a
    rank's part over ``snp`` (:meth:`Mesh.snp_range`), what
    ``prepare_gibbs_data(mesh=...)`` and ``ibrm(M=..., mesh=...)`` take in
    place of the whole.  ``values``: a numpy array or a tensor."""

    values: object
    start: int
    m: int


def default_device(rank: int = 0):
    """This rank's device: ``cuda:LOCAL_RANK`` (or the rank, modulo the
    cards) when a card is there, else the CPU."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(n_devices=None, shape=None, axis_names=("ind", "snp"), device=None) -> Mesh:
    """A mesh over the ranks of the default process group (one rank, no
    group needed, when torch.distributed is not initialised).

    shape: a tuple like (4, 2) mapping the ranks to (ind, snp); the default
    puts every rank on the ``ind`` axis (the exact data-parallel strategy).
    ``n_devices``, where given, must be the world size.  Every rank must
    call it with the same arguments (each axis group is made by all ranks,
    in the same order).  ``device`` defaults to :func:`default_device`."""
    import torch.distributed as dist

    init = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if init else 1
    rank = dist.get_rank() if init else 0
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(f"make_mesh: {n_devices} devices asked for, the process group "
                         f"has {world} ranks (launch one rank per device, e.g. torchrun "
                         f"--nproc-per-node {n_devices})")
    if shape is None:
        shape = (world, 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not match axes {axis_names}")
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {shape} != device count {world}")
    grid = np.arange(world).reshape(shape)
    where = np.argwhere(grid == rank)[0]
    coords = {a: int(c) for a, c in zip(axis_names, where)}
    groups, lines = {}, {}
    for k, a in enumerate(axis_names):
        moved = np.moveaxis(grid, k, -1).reshape(-1, shape[k])
        for line in moved:
            members = [int(r) for r in line]
            grp = dist.new_group(members) if init and shape[k] > 1 else None
            if rank in members:
                groups[a], lines[a] = grp, members
    return Mesh(dict(zip(axis_names, shape)), rank, coords, groups, lines,
                default_device(rank) if device is None else device)


# ---------------------------------------------------------------------------
# this rank's part of data that every rank prepared alike
# ---------------------------------------------------------------------------


def _rows(t, lo, cnt, dim=0):
    return t.narrow(dim, lo, cnt).contiguous() if t.numel() else t


def shard_gibbs_data(data, mesh: Mesh, spec=None):
    """This rank's part of a GibbsData (engine/gibbs.py): rows of y, X, C,
    the factor codes, K and epsl_yJ over ``ind``, and the segments of the
    sums by level over the rows kept (``engine.gibbs.segments``); the SNP
    blocks of X, W and the cross-Grams C over ``snp`` where the axis divides
    the blocks, C's first entry zero as a shard's own set-up makes it (else
    they stay whole and the sweep runs replicated on the axis); the rest
    replicated.
    ``prepare_gibbs_data`` is run alike on every rank and this cuts it, as
    the JAX package's device_put places it.  A part already cut keeps its
    rows with the chain's ``spec``, and its blocks where X_blocks holds
    fewer than xpx covers (``prepare_gibbs_data`` of a :class:`SnpShard`)."""
    if mesh is None:
        return data
    n = int(data.y.shape[0]) if spec is None else spec.n
    nbk, n_here, W = data.X_blocks.shape
    nb = int(data.xpx.shape[0]) // data.block
    sub = -(-data.block // W)
    rows = n_here == n
    r0, nr = mesh.row_range(n) if rows else (0, n_here)
    S = mesh.size("snp")
    b0, nbl = 0, nbk // sub
    if S > 1 and nb % S == 0 and nbk == nb * sub:
        nbl = nb // S
        b0 = mesh.index("snp") * nbl
    X = data.X_blocks[b0 * sub:(b0 + nbl) * sub, r0:r0 + nr].contiguous()
    Wb = data.W_blocks[b0 * sub:(b0 + nbl) * sub].contiguous()
    Cb = data.C_blocks[b0 * sub:(b0 + nbl) * sub]
    if b0 > 0:   # a shard's first block follows none of its own
        Cb = Cb.clone()
        Cb[0] = 0.0
    cut = (lambda t: _rows(t, r0, nr)) if rows else (lambda t: t)
    part = {}
    if rows and nr != n:
        # the sums by level over this rank's rows (padded rows in level 0)
        from ..engine.gibbs import epsl_part, segments

        dev = data.y.device
        part["r_segs"] = tuple(segments(cut(c), int(k.shape[0]), dev)
                               for c, k in zip(data.r_codes, data.r_counts))
        t0, c0 = epsl_part(n, int(data.epsl_codes.shape[0]), r0, nr)
        part["epsl_segs"] = segments(data.epsl_codes[c0:c0 + nr - t0],
                                     int(data.epsl_counts.shape[0]), dev)
    return data._replace(
        y=cut(data.y), X_blocks=X, W_blocks=Wb, C_blocks=Cb, C=cut(data.C),
        r_codes=tuple(cut(c) for c in data.r_codes),
        K=cut(data.K), epsl_yJ=cut(data.epsl_yJ), **part)


def shard_sgibbs_data(data, mesh: Mesh):
    """This rank's part of an SGibbsData (engine/sgibbs.py): the tile rows
    of a tiled LD over ``snp`` (their columns stay global); per-SNP vectors
    and r_hat stay replicated.  Warns, and keeps everything replicated (the
    sweep then runs one-device semantics on every rank), where the LD is not
    tiled or the axis does not divide its tile rows, as the JAX package
    does.  A part already cut (fewer tile rows than ``xy`` covers) is
    returned as it is."""
    S = mesh.size("snp") if mesh is not None else 1
    if S <= 1:
        return data
    if data.ld_tiles is None:
        warnings.warn(
            "mesh with an snp axis was requested but the LD is not tiled-"
            "sparse; the summary sweep will run single-device semantics "
            "(build the LD with ldmat(..., chisq=...) / TiledSparseLD to "
            "shard it).")
        return data
    nbr = int(data.ld_tiles.shape[0])
    if nbr * int(data.ld_tiles.shape[2]) < int(data.xy.shape[0]):
        return data
    if nbr % S:
        warnings.warn(
            f"snp mesh axis ({S}) does not divide the {nbr} LD tile "
            "rows; the summary sweep will run single-device semantics.")
        return data
    nl = nbr // S
    r0 = mesh.index("snp") * nl
    return data._replace(
        ld_tiles=data.ld_tiles[r0:r0 + nl].contiguous(),
        ld_cols=data.ld_cols[r0:r0 + nl].contiguous(),
        ld_valid=data.ld_valid[r0:r0 + nl].contiguous())


IND_FIELDS = ("yadj", "u", "k_estR")   # the chain state's fields over individuals


def shard_state(state, mesh: Mesh, n: int | None = None):
    """This rank's part of a chain state (one chain or a batch): the rows
    of yadj, u and k_estR over ``ind``; the rest replicated.  ``n`` is the
    full row count (default: yadj's), for a state already cut."""
    if mesh is None or mesh.size("ind") <= 1:
        return state
    if "yadj" not in state._fields:
        return state
    n = int(state.yadj.shape[-1]) if n is None else n
    if int(state.yadj.shape[-1]) != n:
        return state
    r0, nr = mesh.row_range(n)
    cut = lambda t: t.narrow(-1, r0, nr).contiguous() if t.numel() else t
    return state._replace(**{f: cut(getattr(state, f)) for f in IND_FIELDS
                             if f in state._fields})


def gather_state(state, mesh: Mesh, n: int):
    """The whole chain state (n rows) from every rank's part
    (:func:`shard_state`'s inverse): every rank of the ``ind`` axis takes
    part and gets it."""
    if mesh is None or mesh.size("ind") <= 1:
        return state
    from .distributed import all_gather

    full = lambda t: all_gather(t, mesh, "ind", dim=-1, total=n) if t.numel() else t
    return state._replace(**{f: full(getattr(state, f)) for f in IND_FIELDS
                             if f in state._fields})
