"""PLINK binary (.bed/.bim/.fam) ingestion.

A copy of hibayes_tpu/data/plink.py for the port (which imports nothing of
the JAX package; the native codec is the port's own copy,
``hibayes_tpu_torch/native``).  Replacement for the reference's
out-of-core loader (reference: R/read_plink.r:24-77,
src/read_bed.cpp:97-232):

* the 2-bit .bed payload is decoded with a 256x4 lookup table — a single
  vectorised gather per byte-block instead of the reference's per-byte OpenMP
  loop; the C++/OpenMP codec accelerates very large files and is used when
  it builds, with the same results;
* genotypes are stored as **int8** (0/1/2, -9 = missing before imputation):
  4x smaller than the reference's double copies crossing its FFI, and the
  form the port's sweep kernels read (int8 kept int8 on the card);
* persistence mirrors the reference's .bin/.desc memory-mapped pair with a
  NumPy memmap + JSON descriptor so re-loading is O(1) (`attach`).

Coding matches the reference exactly: A1A1 -> 2, A1A2 -> 1, A2A2 -> 0
(additive, A1 counted) or A1A1/A2A2 -> 0, A1A2 -> 1 (dominant)
(reference: src/read_bed.cpp:116-127); missing imputed by the per-SNP major
genotype (src/read_bed.cpp:182-230).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np

_MISS = np.int8(-9)

# PLINK 2-bit codes within a byte (little-endian pairs):
#   00 -> hom A1, 01 -> missing, 10 -> het, 11 -> hom A2
_CODE_A = np.array([2, -9, 1, 0], dtype=np.int8)   # additive: count A1
_CODE_D = np.array([0, -9, 1, 0], dtype=np.int8)   # dominant


def _byte_lut(mode: str) -> np.ndarray:
    """(256, 4) lookup: byte value -> 4 decoded genotypes."""
    code = _CODE_A if mode == "A" else _CODE_D
    b = np.arange(256, dtype=np.uint16)
    out = np.empty((256, 4), dtype=np.int8)
    for x in range(4):
        out[:, x] = code[(b >> (2 * x)) & 0x3]
    return out


_LUTS = {"A": _byte_lut("A"), "D": _byte_lut("D")}


def decode_bed_bytes(payload: np.ndarray, n: int, m: int, mode: str = "A",
                     threads: int = 0) -> np.ndarray:
    """Decode raw .bed payload (no magic) into an (n, m) int8 matrix.

    SNP-major layout: each SNP occupies ceil(n/4) bytes.  ``threads`` maps to
    the native codec's OpenMP thread count (0 = all cores), the analog of the
    reference's ``threads=`` argument (R/read_plink.r:24, src/omp_set.h:10-22);
    the NumPy fallback ignores it.
    """
    try:
        from ..native import bed_codec  # optional C++ fast path

        if bed_codec.available():
            return bed_codec.decode(payload, n, m, mode, threads=threads)
    except ImportError:
        pass
    bpsnp = (n + 3) // 4
    if payload.size != bpsnp * m:
        raise ValueError(f".bed payload has {payload.size} bytes, expected {bpsnp * m}")
    lut = _LUTS[mode]
    # (m, bpsnp) bytes -> (m, bpsnp*4) genotypes -> trim padding -> (n, m)
    geno = lut[payload.reshape(m, bpsnp)].reshape(m, bpsnp * 4)[:, :n]
    return np.ascontiguousarray(geno.T)


def bed_payload_memmap(bedpath: str, n: int, m: int) -> np.ndarray:
    """Memory-map the .bed payload as an (m, bytes-per-SNP) uint8 view.

    Verifies the SNP-major magic; no bytes are read until touched, so column
    chunks / row ranges pull only their own pages from disk — the analog of
    the reference's `maxLine` buffered streaming (src/read_bed.cpp:137-168)
    with the OS page cache as the buffer.
    """
    with open(bedpath, "rb") as f:
        if f.read(3) != b"\x6c\x1b\x01":
            raise ValueError(f"{bedpath} is not a SNP-major PLINK .bed file")
    bpsnp = (n + 3) // 4
    size = os.path.getsize(bedpath) - 3
    if size < bpsnp * m:
        raise ValueError(f"{bedpath}: payload {size} bytes < expected {bpsnp * m}")
    mm = np.memmap(bedpath, dtype=np.uint8, mode="r", offset=3, shape=(bpsnp * m,))
    return mm.reshape(m, bpsnp)


def decode_bed_region(
    payload2d: np.ndarray,
    n: int,
    mode: str = "A",
    rows: tuple | None = None,
    cols: tuple | None = None,
    threads: int = 0,
) -> np.ndarray:
    """Decode an arbitrary (row range) x (column chunk) region of a .bed
    payload into an int8 genotype block, touching only that region's bytes.

    payload2d: (m, bpsnp) uint8 view (see :func:`bed_payload_memmap`).
    rows: (row_start, row_count); cols: (col_start, col_count); None = all.
    The row-range capability is what multi-host loading shards on — each host
    decodes only its own individuals (the reference has no equivalent; its
    chunking is byte-buffered full-matrix, src/read_bed.cpp:137-168).
    """
    m = payload2d.shape[0]
    r0, rc = rows if rows is not None else (0, n)
    c0, cc = cols if cols is not None else (0, m)
    if r0 < 0 or rc < 0 or r0 + rc > n:
        raise ValueError(f"row range ({r0}, {rc}) out of bounds for n={n}")
    if c0 < 0 or cc < 0 or c0 + cc > m:
        raise ValueError(f"column range ({c0}, {cc}) out of bounds for m={m}")
    if r0 == 0 and rc == n:
        # full-rows column chunk: each SNP's bytes are a valid standalone
        # payload for (n, cc) -> the native OpenMP codec applies directly
        try:
            from ..native import bed_codec

            if bed_codec.available():
                chunk = np.ascontiguousarray(payload2d[c0 : c0 + cc]).reshape(-1)
                return bed_codec.decode(chunk, n, cc, mode, threads=threads)
        except ImportError:
            pass
    b0 = r0 // 4
    b1 = (r0 + rc + 3) // 4
    chunk = np.asarray(payload2d[c0 : c0 + cc, b0:b1])
    lut = _LUTS[mode]
    dec = lut[chunk].reshape(cc, (b1 - b0) * 4)
    off = r0 - 4 * b0
    return np.ascontiguousarray(dec[:, off : off + rc].T)


# per-byte genotype-value counts: _COUNT_LUTS[mode][byte] = (#0, #1, #2)
def _count_lut(mode: str) -> np.ndarray:
    lut = _LUTS[mode]
    out = np.zeros((256, 3), dtype=np.uint8)
    for v in range(3):
        out[:, v] = (lut == v).sum(axis=1)
    return out


_COUNT_LUTS = {"A": _count_lut("A"), "D": _count_lut("D")}


def bed_geno_counts(
    payload2d: np.ndarray, n: int, mode: str = "A", max_chunk_bytes: int = 1 << 28
) -> np.ndarray:
    """Exact per-SNP genotype counts (3, m) straight from the packed bytes.

    A 256->counts LUT makes this O(m * n/4) byte work with no decode, so a
    host that holds only a ROW SHARD can still impute by the GLOBAL major
    genotype — bit-identical to the reference's full-matrix count scan
    (src/read_bed.cpp:182-230).  Padding bits in each SNP's last byte are
    code 00 (= genotype value 2/0); their contribution is subtracted.
    """
    m, bpsnp = payload2d.shape
    counts = np.zeros((3, m), dtype=np.int64)
    clut = _COUNT_LUTS[mode].astype(np.int64)
    rows_per_chunk = max(1, max_chunk_bytes // max(bpsnp, 1))
    for c0 in range(0, m, rows_per_chunk):
        c1 = min(m, c0 + rows_per_chunk)
        chunk = np.asarray(payload2d[c0:c1])
        counts[:, c0:c1] = clut[chunk].sum(axis=1).T
    npad = 4 * bpsnp - n
    if npad:
        # padding entries decode from the low-order positions NOT used by the
        # tail: entries [n - 4*(bpsnp-1) :] of the final byte
        last = np.asarray(payload2d[:, -1])
        glut = _LUTS[mode]
        tail = glut[last][:, 4 - npad :]  # (m, npad) padded decode values
        for v in range(3):
            counts[v] -= (tail == v).sum(axis=1)
    return counts


def impute_major_with_counts(geno: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Impute missing (-9) entries using externally supplied global per-SNP
    genotype counts (from :func:`bed_geno_counts`) — the multi-host path where
    each process holds only a row shard but must impute by the global major
    genotype.  argmax tie-breaking matches the reference scan order 0,1,2."""
    miss = geno == _MISS
    if not miss.any():
        return geno
    major = counts.argmax(axis=0).astype(np.int8)
    return np.where(miss, major[np.newaxis, :], geno)


def encode_bed_bytes(geno: np.ndarray) -> bytes:
    """Inverse of :func:`decode_bed_bytes` (additive coding) — used to write
    test fixtures and to export data for PLINK interoperability."""
    n, m = geno.shape
    bpsnp = (n + 3) // 4
    # genotype value -> 2-bit code
    inv = {2: 0b00, -9: 0b01, 1: 0b10, 0: 0b11}
    codes = np.zeros((m, bpsnp * 4), dtype=np.uint8)
    gt = geno.T.astype(np.int64)
    for val, code in inv.items():
        codes[:, :n][gt == val] = code
    shifted = codes.reshape(m, bpsnp, 4) << np.array([0, 2, 4, 6], dtype=np.uint8)
    payload = shifted[..., 0] | shifted[..., 1] | shifted[..., 2] | shifted[..., 3]
    return b"\x6c\x1b\x01" + payload.astype(np.uint8).tobytes()


def impute_major(geno: np.ndarray, threads: int = 0) -> np.ndarray:
    """Impute missing (-9) entries with the per-SNP major genotype.

    Vectorised equivalent of the reference's per-SNP count loop
    (src/read_bed.cpp:182-230).  Ties resolve to the smaller genotype value
    only when its count is strictly greater, matching the reference's
    ``counts[j] > max`` scan order (0, then 1, then 2).  Uses the native
    OpenMP codec when built (``threads``: 0 = all cores).
    """
    miss = geno == _MISS
    cols = np.flatnonzero(miss.any(axis=0))
    if cols.size == 0:
        return geno
    try:
        from ..native import bed_codec

        if bed_codec.available() and geno.dtype == np.int8:
            return bed_codec.impute_major_inplace(
                np.ascontiguousarray(geno.copy()), threads=threads
            )
    except ImportError:
        pass
    geno = geno.copy()
    for c in cols:
        col = geno[:, c]
        counts = np.array(
            [(col == 0).sum(), (col == 1).sum(), (col == 2).sum()], dtype=np.int64
        )
        major = np.int8(int(np.argmax(counts)))
        col[col == _MISS] = major
    return geno


def read_bim(path: str):
    """Parse .bim -> dict of columns SNP/Chr/Pos/A1/A2 (reference: read_bed.cpp:29-95)."""
    snp, chrom, pos, a1, a2 = [], [], [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            chrom.append(parts[0])
            snp.append(parts[1])
            pos.append(int(parts[3]))
            a1.append(parts[4])
            a2.append(parts[5])
    return {
        "SNP": np.array(snp),
        "Chr": np.array(chrom),
        "Pos": np.array(pos, dtype=np.int64),
        "A1": np.array(a1),
        "A2": np.array(a2),
    }


def read_fam(path: str):
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if parts:
                rows.append(parts)
    cols = max(len(r) for r in rows)
    return [np.array([r[i] if i < len(r) else "" for r in rows]) for i in range(cols)]


@dataclass
class GenoMatrix:
    """An (n individuals x m SNPs) int8 genotype matrix, optionally
    file-backed (NumPy memmap), with lazily computed column statistics.

    The analog of the reference's bigmemory-backed matrix (R/read_plink.r:57-65)
    minus the FFI: the array goes to the card as it is (``torch.from_numpy``).
    """

    values: np.ndarray  # int8, shape (n, m)
    path: str | None = None
    _stats: dict = field(default_factory=dict, repr=False)

    @property
    def n(self) -> int:
        return self.values.shape[0]

    @property
    def m(self) -> int:
        return self.values.shape[1]

    def col_stats(self, threads: int = 0):
        """Per-SNP mean / sum / sqrt(SSD), as in BigStat (src/tXXmat.cpp:43-98).
        Uses the native OpenMP codec for int8 storage when built."""
        if not self._stats:
            if self.values.dtype == np.int8:
                try:
                    from ..native import bed_codec

                    if bed_codec.available():
                        self._stats = bed_codec.col_stats(
                            np.ascontiguousarray(self.values), threads=threads
                        )
                        return self._stats
                except ImportError:
                    pass
            g = self.values.astype(np.float64)
            mean = g.mean(axis=0)
            s = g.sum(axis=0)
            ssd = ((g - mean) ** 2).sum(axis=0)
            self._stats = {"mean": mean, "sum": s, "sqrt_ssd": np.sqrt(ssd)}
        return self._stats

    def save(self, prefix: str):
        """Persist as <prefix>.bin (+.desc JSON), mirroring the reference's
        memory-mapped persistence contract (R/read_plink.r:20)."""
        binpath = prefix + ".bin"
        mm = np.memmap(binpath, dtype=np.int8, mode="w+", shape=self.values.shape)
        mm[:] = self.values
        mm.flush()
        with open(prefix + ".desc", "w") as f:
            json.dump({"n": self.n, "m": self.m, "dtype": "int8"}, f)
        self.path = binpath
        return self

    @classmethod
    def attach(cls, prefix: str) -> "GenoMatrix":
        with open(prefix + ".desc") as f:
            desc = json.load(f)
        mm = np.memmap(prefix + ".bin", dtype=np.int8, mode="r", shape=(desc["n"], desc["m"]))
        return cls(values=mm, path=prefix + ".bin")


def read_plink(
    bfile: str,
    impute: bool = True,
    mode: str = "A",
    out: str | None = None,
    max_chunk_bytes: int = 1 << 30,
    threads: int = 0,
    rows: tuple | None = None,
    snps: tuple | None = None,
):
    """Load a PLINK binary fileset with bounded peak memory.

    Returns ``dict(fam=..., geno=GenoMatrix, map=...)`` matching the
    reference's surface (R/read_plink.r:24-77).  The .bed payload is
    memory-mapped and decoded in column chunks of at most ``max_chunk_bytes``
    decoded bytes — the analog of the reference's ``maxLine`` buffered loop
    (src/read_bed.cpp:137-168); with ``out`` given the chunks are written
    straight into the file-backed ``<out>.bin`` memmap, so peak RAM stays
    O(chunk) regardless of n*m.

    ``rows=(start, count)`` decodes only that row (individual) shard — the
    multi-host loading path where each process reads its own individuals
    (fam/map are still returned in full; missing genotypes are imputed by the
    GLOBAL major genotype computed from the packed bytes, identical to a
    full-matrix load).

    ``snps=(start, count)`` decodes only that SNP range: the payload is
    SNP-major, so the range is one contiguous byte range of the memory map,
    and each SNP is imputed by its own counts, as in a full load (fam/map
    are returned in full; ``out`` is refused, its files describing one
    matrix).  ``parallel.distributed.load_plink_snp_sharded`` reads a
    rank's SNP shard with it.
    """
    if mode not in ("A", "D"):
        raise ValueError("mode must be 'A' (additive) or 'D' (dominant)")
    bim = read_bim(bfile + ".bim")
    fam = read_fam(bfile + ".fam")
    n = len(fam[0])
    m = len(bim["SNP"])
    payload2d = bed_payload_memmap(bfile + ".bed", n, m)
    r0, rc = rows if rows is not None else (0, n)
    if r0 < 0 or rc < 0 or r0 + rc > n:
        raise ValueError(f"rows=({r0}, {rc}) out of bounds for n={n}")
    if snps is not None:
        s0, sc = snps
        if s0 < 0 or sc < 0 or s0 + sc > m:
            raise ValueError(f"snps=({s0}, {sc}) out of bounds for m={m}")
        if out is not None:
            raise ValueError("read_plink: 'out' writes a whole matrix; it does not "
                             "take 'snps'")
        payload2d, m = payload2d[s0:s0 + sc], sc
    binpath = None
    if out is not None:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        binpath = out + ".bin"
        geno = np.memmap(binpath, dtype=np.int8, mode="w+", shape=(rc, m))
    else:
        geno = np.empty((rc, m), dtype=np.int8)
    counts = bed_geno_counts(payload2d, n, mode, max_chunk_bytes) if impute else None
    chunk_cols = max(1, min(m, int(max_chunk_bytes // max(rc, 1))))
    for c0 in range(0, m, chunk_cols):
        cc = min(chunk_cols, m - c0)
        block = decode_bed_region(
            payload2d, n, mode, rows=(r0, rc), cols=(c0, cc), threads=threads
        )
        if impute:
            block = impute_major_with_counts(block, counts[:, c0 : c0 + cc])
        geno[:, c0 : c0 + cc] = block
    gm = GenoMatrix(values=geno, path=binpath)
    if out is not None:
        geno.flush()
        with open(out + ".desc", "w") as f:
            json.dump({"n": rc, "m": m, "dtype": "int8"}, f)
        with open(out + ".id", "w") as f:
            f.write("\n".join(fam[1]) + "\n")
        with open(out + ".map", "w") as f:
            f.write("SNP\tChr\tPos\n")
            for s, c, p in zip(bim["SNP"], bim["Chr"], bim["Pos"]):
                f.write(f"{s}\t{c}\t{p}\n")
    return {"fam": fam, "geno": gm, "map": bim}
