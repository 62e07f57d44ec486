"""Build and load the CUDA kernels of ``csrc/``.

``nvcc`` compiles each source into a shared library of its own with a plain C
interface (``-gencode arch=compute_90a,code=sm_90a``), loaded with
``ctypes``; the compilers of all sources run at once.  The build runs at
first use, into ``build/`` inside the package directory; a library's name
carries a hash of the sources, so an edited source is rebuilt.  A missing
compiler or a failed build raises: nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from ..utils.profiling import span

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
SOURCES = ("blockgibbs.cu", "sgibbs.cu", "mme.cu")
HEADERS = ("draws.cuh", "pdl.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(set CUDA_HOME or put nvcc on PATH)")
    return found


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS + NVCC_FLAGS:
        h.update(name.encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:12]


def library_path(source: str = SOURCES[0]) -> Path:
    return BUILD_DIR / f"libhibayes_{Path(source).stem}_{_digest()}.so"


def build(verbose: bool = False) -> list:
    """Compile every source whose library for these sources is missing, one
    nvcc per source, all started together (span ``ops.build``).  Returns
    the library paths."""
    todo = [s for s in SOURCES if not library_path(s).exists()]
    if todo:
        with span("ops.build"):
            nvcc = _nvcc()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            jobs = []
            for src in todo:
                tmp = library_path(src).with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
                jobs.append((src, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
            failed = []
            for src, tmp, proc in jobs:
                _, err = proc.communicate()
                if proc.returncode != 0:
                    failed.append(f"{src} ({proc.returncode}):\n{err}")
                    continue
                if verbose:
                    print(f"{src}:\n{err.strip()}")
                os.replace(tmp, library_path(src))
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return [library_path(s) for s in SOURCES]


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.cache
def library(source: str = SOURCES[0]) -> ctypes.CDLL:
    """The loaded library of one source (all built on first use), argtypes
    declared."""
    build()
    lib = ctypes.CDLL(str(library_path(source)))
    lib.hb_error_string.argtypes = [_I]
    lib.hb_error_string.restype = ctypes.c_char_p
    if source == "blockgibbs.cu":
        lib.hb_block_draws.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P]
        lib.hb_block_draws.restype = _I
        lib.hb_sweep_mc.argtypes = ([_P, _I, _P, _P] + [_I] * 13 + [_P] * 8
                                    + [ctypes.c_uint] + [_I] * 5 + [_P] * 4)
        lib.hb_sweep_mc.restype = _I
    elif source == "sgibbs.cu":
        lib.hb_sweep_s_segment.argtypes = [_P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
                                           _F, _P, _P, _P, _P, _P, _P, ctypes.c_uint,
                                           _I, _I, _I, _I, _I, _I, _I, _P, _P, _P]
        lib.hb_sweep_s_segment.restype = _I
        lib.hb_sweep_s_tiled.argtypes = [_P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F,
                                         _P, _P, _P, _P, _P, _P, _P, _P, _I, _P,
                                         _P, _P, ctypes.c_uint, _P, _P, _P]
        lib.hb_sweep_s_tiled.restype = _I
        lib.hb_chain_latency.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _F, _I,
                                         _P, _P, _P]
        lib.hb_chain_latency.restype = _I
        lib.hb_tiled_resident.argtypes = [_I, _I, _I, _I, _I,
                                          ctypes.POINTER(ctypes.c_longlong)]
        lib.hb_tiled_resident.restype = _I
    else:
        _L = ctypes.c_longlong
        lib.hb_mme_sweep.argtypes = [_P] * 11 + [_L, _L, _L, _I, _I, _I, _I, _P, _P]
        lib.hb_mme_sweep.restype = _I
        lib.hb_mme_smem_bytes.argtypes = [_I, _I]
        lib.hb_mme_smem_bytes.restype = _L
        lib.hb_mme_chain_latency.argtypes = [_P] * 6 + [_I, _I, _P, _P, _P]
        lib.hb_mme_chain_latency.restype = _I
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} failed: CUDA error {code} "
                           f"({lib.hb_error_string(code).decode()})")
