"""Build and load the CUDA kernels of ``csrc/``.

``nvcc`` compiles the sources into a shared library with a plain C interface
(``-gencode arch=compute_90a,code=sm_90a``), loaded with ``ctypes``.  The
build runs at first use, into ``build/`` inside the package directory; the
library's name carries a hash of the sources, so an edited source is rebuilt.
A missing compiler or a failed build raises: nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
SOURCES = ("blockgibbs.cu",)
HEADERS = ("draws.cuh",)
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


def library_path() -> Path:
    return BUILD_DIR / f"libhibayes_kernels_{_digest()}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless the library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(CSRC / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if verbose:
        print(proc.stderr.strip())
    os.replace(tmp, out)
    return out


_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), argtypes declared."""
    lib = ctypes.CDLL(str(build()))
    lib.hb_error_string.argtypes = [_I]
    lib.hb_error_string.restype = ctypes.c_char_p
    lib.hb_block_draws.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P]
    lib.hb_block_draws.restype = _I
    lib.hb_sweep_mc.argtypes = [_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                _I, _I, _P, _P, _P, _P, _P, _P, _P]
    lib.hb_sweep_mc.restype = _I
    lib.hb_launch_counts.argtypes = [ctypes.POINTER(ctypes.c_longlong)] * 2
    lib.hb_launch_counts.restype = None
    lib.hb_reset_launch_counts.argtypes = []
    lib.hb_reset_launch_counts.restype = None
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} failed: CUDA error {code} "
                           f"({lib.hb_error_string(code).decode()})")
