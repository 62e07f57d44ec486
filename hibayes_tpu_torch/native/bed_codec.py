"""ctypes bindings for the native PLINK bed codec, built at first use.

A copy of hibayes_tpu/native/bed_codec.py for the port, which imports
nothing of the JAX package.  The shared library is compiled from
``native/src/bed_codec.cpp`` with ``g++ -O3 -march=native -fopenmp`` (the
JAX package's flags, so that both codecs compute alike) into the package's
``build/`` directory; its name carries a hash of the source, the flags and
the host's processor, so a copy of the tree on another machine builds its
own.  Without a toolchain :func:`available` is False and the callers
(data/plink.py) take the NumPy path, which gives the same results.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "src" / "bed_codec.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None
_build_failed = False


def _host() -> str:
    """The processor the library is built for: its model and flags."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name", "flags"))][:2]
    except OSError:
        lines = []
    return platform.machine() + "".join(lines)


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(FLAGS).encode())
    h.update(_host().encode())
    return BUILD_DIR / f"libbed_codec_{h.hexdigest()[:12]}.so"


def _build(path: Path) -> bool:
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(["g++", *FLAGS, str(SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def _load():
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        path = library_path()
        if not path.exists() and not _build(path):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            _build_failed = True
            return None
        P, I64, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.bed_decode.argtypes = [P, I64, I64, P, I, I]
        lib.bed_encode.argtypes = [P, I64, I64, P, I]
        lib.impute_major.argtypes = [P, I64, I64, I]
        lib.col_stats.argtypes = [P, I64, I64, P, P, P, I]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def decode(payload: np.ndarray, n: int, m: int, mode: str = "A",
           threads: int = 0) -> np.ndarray:
    lib = _load()
    payload = np.ascontiguousarray(payload, dtype=np.uint8)
    out = np.empty((n, m), dtype=np.int8)
    lib.bed_decode(payload.ctypes.data, n, m, out.ctypes.data,
                   1 if mode == "D" else 0, threads)
    return out


def encode(geno: np.ndarray, threads: int = 0) -> np.ndarray:
    lib = _load()
    geno = np.ascontiguousarray(geno, dtype=np.int8)
    n, m = geno.shape
    out = np.empty(m * ((n + 3) // 4), dtype=np.uint8)
    lib.bed_encode(geno.ctypes.data, n, m, out.ctypes.data, threads)
    return out


def impute_major_inplace(geno: np.ndarray, threads: int = 0) -> np.ndarray:
    lib = _load()
    assert geno.dtype == np.int8 and geno.flags.c_contiguous
    n, m = geno.shape
    lib.impute_major(geno.ctypes.data, n, m, threads)
    return geno


def col_stats(geno: np.ndarray, threads: int = 0):
    lib = _load()
    geno = np.ascontiguousarray(geno, dtype=np.int8)
    n, m = geno.shape
    mean, s, sqrt_ssd = np.empty(m), np.empty(m), np.empty(m)
    lib.col_stats(geno.ctypes.data, n, m, mean.ctypes.data, s.ctypes.data,
                  sqrt_ssd.ctypes.data, threads)
    return {"mean": mean, "sum": s, "sqrt_ssd": sqrt_ssd}
