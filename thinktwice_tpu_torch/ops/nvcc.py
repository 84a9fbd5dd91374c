"""Build and load the port's CUDA kernels: nvcc for sm_90a into `_build/`
beside this package, each a shared library with a plain C interface bound
with ctypes.

A source compiles at first use into a shared library named by the hash of
the source and the flags, so an edit rebuilds and an unchanged source is
built once. `build_all` starts one nvcc per source at the same time and
waits for all of them. Every source is built with `--fmad=false`, so a
kernel does the same IEEE operations as its plain PyTorch version. A kernel's
constants that its Python side shares (a tile shape, a cull's slack) are
defined in Python and passed to nvcc as -D macros, so one module owns them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v",
]

vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the element types a kernel templated on its data type takes, by the code
# its C functions read
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


class CudaKernel:
    """One CUDA source, its built library and the count of its launches.

    functions maps each exported C function to (argtypes, restype). Every
    source also exports `tt_error_string(int)`. defines maps macro names to
    Python ints or floats, passed as -D flags (a float as a C float literal)."""

    def __init__(self, name: str, source: str, functions: dict, defines: dict | None = None):
        self.name = name
        self.source = os.path.join(CSRC, source)
        self.functions = dict(functions)
        self.flags = NVCC_FLAGS + [
            f"-D{k}={v!r}f" if isinstance(v, float) else f"-D{k}={int(v)}"
            for k, v in (defines or {}).items()
        ]
        self.functions["tt_error_string"] = ([ci], ctypes.c_char_p)
        self.launches = 0
        self.build_log = ""
        self.build_seconds = None
        self._lib = None
        self._lock = threading.Lock()

    def path(self) -> str:
        with open(self.source, "rb") as f:
            data = f.read()
        digest = hashlib.sha256(data + " ".join(self.flags).encode()).hexdigest()[:16]
        return os.path.join(BUILD_DIR, f"{self.name}-{digest}.so")

    def _start(self):
        """Start nvcc unless the library exists. -> (process, temp path) or None."""
        if os.path.exists(self.path()):
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            [_nvcc(), *self.flags, "-o", tmp, self.source],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        return proc, tmp

    def _finish(self, started, t0: float) -> None:
        if started is not None:
            proc, tmp = started
            try:
                out, _ = proc.communicate()
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {self.source}:\n{out}")
                os.replace(tmp, self.path())
                self.build_log = out
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        self.build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(self.path())
        for fn, (argtypes, restype) in self.functions.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        self._lib = lib

    def library(self):
        with self._lock:
            if self._lib is None:
                t0 = time.perf_counter()
                self._finish(self._start(), t0)
            return self._lib

    def check(self, rc: int) -> None:
        """Raise if a launch returned a CUDA error code."""
        if rc != 0:
            msg = self._lib.tt_error_string(rc).decode()
            raise RuntimeError(f"{self.name} launch failed: {msg}")


def build_all(kernels) -> float:
    """Build every kernel not yet loaded, one nvcc each, all at once.
    -> wall seconds of the whole build."""
    t0 = time.perf_counter()
    todo = [k for k in kernels if k._lib is None]
    for k in todo:
        k._lock.acquire()
    try:
        started = [(k, k._start()) for k in todo]
        for k, s in started:
            k._finish(s, t0)
    finally:
        for k in todo:
            k._lock.release()
    return time.perf_counter() - t0


def check_tensor(t, name: str, dtype, shape) -> None:
    """Raise unless t lies on the card with this dtype, shape and a
    contiguous layout."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must lie on the CUDA device, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
