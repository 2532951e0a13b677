# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Build and load the package's hand-written native code.

Each ``csrc/*.cu`` file has a plain C interface. At first use it is compiled
with ``nvcc`` for ``sm_90a`` into ``ava256_tpu_torch/_build/`` (named by the
hash of the source, the flags and the shared ``csrc/*.cuh`` headers, so an
edited source rebuilds) and loaded with ``ctypes`` (``CudaLib``). The host
data library ``csrc/dataio.cpp`` is built the same way with the host C++
compiler (``HostLib``). A failed build raises with the compiler's output.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Iterable, List, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no FMA contraction: the plain PyTorch versions round every product and
    # sum separately, and the kernels are held to them at 1e-5
    "--fmad=false", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
]
HOST_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the "
                       "CUDA toolkit (set NVCC or put nvcc on PATH)")


def _cxx() -> str:
    for cand in (os.environ.get("CXX"), shutil.which("g++"), shutil.which("c++")):
        if cand and shutil.which(cand):
            return cand
    raise RuntimeError("no host C++ compiler found for csrc/dataio.cpp (set CXX or put g++ "
                       "on PATH)")


class _Lib:
    """One source under ``csrc/``: its build, its loaded library and the
    build log."""

    flags: List[str] = []

    def __init__(self, source: str):
        self.source = CSRC / source
        self._lib: Optional[ctypes.CDLL] = None
        self.build_log = ""
        self.build_seconds = 0.0

    def _compiler(self) -> str:
        raise NotImplementedError

    def _key(self) -> bytes:
        """What the build depends on besides the source and the flags."""
        return b""

    @property
    def path(self) -> Path:
        digest = hashlib.sha1(self.source.read_bytes() + " ".join(self.flags).encode())
        digest.update(self._key())
        return BUILD_DIR / f"lib{self.source.stem}_{digest.hexdigest()[:12]}.so"

    def _tmp(self) -> Path:
        return self.path.with_suffix(f".{os.getpid()}.tmp")

    def _start(self) -> Optional[subprocess.Popen]:
        if self.path.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        return subprocess.Popen(
            [self._compiler(), *self.flags, "-o", str(self._tmp()), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def _finish(self, proc: Optional[subprocess.Popen], t0: float) -> None:
        if proc is None:
            return
        self.build_log = proc.communicate()[0]
        self.build_seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            self._tmp().unlink(missing_ok=True)
            raise RuntimeError(f"{proc.args[0]} failed for {self.source.name}:\n{self.build_log}")
        os.replace(self._tmp(), self.path)

    def build(self) -> None:
        build_all([self])

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            self.build()
            self._lib = self._bind(ctypes.CDLL(str(self.path)))
        return self._lib

    def _bind(self, lib: ctypes.CDLL) -> ctypes.CDLL:
        """Declare the entry points' argument and result types."""
        return lib


class CudaLib(_Lib):
    """A CUDA source, built with ``nvcc`` for ``sm_90a``."""

    flags = NVCC_FLAGS

    def _compiler(self) -> str:
        return _nvcc()

    def _key(self) -> bytes:
        return b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))  # shared device code

    def _bind(self, lib: ctypes.CDLL) -> ctypes.CDLL:
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        return lib

    def check(self, err: int, what: str) -> None:
        """Raise on a non-zero cudaError_t returned by a C entry point."""
        if err != 0:
            msg = self.lib().cuda_error_string(err).decode()
            raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


class HostLib(_Lib):
    """A C++ source for the host, built with the host compiler and the
    flags of ``ava256_tpu/native/build.py`` (so both builds of the same
    arithmetic round alike). ``bind(lib)`` declares its entry points."""

    flags = HOST_FLAGS

    def __init__(self, source: str, bind: Callable[[ctypes.CDLL], None]):
        super().__init__(source)
        self._declare = bind
        self._lock = threading.Lock()

    def _compiler(self) -> str:
        return _cxx()

    def _key(self) -> bytes:
        # -march=native builds for this host's processor: a tree copied to
        # another machine builds its own library
        try:
            with open("/proc/cpuinfo", "rb") as f:
                cpu = b"".join(sorted({ln for ln in f if ln.startswith((b"model name", b"flags"))}))
        except OSError:
            cpu = b""
        return platform.machine().encode() + platform.processor().encode() + cpu

    def lib(self) -> ctypes.CDLL:
        with self._lock:  # loader threads may ask at once
            return super().lib()

    def _bind(self, lib: ctypes.CDLL) -> ctypes.CDLL:
        self._declare(lib)
        return lib


def build_all(libs: Iterable[_Lib]) -> None:
    """Compile every library that is not built yet, one compiler process per
    source, all started together."""
    libs: List[_Lib] = list(libs)
    t0 = time.perf_counter()
    procs = [(lib, lib._start()) for lib in libs]
    for lib, proc in procs:
        lib._finish(proc, t0)

