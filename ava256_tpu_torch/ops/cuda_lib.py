# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Build and load the package's hand-written CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface. At first use it is compiled
with ``nvcc`` for ``sm_90a`` into ``ava256_tpu_torch/_build/`` (named by the
hash of the source and the shared ``csrc/*.cuh`` headers, so an edited source
rebuilds) and loaded with ``ctypes``.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Iterable, List, Optional

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


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the "
                       "CUDA toolkit (set NVCC or put nvcc on PATH)")


class CudaLib:
    """One kernel source: its build, its loaded library and the build log."""

    def __init__(self, source: str):
        self.source = CSRC / source
        self._lib: Optional[ctypes.CDLL] = None
        self.build_log = ""
        self.build_seconds = 0.0

    @property
    def path(self) -> Path:
        digest = hashlib.sha1(self.source.read_bytes() + " ".join(NVCC_FLAGS).encode())
        for header in sorted(CSRC.glob("*.cuh")):  # shared device code
            digest.update(header.read_bytes())
        return BUILD_DIR / f"lib{self.source.stem}_{digest.hexdigest()[:12]}.so"

    def _tmp(self) -> Path:
        return self.path.with_suffix(f".{os.getpid()}.tmp")

    def _start(self) -> Optional[subprocess.Popen]:
        if self.path.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        return subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(self._tmp()), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def _finish(self, proc: Optional[subprocess.Popen], t0: float) -> None:
        if proc is None:
            return
        self.build_log = proc.communicate()[0]
        self.build_seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            self._tmp().unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {self.source.name}:\n{self.build_log}")
        os.replace(self._tmp(), self.path)

    def build(self) -> None:
        build_all([self])

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            self.build()
            lib = ctypes.CDLL(str(self.path))
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def check(self, err: int, what: str) -> None:
        """Raise on a non-zero cudaError_t returned by a C entry point."""
        if err != 0:
            msg = self.lib().cuda_error_string(err).decode()
            raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


def build_all(libs: Iterable[CudaLib]) -> None:
    """Compile every library that is not built yet, one nvcc per source, all
    started together."""
    libs: List[CudaLib] = list(libs)
    t0 = time.perf_counter()
    procs = [(lib, lib._start()) for lib in libs]
    for lib, proc in procs:
        lib._finish(proc, t0)

