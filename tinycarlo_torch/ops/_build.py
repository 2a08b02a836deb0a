"""Build and load the port's CUDA kernels.

Every `ops/csrc/*.cu` source is compiled by `nvcc` into its own shared
library with a plain C interface, at first use, into `tinycarlo_torch/_build/`
(listed in .gitignore). The libraries are loaded with ctypes. All sources
are compiled at once, one `nvcc` process each, started together. A
library is rebuilt only when its source, a shared header (`*.cuh`) or the
flags change: the file name carries a hash of all three.

Nothing here runs at import time: importing the module neither compiles
nor loads anything, so the CPU tests can import every module.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "ops", "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# sm_90a: Hopper with its architecture-specific features. -fmad=false
# keeps every multiply and add separately rounded, so the kernels'
# float arithmetic matches their plain PyTorch versions bit for bit.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the "
            "CUDA kernels are built from ops/csrc at first use"
        )
    return found


class KernelLibraries:
    """The compiled kernel libraries, built once per process.

    `build()` compiles every source that has no up-to-date library yet and
    records the wall time and each compiler's output (ptxas' register and
    shared-memory report) in `build_seconds` and `build_log`. `get(name)`
    returns the loaded ctypes library of `ops/csrc/<name>.cu`.
    """

    def __init__(self):
        self._libs: Dict[str, ctypes.CDLL] = {}
        self.build_seconds = None
        self.build_log: Dict[str, str] = {}

    def _target(self, src: str) -> str:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        # the source and every shared header it may include
        for path in [src] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
            with open(path, "rb") as f:
                h.update(f.read())
        digest = h.hexdigest()[:16]
        name = os.path.splitext(os.path.basename(src))[0]
        return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")

    def build(self) -> None:
        if self._libs:
            return
        start = time.perf_counter()
        os.makedirs(BUILD_DIR, exist_ok=True)
        sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
        jobs = []
        for src in sources:
            target = self._target(src)
            if os.path.exists(target):
                continue
            tmp = f"{target}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )
            jobs.append((src, target, tmp, proc))
        failures = []
        for src, target, tmp, proc in jobs:
            out, _ = proc.communicate()
            name = os.path.basename(src)
            self.build_log[name] = out
            if proc.returncode != 0:
                failures.append(f"{name} (exit {proc.returncode}):\n{out}")
            else:
                os.replace(tmp, target)
        if failures:
            raise RuntimeError("nvcc failed for " + "\n".join(failures))
        for src in sources:
            name = os.path.splitext(os.path.basename(src))[0]
            self._libs[name] = ctypes.CDLL(self._target(src))
        self.build_seconds = time.perf_counter() - start

    def get(self, name: str) -> ctypes.CDLL:
        self.build()
        return self._libs[name]


libraries = KernelLibraries()
