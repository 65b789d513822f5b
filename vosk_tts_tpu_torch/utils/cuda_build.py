"""Build the port's CUDA sources with nvcc and bind them with ctypes.

Each ``csrc/*.cu`` file has a plain C interface. At first use it is
compiled for Hopper (``sm_90a``) into a shared library under
``csrc/_build/`` (named by a hash of the source, the shared headers
``csrc/*.cuh`` and the flags, so an edited source or header rebuilds) and
loaded with ``ctypes``. Nothing here runs when a module is imported, and
nothing is built for CPU tensors: a kernel's wrapper asks for its library
only when it launches on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels of vosk_tts_tpu_torch "
                           "are built from csrc/ at first use and need the CUDA toolkit")
    return nvcc


class CudaKernel:
    """One CUDA source, its built library, its C entry point and the count
    of launches its wrapper made. Several wrappers may share one source,
    each with a ``CudaKernel`` of its own (and so a count of its own)."""

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    @property
    def library(self) -> Path:
        h = hashlib.sha1(self.source.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):
            h.update(header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.source.stem}-{h.hexdigest()[:12]}.so"

    def fn(self):
        """The bound C entry point, building the library first if needed."""
        if self._fn is None:
            if not self.library.exists():
                build([self])
            lib = ctypes.CDLL(str(self.library))
            f = getattr(lib, self.symbol)
            f.argtypes = self.argtypes
            f.restype = ctypes.c_int
            self._fn = f
        return self._fn

    def check(self, err: int) -> None:
        if err != 0:
            raise RuntimeError(f"{self.symbol} failed to launch: CUDA error {err}")


def build(kernels) -> None:
    """Compile every kernel whose library is missing, one nvcc process per
    source, all started together. The compiler's messages (with ``-Xptxas
    -v``: registers, shared memory, spills) are kept beside each library
    as ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs, started = [], set()
    for k in kernels:
        lib = k.library
        if lib.exists() or lib in started:
            continue
        started.add(lib)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen([find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(k.source)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((k, proc, tmp))
    failed = []
    for k, proc, tmp in jobs:
        out, _ = proc.communicate()
        k.library.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{k.source.name}:\n{out}")
            continue
        os.replace(tmp, k.library)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
