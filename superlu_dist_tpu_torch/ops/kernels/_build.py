"""Build and load the hand-written CUDA kernels.

Each source under ``csrc/`` has a plain C interface. It is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``build/torch_kernels/`` at the
root of the checkout (git-ignored) on first use, and loaded with
``ctypes``. Nothing is built when a module is imported: a build starts
only when a kernel is first launched, or when :func:`build_all` is
called.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), *[os.pardir] * 3,
    "build", "torch_kernels"))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if cand and os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit on the machine with the card")
    return found


class CudaKernel:
    """One ``csrc`` source file, its shared library and its launch count.

    ``entries`` maps each exported C function to its ``argtypes``; every
    entry returns the ``cudaError_t`` of its launch as an int.
    ``launches`` is incremented by the Python wrapper each time it
    launches the kernel (and nowhere else)."""

    def __init__(self, name: str, source: str, entries: dict):
        self.name = name
        self.source = source
        self.entries = entries
        self.launches = 0
        self._lib = None

    @property
    def source_path(self) -> str:
        return os.path.join(_CSRC, self.source)

    def so_path(self) -> str:
        h = hashlib.sha256()
        with open(self.source_path, "rb") as f:
            h.update(f.read())
        h.update(" ".join(NVCC_FLAGS).encode())
        stem = os.path.splitext(self.source)[0]
        return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")

    def start_build(self):
        """Start ``nvcc`` for this source unless its library exists;
        returns the process or None."""
        so = self.so_path()
        if os.path.exists(so):
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.tmp{os.getpid()}"
        log = open(so + ".log", "w")
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp,
                                 self.source_path],
                                stdout=log, stderr=subprocess.STDOUT)
        log.close()
        return proc, tmp, so

    def lib(self):
        if self._lib is None:
            build_all([self])
            lib = ctypes.CDLL(self.so_path())
            for fn, argtypes in self.entries.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def call(self, fn: str, *args) -> None:
        """Launch through entry ``fn`` and raise if the launch failed."""
        err = getattr(self.lib(), fn)(*args)
        if err != 0:
            raise RuntimeError(f"{self.name}: CUDA launch of {fn} failed "
                               f"with cudaError {err}")


def build_all(kernels) -> float:
    """Compile every missing library of ``kernels`` in parallel (one
    ``nvcc`` per source, all started together); returns the seconds."""
    t0 = time.perf_counter()
    by_source = {k.source: k for k in kernels}   # one nvcc per source
    started = [(k, s) for k in by_source.values()
               for s in [k.start_build()] if s]
    failed = []
    for k, (proc, tmp, so) in started:
        if proc.wait() != 0:
            with open(so + ".log") as f:
                failed.append(f"{k.source}:\n{f.read()[-4000:]}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def ptxas_report(kernel: CudaKernel) -> str:
    """The ``-Xptxas -v`` lines (registers, shared memory, spills) of the
    last build of ``kernel``."""
    log = kernel.so_path() + ".log"
    if not os.path.exists(log):
        return ""
    with open(log) as f:
        return "".join(line for line in f
                       if "registers" in line or "spill" in line)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
