"""Build and load the hand-written CUDA kernels.

Each source under ``csrc/`` has a plain C interface (the ``.cuh``
headers hold device code that several sources share). It is compiled by
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
import re
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
    launches the kernel (and nowhere else); a wrapper that counts by
    :meth:`count` also keeps ``entry_launches``, the launches per entry."""

    def __init__(self, name: str, source: str, entries: dict):
        self.name = name
        self.source = source
        self.entries = entries
        self.launches = 0
        self.entry_launches = dict.fromkeys(entries, 0)
        self._lib = None

    def count(self, fn: str, n: int = 1) -> None:
        """``n`` launches through entry ``fn``."""
        self.launches += n
        self.entry_launches[fn] += n

    def reset_counts(self) -> None:
        self.launches = 0
        self.entry_launches = dict.fromkeys(self.entries, 0)

    @property
    def source_path(self) -> str:
        return os.path.join(_CSRC, self.source)

    def so_path(self) -> str:
        h = hashlib.sha256()
        # the source and every shared header it may include
        headers = sorted(f for f in os.listdir(_CSRC) if f.endswith(".cuh"))
        for path in [self.source_path] + [os.path.join(_CSRC, f)
                                          for f in headers]:
            with open(path, "rb") as f:
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

    def fn(self, name: str):
        """The ctypes function of entry ``name``, for a caller that
        launches it many times (it returns the ``cudaError_t``, which the
        caller passes to :meth:`check`)."""
        return getattr(self.lib(), name)

    def check(self, name: str, err: int) -> None:
        """Raise if a launch through entry ``name`` returned ``err`` != 0."""
        if err != 0:
            raise RuntimeError(f"{self.name}: CUDA launch of {name} failed "
                               f"with cudaError {err}")

    def call(self, fn: str, *args) -> None:
        """Launch through entry ``fn`` and raise if the launch failed."""
        self.check(fn, self.fn(fn)(*args))


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
    """The ``-Xptxas -v`` lines (each function's name, then its registers,
    shared memory and spills) of the last build of ``kernel``, the names
    demangled where ``c++filt`` is found."""
    log = kernel.so_path() + ".log"
    if not os.path.exists(log):
        return ""
    with open(log) as f:
        text = "".join(line for line in f
                       if "Function properties for" in line
                       or "registers" in line or "spill" in line)
    filt = shutil.which("c++filt")
    if filt and text:
        done = subprocess.run([filt], input=text, capture_output=True,
                              text=True)
        if done.returncode == 0:
            text = done.stdout
    return text


def sass(so: str) -> dict:
    """The instructions of each kernel in the library ``so``, by name
    (anonymous-namespace tags cut), addresses and encodings cut, as
    ``cuobjdump -sass`` prints them; {} where the toolkit has no
    ``cuobjdump``."""
    cob = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    if not os.path.exists(cob):
        return {}
    out = subprocess.run([cob, "-sass", so], capture_output=True,
                         text=True).stdout
    fns = {}
    for part in re.split(r"\n\s*Function : ", out)[1:]:
        name, body = part.split("\n", 1)
        fns[re.sub(r"_GLOBAL__N__[0-9a-f]+_", "", name.strip())] = [
            re.sub(r"/\*[0-9a-f]{4}\*/", "", line).split(";")[0].strip()
            for line in body.splitlines()
            if re.search(r"/\*[0-9a-f]{4}\*/", line)]
    return fns


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
