"""Hold two builds of ``diag_lu.cu`` against each other on one card.

    python -m superlu_dist_tpu_torch.tools.diag_lu_ab OLD/diag_lu.cu NEW/diag_lu.cu

Builds each source with the port's nvcc flags into a library of its own
(under ``build/torch_kernels/ab``), loads both into one process and, for
float32 and float64 at 130 and 8 tiles of 128 × 128, launches them in
alternating order (an L2 flush before each launch, CUDA events around
it): prints whether the outputs agree bit for bit, the median time of each
with its quartiles, the median ratio NEW/OLD and in how many pairs NEW was
faster; then whether each kernel's SASS is the same instruction for
instruction (``cuobjdump``, where the toolkit has it). A source may include
headers beside it (``tile_lu.cuh``). Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

import numpy as np

from ..ops.kernels import _build

PAIRS = 120


def _build_lib(src: str, tag: str):
    out = os.path.join(_build.BUILD_DIR, "ab")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, f"diag_lu_{tag}.so")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_build._nvcc(), *flags, "-o", so, src], check=True)
    lib = ctypes.CDLL(so)
    for sfx, th in (("f32", ctypes.c_float), ("f64", ctypes.c_double)):
        f = getattr(lib, f"slu_diag_lu_{sfx}")
        f.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int, th,
                                              ctypes.c_void_p, ctypes.c_void_p]
        f.restype = ctypes.c_int
    return lib, so


def _sass(so: str) -> dict:
    """Instructions of each kernel in ``so``, addresses and encodings cut."""
    cob = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
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


def main(old_src: str, new_src: str) -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("diag_lu_ab needs a CUDA device")
    libs = {"old": _build_lib(old_src, "old"), "new": _build_lib(new_src,
                                                                 "new")}
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    P = ctypes.c_void_p
    bs = 128
    for dt, sfx in ((torch.float32, "f32"), (torch.float64, "f64")):
        for ntile in (130, 8):
            g = torch.Generator().manual_seed(11)
            base = (torch.randn(ntile + 2, bs, bs, generator=g,
                                dtype=torch.float64)
                    + 40 * torch.eye(bs, dtype=torch.float64)).to(dt).cuda()
            slots = torch.arange(1, ntile + 1, dtype=torch.int32,
                                 device="cuda")
            steps = torch.arange(ntile, dtype=torch.int32, device="cuda")
            ms = {"old": [], "new": []}
            outs = {}
            for rep in range(PAIRS + 1):
                for tag in (("old", "new") if rep % 2 else ("new", "old")):
                    pool = base.clone()
                    li = torch.zeros(ntile, bs, bs, dtype=dt, device="cuda")
                    ui = torch.zeros_like(li)
                    tiny = torch.zeros(1, dtype=torch.int32, device="cuda")
                    fn = getattr(libs[tag][0], f"slu_diag_lu_{sfx}")
                    flush.zero_()
                    ev = [torch.cuda.Event(enable_timing=True)
                          for _ in range(2)]
                    ev[0].record()
                    err = fn(P(pool.data_ptr()), P(li.data_ptr()),
                             P(ui.data_ptr()), P(slots.data_ptr()),
                             P(steps.data_ptr()), ntile, bs, 1e-3,
                             P(tiny.data_ptr()), stream)
                    ev[1].record()
                    torch.cuda.synchronize()
                    if err:
                        raise RuntimeError(f"{tag}: cudaError {err}")
                    if rep:       # the first pair warms both up
                        ms[tag].append(ev[0].elapsed_time(ev[1]))
                    outs[tag] = [t.cpu() for t in (pool, li, ui, tiny)]
            same = all(torch.equal(x, y)
                       for x, y in zip(outs["old"], outs["new"]))
            o, n = np.array(ms["old"]), np.array(ms["new"])

            def q(a):
                return (f"{np.median(a):.4f} ms (quartiles "
                        f"{np.percentile(a, 25):.4f}-"
                        f"{np.percentile(a, 75):.4f})")

            print(f"diag_lu {sfx}, {ntile} tiles: bit for bit {same}; old "
                  f"{q(o)}, new {q(n)}; median new/old "
                  f"{np.median(n / o):.4f}; new faster in "
                  f"{int((n < o).sum())} of {len(o)} pairs", flush=True)
    a, b = _sass(libs["old"][1]), _sass(libs["new"][1])
    for name in sorted(a):
        print(f"SASS {name}: {len(a[name])} / {len(b.get(name, []))} "
              "instructions, " + ("identical" if a[name] == b.get(name)
                                  else "different"))


if __name__ == "__main__":
    main(*sys.argv[1:3])
