"""Hold two builds of ``diag_lu.cu`` against each other on one card.

    python -m superlu_dist_tpu_torch.tools.diag_lu_ab OLD/diag_lu.cu NEW/diag_lu.cu

Builds each source with the port's nvcc flags into a library of its own
(under ``build/torch_kernels/ab``), loads both into one process and, for
float32 and float64 at 130 tiles and 1 of 128 × 128, 64 × 64 and 32 × 32
and for complex128 at 130 and 1 of 128 × 128, launches them in
alternating order (an L2 flush before each launch, CUDA
events around it): prints whether the outputs agree bit for bit and, where
they do not, the largest difference of each output (the LU, L⁻¹, U⁻¹, the
tiny count) relative to max(1, max |OLD|), the median time of each with
its quartiles, the median ratio NEW/OLD and in how many pairs NEW was
faster; then whether each kernel's SASS is the same instruction for
instruction (``cuobjdump``, where the toolkit has it). A source may include
headers beside it (``tile_lu.cuh``). Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import os
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
    for sfx, th in (("f32", ctypes.c_float), ("f64", ctypes.c_double),
                    ("c128", ctypes.c_double)):
        f = getattr(lib, f"slu_diag_lu_{sfx}")
        f.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int, th,
                                              ctypes.c_void_p, ctypes.c_void_p]
        f.restype = ctypes.c_int
    return lib, so


def _rel(got, want) -> float:
    """max |got - want| / max(1, max |want|), in float64."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max()
                 / max(1.0, float(want.abs().max())))


#: the element type of each entry suffix
DTYPES = {"f32": "float32", "f64": "float64", "c128": "complex128"}


def tiles(bs, sfx, ntile):
    """Diagonally dominant tiles of entry ``sfx``'s type in pool slots
    1..ntile of ntile + 2, and their slots and steps, on the card."""
    import torch
    g = torch.Generator().manual_seed(11)
    base = (torch.randn(ntile + 2, bs, bs, generator=g, dtype=torch.float64)
            + 40 * torch.eye(bs, dtype=torch.float64))
    if sfx == "c128":
        base = base + 1j * torch.randn(ntile + 2, bs, bs, generator=g,
                                       dtype=torch.float64)
    base = base.to(getattr(torch, DTYPES[sfx])).cuda()
    slots = torch.arange(1, ntile + 1, dtype=torch.int32, device="cuda")
    steps = torch.arange(ntile, dtype=torch.int32, device="cuda")
    return base, slots, steps


def timed_launch(fn, base, slots, steps, flush, stream):
    """One launch of entry ``fn`` on a copy of ``base``, L2 flushed before:
    its ms by CUDA events and its outputs (pool, L⁻¹, U⁻¹, tiny count)."""
    import torch
    P = ctypes.c_void_p
    ntile, bs = len(slots), base.shape[-1]
    pool = base.clone()
    li = torch.zeros(ntile, bs, bs, dtype=base.dtype, device="cuda")
    ui = torch.zeros_like(li)
    tiny = torch.zeros(1, dtype=torch.int32, device="cuda")
    flush.zero_()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    err = fn(P(pool.data_ptr()), P(li.data_ptr()), P(ui.data_ptr()),
             P(slots.data_ptr()), P(steps.data_ptr()), ntile, bs, 1e-3,
             P(tiny.data_ptr()), stream)
    ev[1].record()
    torch.cuda.synchronize()
    if err:
        raise RuntimeError(f"diag_lu: cudaError {err}")
    return ev[0].elapsed_time(ev[1]), (pool, li, ui, tiny)


def _case(libs, bs, sfx, ntile, flush, stream) -> str:
    """One alternating A/B of ``ntile`` tiles of bs × bs for entry
    ``sfx``."""
    import torch
    base, slots, steps = tiles(bs, sfx, ntile)
    ms = {"old": [], "new": []}
    outs = {}
    for rep in range(PAIRS + 1):
        for tag in (("old", "new") if rep % 2 else ("new", "old")):
            t, out = timed_launch(getattr(libs[tag][0], f"slu_diag_lu_{sfx}"),
                                  base, slots, steps, flush, stream)
            if rep:       # the first pair warms both up
                ms[tag].append(t)
            outs[tag] = [x.cpu() for x in out]
    same = all(torch.equal(x, y) for x, y in zip(outs["old"], outs["new"]))
    rel = "" if same else "; largest difference / scale (LU, L⁻¹, U⁻¹, " \
        "tiny) " + ", ".join(f"{_rel(y, x):.3e}"
                             for x, y in zip(outs["old"], outs["new"]))
    o, n = np.array(ms["old"]), np.array(ms["new"])

    def q(a):
        return (f"{np.median(a):.4f} ms (quartiles {np.percentile(a, 25):.4f}"
                f"-{np.percentile(a, 75):.4f})")

    return (f"diag_lu {sfx} bs {bs}, {ntile} tiles: bit for bit {same}{rel};"
            f" old {q(o)}, new {q(n)}; median new/old "
            f"{np.median(n / o):.4f}; new faster in {int((n < o).sum())} of "
            f"{len(o)} pairs")


def main(old_src: str, new_src: str) -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("diag_lu_ab needs a CUDA device")
    libs = {"old": _build_lib(old_src, "old"), "new": _build_lib(new_src,
                                                                 "new")}
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    cases = [(bs, sfx) for bs in (128, 64, 32) for sfx in ("f32", "f64")]
    for bs, sfx in cases + [(128, "c128")]:
        for ntile in (130, 1):
            print(_case(libs, bs, sfx, ntile, flush, stream), flush=True)
    a, b = _build.sass(libs["old"][1]), _build.sass(libs["new"][1])
    for name in sorted(a):
        print(f"SASS {name}: {len(a[name])} / {len(b.get(name, []))} "
              "instructions, " + ("identical" if a[name] == b.get(name)
                                  else "different"))


if __name__ == "__main__":
    main(*sys.argv[1:3])
