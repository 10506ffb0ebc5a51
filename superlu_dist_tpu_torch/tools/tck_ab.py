"""Time tck_update's two phases on one card: at several tile heights, and
for several variants of the phase-B kernel.

    python -m superlu_dist_tpu_torch.tools.tck_ab [K ...]

On the tck plan of ``laplacian_3d(K)`` at block size 128 (K = 32 and 50
unless given) it runs the tck factor several times, per level phase A
(``tck_waves``) and phase B (``tck_tiles``) each timed by CUDA events with
L2 flushed before (as ``chip_smoke.py``'s check_tck times them), then
diag_lu and clk_trsm:

- tile heights: ``build_tck_tapes`` at each ``w`` of ``ROWS`` (None:
  the driver's tapes, each level taking the tallest tile of up to
  ``tile_rows(128)`` rows that keeps its longest chain within its floor;
  a number: tiles of that many rows on every level), with the shipped
  kernel, in the order ``ORDER``;
- phase-B kernels: ``csrc/tck.cu`` and its headers copied into
  ``build/torch_kernels/ab/tck_<variant>`` with its strip width ``TNB``
  and ring depth ``STB`` set to each pair of ``VARIANTS``, built with the
  port's nvcc flags (all at once), each run on the shipped tapes in the
  order ``VORDER`` (the first pair is the shipped kernel's).

It prints the card, each run's phase A, phase B and total ms per factor,
and whether each run's factor equals the first's bit for bit (a position
sums its products in the same order at any tile height, strip width and
ring depth). Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys

import numpy as np

from ..ops.kernels import _build
from ..ops.kernels import tck as _tck

ROWS = (None, 20, 6, 1)
ORDER = ROWS + ROWS[::-1]
#: phase-B kernels: (strip width TNB, ring depth STB)
VARIANTS = ((16, 3), (8, 3), (16, 4), (16, 6))
VORDER = VARIANTS + VARIANTS[::-1]


def _start(tnb: int, stb: int):
    """Write the (TNB, STB) variant of tck.cu and start its nvcc; returns
    (process, .so)."""
    d = os.path.join(_build.BUILD_DIR, "ab", f"tck_tnb{tnb}_stb{stb}")
    os.makedirs(d, exist_ok=True)
    for f in os.listdir(_build._CSRC):
        if f.endswith(".cuh"):
            shutil.copy(os.path.join(_build._CSRC, f), d)
    with open(os.path.join(_build._CSRC, "tck.cu")) as f:
        src = f.read()
    for name, v in (("TNB", tnb), ("STB", stb)):
        src, n = re.subn(rf"constexpr int {name} = \d+;",
                         f"constexpr int {name} = {v};", src)
        if n != 1:
            raise SystemExit(f"tck.cu: no single `constexpr int {name}`")
    path = os.path.join(d, "tck.cu")
    with open(path, "w") as f:
        f.write(src)
    so = os.path.join(d, "tck.so")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    return subprocess.Popen([_build._nvcc(), *flags, "-o", so, path]), so


def _factor_times(torch, lu, tp, flush):
    """One tck factor of ``lu``'s plan on tapes ``tp``; returns (phase A
    ms, phase B ms, both summed over the levels, the factored pool)."""
    from ..ops import blocklu
    from ..ops.kernels import clk, diag_lu
    plan = lu.plan
    pool = blocklu.init_pool(plan, lu._a3_data, np.float32, "cuda")
    linv = torch.zeros((plan.nb, plan.bs, plan.bs), device="cuda")
    uinv = torch.zeros_like(linv)
    tiny = torch.zeros(1, dtype=torch.int32, device="cuda")
    ms = [0.0, 0.0]
    for lvl in range(tp.nlvl):
        for i, fn in enumerate((lambda: _tck.tck_waves(pool, linv, tp, lvl),
                                lambda: _tck.tck_tiles(pool, tp, lvl))):
            flush.zero_()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            fn()
            ev[1].record()
            torch.cuda.synchronize()
            ms[i] += ev[0].elapsed_time(ev[1])
        lo, hi = int(tp.dptr[lvl]), int(tp.dptr[lvl + 1])
        diag_lu.diag_lu(pool, linv, uinv, tp.dslot[lo:hi], tp.dstep[lo:hi],
                        lu._thresh(), tiny)
        clk.clk_trsm(pool, uinv, tp, lvl)
    return ms[0], ms[1], pool


def _report(what, runs, same):
    times = " / ".join(f"{a:.3f} + {b:.3f} = {a + b:.3f}" for a, b in runs)
    print(f"{what}: phase A + phase B = tck_update {times} ms per factor; "
          f"{same}", flush=True)


def main(ks) -> None:
    import torch

    from .. import Options, gssvx
    from ..utils.testing import laplacian_3d
    if not torch.cuda.is_available():
        raise SystemExit("tck_ab needs a CUDA device")
    print("card:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    started = {v: _start(*v) for v in VARIANTS}
    libs = {}
    for v, (proc, so) in started.items():
        if proc.wait() != 0:
            raise SystemExit(f"nvcc failed for TNB, STB = {v}")
        lib = ctypes.CDLL(so)
        for fn, argtypes in _tck.UPDATE.entries.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[v] = lib
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for k in ks:
        A = laplacian_3d(k)
        _, lu = gssvx(A, np.ones(A.shape[0]),
                      Options(dtype="float32", block_size=128,
                              executor="tck"))
        # tile heights, on the shipped kernel
        tapes = {w: _tck.build_tck_tapes(lu.plan, "cuda", w=w)
                 for w in ROWS}
        times = {w: [] for w in ROWS}
        pools = {}
        for w in ORDER:
            a, b, pool = _factor_times(torch, lu, tapes[w], flush)
            times[w].append((a, b))
            pools.setdefault(w, pool)
        for w in ROWS:
            tp = tapes[w]
            smem = _tck.ring_bytes(128) + int(tp.hmax.max()) * 128 * \
                _tck.TN * 4
            what = (f"of up to {tp.w} rows by the level rule" if w is None
                    else f"of {w} rows on every level")
            _report(f"lap3d{k} bs=128 tiles {what} "
                    f"({len(tp.host['tiles'])} tiles, tallest "
                    f"{int(tp.hmax.max())} rows, {smem // 1024} KiB)",
                    times[w], "factor bit-equal to the driver's tapes': "
                    f"{bool(torch.equal(pools[w], pools[ORDER[0]]))}")
        del pools
        # phase-B kernels, on the shipped tapes
        shipped = _tck.UPDATE.lib()
        tp = lu._ftapes
        vtimes = {v: [] for v in VARIANTS}
        vpools = {}
        for v in VORDER:
            _tck.UPDATE._lib = libs[v]
            a, b, pool = _factor_times(torch, lu, tp, flush)
            vtimes[v].append((a, b))
            vpools.setdefault(v, pool)
        _tck.UPDATE._lib = shipped
        ref = vpools[VORDER[0]]
        for v in VARIANTS:
            _report(f"lap3d{k} bs=128 phase B TNB={v[0]:2d} STB={v[1]} "
                    f"(tiles of up to {tp.w} rows)", vtimes[v],
                    f"factor bit-equal to TNB={VORDER[0][0]} "
                    f"STB={VORDER[0][1]}: "
                    f"{bool(torch.equal(vpools[v], ref))}")
        del vpools, ref


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [32, 50])
