"""Time clk_update's wave kernel at several strip widths on one card.

    python -m superlu_dist_tpu_torch.tools.clk_strip_ab [K ...]

For each strip width TN of ``WIDTHS`` it copies ``csrc/clk.cu`` and its
headers into ``build/torch_kernels/ab/tn<TN>`` with ``constexpr int TN``
set to TN, builds the copies with the port's nvcc flags (all at once) and
loads them. On the clk plan of ``laplacian_3d(K)`` at block size 128 (K =
32 and 50 unless given) it runs the left-looking factor once per width in
the order ``ORDER``: per level clk_update, timed by CUDA events with L2
flushed before (as ``chip_smoke.py``'s check_kernels times it), then
diag_lu and clk_trsm. It prints the card, each run's clk_update ms per
factor, and whether each width's factor equals the shipped width's bit
for bit (an output element sums the same products in the same order at
any width). Needs a CUDA device.
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
from ..ops.kernels import clk as _clk

WIDTHS = (16, 8, 32)
ORDER = (16, 8, 32, 32, 8, 16)


def _start(tn: int):
    """Write the TN variant and start its nvcc; returns (process, .so)."""
    d = os.path.join(_build.BUILD_DIR, "ab", f"tn{tn}")
    os.makedirs(d, exist_ok=True)
    for f in os.listdir(_build._CSRC):
        if f.endswith(".cuh"):
            shutil.copy(os.path.join(_build._CSRC, f), d)
    with open(os.path.join(_build._CSRC, "clk.cu")) as f:
        src, n = re.subn(r"constexpr int TN = \d+;",
                         f"constexpr int TN = {tn};", f.read())
    if n != 1:
        raise SystemExit("clk.cu: no single `constexpr int TN` to set")
    path = os.path.join(d, "clk.cu")
    with open(path, "w") as f:
        f.write(src)
    so = os.path.join(d, "clk.so")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    return subprocess.Popen([_build._nvcc(), *flags, "-o", so, path]), so


def _update_times(torch, lu, flush):
    """One clk factor of ``lu``'s plan with the current clk_update library;
    returns (clk_update ms summed over the levels, the factored pool)."""
    from ..ops import blocklu
    from ..ops.kernels import diag_lu
    plan, tp = lu.plan, lu._ftapes
    pool = blocklu.init_pool(plan, lu._a3_data, np.float32, "cuda")
    linv = torch.zeros((plan.nb, plan.bs, plan.bs), device="cuda")
    uinv = torch.zeros_like(linv)
    tiny = torch.zeros(1, dtype=torch.int32, device="cuda")
    total = 0.0
    for lvl in range(tp.nlvl):
        flush.zero_()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        _clk.clk_update(pool, linv, tp, lvl)
        ev[1].record()
        torch.cuda.synchronize()
        total += ev[0].elapsed_time(ev[1])
        lo, hi = int(tp.dptr[lvl]), int(tp.dptr[lvl + 1])
        diag_lu.diag_lu(pool, linv, uinv, tp.dslot[lo:hi], tp.dstep[lo:hi],
                        lu._thresh(), tiny)
        _clk.clk_trsm(pool, uinv, tp, lvl)
    return total, pool


def main(ks) -> None:
    import torch

    from .. import Options, gssvx
    from ..utils.testing import laplacian_3d
    if not torch.cuda.is_available():
        raise SystemExit("clk_strip_ab needs a CUDA device")
    print("card:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    started = {tn: _start(tn) for tn in WIDTHS}
    libs = {}
    for tn, (proc, so) in started.items():
        if proc.wait() != 0:
            raise SystemExit(f"nvcc failed for TN = {tn}")
        lib = ctypes.CDLL(so)
        fn = lib.slu_clk_waves_f32
        fn.argtypes = _clk.UPDATE.entries["slu_clk_waves_f32"]
        fn.restype = ctypes.c_int
        libs[tn] = lib
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for k in ks:
        A = laplacian_3d(k)
        b = np.ones(A.shape[0])
        _, lu = gssvx(A, b, Options(dtype="float32", block_size=128))
        shipped = _clk.UPDATE.lib()
        times = {tn: [] for tn in WIDTHS}
        pools = {}
        for tn in ORDER:
            _clk.UPDATE._lib = libs[tn]
            ms, pool = _update_times(torch, lu, flush)
            times[tn].append(ms)
            pools.setdefault(tn, pool)
        _clk.UPDATE._lib = shipped
        ref = pools[ORDER[0]]
        for tn in WIDTHS:
            print(f"lap3d{k} bs=128 TN={tn:2d}: clk_update "
                  f"{' / '.join(f'{m:.3f}' for m in times[tn])} ms per "
                  f"factor; {lu.plan.bs // tn} CTAs per target, "
                  f"{(lu.plan.bs // 4) * (tn // 4)} threads each; factor "
                  f"bit-equal to TN={ORDER[0]}: "
                  f"{bool(torch.equal(pools[tn], ref))}", flush=True)
        del pools, ref


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [32, 50])
