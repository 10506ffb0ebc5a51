"""Time the level executor's ``schur`` per level on one card, in each band
geometry.

    python -m superlu_dist_tpu_torch.tools.schur_ab [K[:dtype] ...]

On the level-executor plan of ``laplacian_3d(K)`` at block size 128
(lap3d32 and lap3d50 in float32 and lap3d32 in float64 unless given, as
``32 50 32:float64``) it runs the level factor (diag_lu, both trsm, schur)
once per ``wide`` setting in the order ``ORDER`` (each setting twice, the
second half reversed), each level's ``schur`` timed by CUDA events with
L2 flushed before (as ``chip_smoke.py``'s check_level times it):
``wide`` -1 lets the kernel choose its bands (``csrc/chain.cuh``), 0 / 1
force bands of 16 / 64.

It prints the card, per setting the schur ms per factor of both runs and
whether each factor is bit-equal to its own first run and to the
automatic setting's (within the smoke's tolerance, 1e-4 of the pool's
magnitude in float32 and 1e-12 in float64, where not); then per level the
targets, the products, the longest chain, the band width the automatic
setting takes (``flk.band_width``: 4x4 tiles in bands of 16, else 4x8)
and, for each setting, the ms (the mean of its two runs) and the share of
the CUDA cores' peak for the type (FP32 67 TFLOP/s, FP64 34 TFLOP/s;
NVIDIA's H100 SXM data sheet) that 2·bs³ per product reaches.
Needs a CUDA device.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np

from ..ops.kernels import schur as _schur
from ..ops.kernels.flk import band_width

#: the settings; the first is the automatic one
SETTINGS = (-1, 0, 1)
ORDER = SETTINGS + SETTINGS[::-1]
NAMES = {-1: "bands by rule", 0: "bands of 16", 1: "bands of 64"}
#: FLOP/s of the CUDA cores (no tensor cores), which the kernel runs on
PEAK = {"float32": 67e12, "float64": 34e12}
TOL = {"float32": 1e-4, "float64": 1e-12}


def _factor_times(torch, lu, wide, flush):
    """One level factor of ``lu``'s plan with schur's bands set by
    ``wide``; returns the ms of each level's schur and the factored
    pool."""
    from ..ops import blocklu
    from ..ops.kernels import diag_lu
    plan, tp = lu.plan, lu._ftapes
    pool = blocklu.init_pool(plan, lu._a3_data, lu.dtype, lu.device)
    linv = torch.zeros((plan.nb, plan.bs, plan.bs), dtype=pool.dtype,
                       device=lu.device)
    uinv = torch.zeros_like(linv)
    tiny = torch.zeros(1, dtype=torch.int32, device=lu.device)
    ms = []
    for lvl in range(tp.nlvl):
        d = slice(int(tp.dptr[lvl]), int(tp.dptr[lvl + 1]))
        lp = slice(int(tp.lptr[lvl]), int(tp.lptr[lvl + 1]))
        up = slice(int(tp.uptr[lvl]), int(tp.uptr[lvl + 1]))
        diag_lu.diag_lu(pool, linv, uinv, tp.dslot[d], tp.dstep[d],
                        lu._thresh(), tiny)
        _schur.trsm(pool, uinv, tp.lslot[lp], tp.lstep[lp], left=False)
        _schur.trsm(pool, linv, tp.uslot[up], tp.ustep[up], left=True)
        flush.zero_()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        _schur.schur(pool, tp, lvl, wide)
        ev[1].record()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
    return ms, pool


def _case(torch, k, dtype, flush, sms):
    from .. import Options, gssvx
    from ..utils.testing import laplacian_3d
    A = laplacian_3d(k)
    _, lu = gssvx(A, np.ones(A.shape[0]),
                  Options(dtype=dtype, block_size=128, executor="pallas"))
    tp, bs = lu._ftapes, lu.plan.bs
    # per setting: the ms of both runs, the first run's pool (until the
    # second), bit-equality of the two, and the distance to the automatic
    # setting's first run
    runs = {w: dict(ms=[]) for w in SETTINGS}
    for w in ORDER:
        ms, pool = _factor_times(torch, lu, w, flush)
        r = runs[w]
        r["ms"].append(ms)
        if "pool" in r:
            r["same"] = bool(torch.equal(r.pop("pool"), pool))
        else:
            r["pool"] = pool
            if w == SETTINGS[0]:
                ref = pool.clone()
                tol = TOL[dtype] * max(1.0, float(ref.abs().max()))
            r["err"] = float((pool - ref).abs().max())
        del pool
    what = f"lap3d{k} bs={bs} {dtype}"
    for w in SETTINGS:
        r = runs[w]
        m1, m2 = r["ms"]
        print(f"{what} {NAMES[w]}: schur {sum(m1):.3f} / {sum(m2):.3f} ms "
              f"per factor over {tp.nlvl} levels; bit-equal on repeat "
              f"{r['same']}; max |diff| to the automatic setting "
              f"{r['err']:.3e} (tolerance {tol:.3e})", flush=True)
        if r["err"] > tol:
            raise SystemExit(f"{what} {NAMES[w]} disagrees with the "
                             "automatic setting")
    cnt = np.diff(tp.host["cptr"])
    for lvl in range(tp.nlvl):
        lo, hi = int(tp.sptr[lvl]), int(tp.sptr[lvl + 1])
        if hi == lo:
            continue
        nprod = int(cnt[lo:hi].sum())
        flops = 2.0 * bs ** 3 * nprod
        cells = []
        for w in SETTINGS:
            m = sum(runs[w]["ms"][i][lvl] for i in (0, 1)) / 2
            share = 100 * flops / max(m * 1e-3, 1e-12) / PEAK[dtype]
            cells.append(f"{NAMES[w]} {m:.4f} ms ({share:.1f}%)")
        print(f"  {what} level {lvl:3d}: {hi - lo} targets, {nprod} "
              f"products, longest chain {int(cnt[lo:hi].max())}; rule "
              f"takes bands of {band_width(bs, hi - lo, sms)}; "
              + "; ".join(cells), flush=True)


def main(cases) -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("schur_ab needs a CUDA device")
    print("card:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for k, dtype in cases:
        _case(torch, k, dtype, flush, sms)


def _parse(arg: str):
    k, _, dtype = arg.partition(":")
    return int(k), dtype or "float32"


if __name__ == "__main__":
    main([_parse(a) for a in sys.argv[1:]]
         or [(32, "float32"), (50, "float32"), (32, "float64")])
