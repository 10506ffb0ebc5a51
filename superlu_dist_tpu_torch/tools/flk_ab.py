"""Time flk_update per target group on one card, at several chunk lengths
and band geometries.

    python -m superlu_dist_tpu_torch.tools.flk_ab [K ...]

On the flk plan of ``laplacian_3d(K)`` at block size 128 (K = 32 and 50
unless given) it runs the flk factor once per setting, in the order
``ORDER`` (each setting twice, the second half reversed), each group's
``flk_update`` timed by CUDA events with L2 flushed before (as
``chip_smoke.py``'s check_flk times it), diag_lu between the groups:

- ``chunk``: None is the automatic cut (``flk.group_chunk`` per group),
  a number cuts every chain into chunks of at most that many products,
  ``NO_CUT`` leaves every chain whole (one pass);
- ``wide``: -1 lets the kernel choose its bands (``csrc/chain.cuh``),
  0 / 1 force bands of 16 / 64.

It prints the card, per setting the flk ms per factor of both runs, the
launches, the groups' sum of the longest chunk (the chained products on
the critical path) and the four costliest groups, and whether each
factor is bit-equal to its own first run and within the smoke's
tolerance (1e-4 of the pool's magnitude) of the automatic setting. Needs
a CUDA device.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np

from ..ops.kernels import flk as _flk

NO_CUT = 1 << 30
#: (chunk, wide); the first is the automatic setting
SETTINGS = ((None, -1), (NO_CUT, -1), (None, 0), (None, 1), (2, -1),
            (3, -1), (6, -1))
ORDER = SETTINGS + SETTINGS[::-1]


def _factor_times(torch, lu, tp, wide, flush):
    """One flk factor of ``lu``'s plan on tapes ``tp``; returns the ms of
    each group and the factored pool."""
    from ..ops import blocklu
    from ..ops.kernels import diag_lu
    plan = lu.plan
    pool = blocklu.init_pool(plan, lu._a3_data, np.float32, "cuda")
    linv = torch.zeros((plan.nb, plan.bs, plan.bs), device="cuda")
    uinv = torch.zeros_like(linv)
    tiny = torch.zeros(1, dtype=torch.int32, device="cuda")
    ms = []
    for lvl in range(tp.nlvl):
        for g in (2 * lvl, 2 * lvl + 1):
            flush.zero_()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            _flk.flk_update(pool, linv, uinv, tp, g, wide)
            ev[1].record()
            torch.cuda.synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
            if g == 2 * lvl:
                lo, hi = int(tp.dptr[lvl]), int(tp.dptr[lvl + 1])
                diag_lu.diag_lu(pool, linv, uinv, tp.dslot[lo:hi],
                                tp.dstep[lo:hi], lu._thresh(), tiny)
    return ms, pool


def _name(chunk, wide):
    c = {None: "auto chunks", NO_CUT: "no cut"}.get(chunk,
                                                     f"chunks of {chunk}")
    band = ("bands by rule", "bands of 16", "bands of 64")[wide + 1]
    return f"{c}, {band}"


def main(ks) -> None:
    import torch

    from .. import Options, gssvx
    from ..utils.testing import laplacian_3d
    if not torch.cuda.is_available():
        raise SystemExit("flk_ab needs a CUDA device")
    print("card:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for k in ks:
        A = laplacian_3d(k)
        _, lu = gssvx(A, np.ones(A.shape[0]),
                      Options(dtype="float32", block_size=128,
                              executor="flk"))
        chunks = {c for c, _ in SETTINGS}
        tapes = {c: _flk.build_flk_tapes(lu.plan, "cuda", chunk=c)
                 for c in chunks}
        # per setting: the ms of both runs, its launches, the first
        # run's pool (until the second), bit-equality of the two, and the
        # first run's distance to the automatic setting
        runs = {s: dict(ms=[]) for s in SETTINGS}
        for s in ORDER:
            _flk.KERNEL.reset_counts()
            ms, pool = _factor_times(torch, lu, tapes[s[0]], s[1], flush)
            r = runs[s]
            r["ms"].append(ms)
            r["n"] = _flk.KERNEL.launches
            if "pool" in r:
                r["same"] = bool(torch.equal(r.pop("pool"), pool))
            else:
                r["pool"] = pool
                if s == SETTINGS[0]:
                    ref = pool.clone()
                    tol = 1e-4 * max(1.0, float(ref.abs().max()))
                r["err"] = float((pool - ref).abs().max())
            del pool
        for s in SETTINGS:
            tp = tapes[s[0]]
            qlen = np.diff(tp.host["qcptr"])
            crit = sum(int(qlen[tp.qptr[g]:tp.qptr[g + 1]].max(initial=0))
                       for g in range(2 * tp.nlvl))
            r = runs[s]
            (m1, m2), n, err = r["ms"], r["n"], r["err"]
            top = sorted(((a + b) / 2, g) for g, (a, b) in
                         enumerate(zip(m1, m2)))[::-1][:4]
            print(f"lap3d{k} bs=128 {_name(*s)}: flk {sum(m1):.3f} / "
                  f"{sum(m2):.3f} ms per factor, {n} launches, critical "
                  f"path {crit} products; bit-equal on repeat "
                  f"{r['same']}, max |diff| to the "
                  f"automatic setting {err:.3e} (tolerance {tol:.3e}); "
                  "costliest groups " + ", ".join(
                      f"{g // 2}{'p' if g % 2 else 'd'} {t:.3f}"
                      for t, g in top), flush=True)
            if err > tol:
                raise SystemExit(f"{_name(*s)} disagrees with the automatic "
                                 "setting")
        del runs, ref


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [32, 50])
