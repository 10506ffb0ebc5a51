"""Time tck_update's two phases on one card: at several tile heights, and
for several variants of the phase-B kernel; or the bf16 pass's phase B
against an earlier checkout's.

    python -m superlu_dist_tpu_torch.tools.tck_ab [K ...]
    python -m superlu_dist_tpu_torch.tools.tck_ab --bf16 OLD_CSRC [K ...]

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

bf16 (``--bf16 OLD_CSRC``, the ``csrc`` directory of an earlier
checkout, e.g. from ``git archive``, whose phase B in the bf16 pass is
``slu_tck_tiles_bf16`` on the tiles): on the tck plan of
``laplacian_3d(K)`` (bs 128), level by level, phase A (the shipped
``tck_waves`` at "default") and then phase B through OLD's tiles and
through the shipped chains (``tck_chains``), every run on a copy of the
same input, L2 flushed, in
the order of the runs and then back; the factor goes on with the shipped
kernels. It prints per run phase B's and tck_update_bf16's ms per factor
and its largest distance from OLD's output (the chains sum each position
in chunks, so they round apart from the tiles); per level (the six
costliest by OLD's phase B) the tiles, the longest tile list, the longest
chain of one position (the tiles' floor), the chunks and the longest
chunk, and each run's ms. Before that, the warm FACT under "auto" by
SamePattern_SameRowPerm refactors with OLD's phase B and the shipped one
in turns (old, new, new, old, after one untimed call through each).
Kernels load eagerly (``CUDA_MODULE_LOADING=EAGER``).
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


# ---------------------------------------------------------------------------
# the bf16 pass
# ---------------------------------------------------------------------------

#: OLD's slu_tck_tiles_bf16
_OLD_TILES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _start_old(src_dir):
    """Copy ``src_dir``'s tck.cu and headers into a build directory of its
    own and start nvcc; returns (process, .so)."""
    d = os.path.join(_build.BUILD_DIR, "ab", "tck_old")
    os.makedirs(d, exist_ok=True)
    for f in os.listdir(src_dir):
        if f.endswith(".cuh") or f == "tck.cu":
            shutil.copy(os.path.join(src_dir, f), d)
    so = os.path.join(d, "tck.so")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    return subprocess.Popen([_build._nvcc(), *flags, "-o", so,
                             os.path.join(d, "tck.cu")]), so


def _old_tiles(lib):
    """A function (pool, tp, level) running ``level``'s phase B through
    OLD's slu_tck_tiles_bf16 on the tiles."""
    fn = lib.slu_tck_tiles_bf16
    fn.argtypes = _OLD_TILES
    fn.restype = ctypes.c_int

    def go(pool, tp, level):
        lo, hi = int(tp.tptr[level]), int(tp.tptr[level + 1])
        if hi == lo:
            return
        _tck.UPDATE_BF16.check("slu_tck_tiles_bf16", fn(
            _build.ptr(pool), _build.ptr(tp.tiles), _build.ptr(tp.bl),
            _build.ptr(tp.bu), _build.ptr(tp.bd), lo, hi - lo,
            int(tp.hmax[level]), pool.shape[-1],
            _build.stream_ptr(pool.device)))
    return go


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


def _fact_turns(torch, A, lu, old_go):
    """Warm FACT under "auto" by SamePattern_SameRowPerm refactors of
    ``lu``, phase B through OLD's tiles (``old_go``) or the shipped
    chains, in turns old, new, new, old after one untimed call through
    each; prints each call's FACT device ms, steps and berr."""
    from .. import Fact, gssvx
    shipped = _tck.tck_chains

    def through_old(pool, tp, level, wide=-1):
        _tck.UPDATE_BF16.count("slu_tck_chunks_bf16")
        old_go(pool, tp, level)

    b = np.ones(A.shape[0])
    opts = lu.options.replace(fact=Fact.SAME_PATTERN_SAME_ROWPERM,
                              gemm_precision="auto")
    try:
        for i, lab in enumerate(("old", "new", "old", "new", "new", "old")):
            _tck.tck_chains = through_old if lab == "old" else shipped
            lu._prec_sticky = False
            res, _ = gssvx(A, b, opts, lu=lu)
            torch.cuda.synchronize()
            if i < 2:
                continue
            dm = res.stat.device_ms
            print(f"  warm FACT under auto, {lab}: {dm['FACT']:.3f} ms "
                  f"(gemm_precision {res.stat.counters['gemm_precision']}, "
                  f"{res.stat.refine_steps} refinement steps, berr "
                  f"{float(res.berr.max()):.2e})", flush=True)
    finally:
        _tck.tck_chains = shipped


def _chain_stats(tp, level):
    """(tiles, longest tile list, longest chain of one position, chunks,
    longest chunk) of ``level``'s phase B."""
    h, c = tp.host, tp.chains
    lo, hi = int(tp.tptr[level]), int(tp.tptr[level + 1])
    tl = h["tiles"][lo:hi, 3] - h["tiles"][lo:hi, 2]
    t0, t1 = int(c.tptr[level]), int(c.tptr[level + 1])
    q0, q1 = int(c.qptr[level]), int(c.qptr[level + 1])
    return (hi - lo, int(tl.max(initial=0)),
            int(np.diff(c.host["cptr"][t0:t1 + 1]).max(initial=0)), q1 - q0,
            int(np.diff(c.host["qcptr"][q0:q1 + 1]).max(initial=0)))


def main_bf16(old: str, ks) -> None:
    os.environ["CUDA_MODULE_LOADING"] = "EAGER"
    import torch

    from .. import Options, gssvx
    from ..ops import blocklu
    from ..ops.kernels import clk, diag_lu
    from ..utils.testing import laplacian_3d
    if not torch.cuda.is_available():
        raise SystemExit("tck_ab needs a CUDA device")
    print("card:", _card(), flush=True)
    proc, so = _start_old(old)
    if proc.wait() != 0:
        raise SystemExit("nvcc failed for OLD's tck.cu")
    runs = {"old": _old_tiles(ctypes.CDLL(so)),
            "new": lambda pool, tp, level: _tck.tck_chains(pool, tp, level)}
    labels = list(runs)
    order = labels + labels[::-1]
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for k in ks:
        A = laplacian_3d(k)
        _, lu = gssvx(A, np.ones(A.shape[0]),
                      Options(dtype="float32", block_size=128,
                              executor="tck", gemm_precision="highest"))
        _fact_turns(torch, A, lu, runs["old"])
        plan, tp = lu.plan, lu._ftapes
        pool = blocklu.init_pool(plan, lu._a3_data, np.float32, "cuda")
        linv = torch.zeros((plan.nb, plan.bs, plan.bs), device="cuda")
        uinv = torch.zeros_like(linv)
        tiny = torch.zeros(1, dtype=torch.int32, device="cuda")
        ms_a = np.zeros(tp.nlvl)
        ms = {lab: np.zeros(tp.nlvl) for lab in labels}
        diff = dict.fromkeys(labels, 0.0)
        for lab in labels:   # each library's runtime set up, untimed
            runs[lab](pool.clone(), tp, 0)
        for lvl in range(tp.nlvl):
            flush.zero_()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            _tck.tck_waves(pool, linv, tp, lvl, "default")
            ev[1].record()
            torch.cuda.synchronize()
            ms_a[lvl] = ev[0].elapsed_time(ev[1])
            outs = {}
            for lab in order:
                a = pool.clone()
                flush.zero_()
                ev[0].record()
                runs[lab](a, tp, lvl)
                ev[1].record()
                torch.cuda.synchronize()
                ms[lab][lvl] += ev[0].elapsed_time(ev[1]) / 2
                outs.setdefault(lab, a)
            scale = max(1.0, float(outs["old"].abs().max()))
            for lab, a in outs.items():
                diff[lab] = max(diff[lab], float(
                    (a - outs["old"]).abs().max()) / scale)
            pool = outs["new"]
            del outs
            lo, hi = int(tp.dptr[lvl]), int(tp.dptr[lvl + 1])
            diag_lu.diag_lu(pool, linv, uinv, tp.dslot[lo:hi],
                            tp.dstep[lo:hi], lu._thresh(), tiny)
            clk.clk_trsm(pool, uinv, tp, lvl, "default")
        longest = sum(_chain_stats(tp, lvl)[2] for lvl in range(tp.nlvl))
        print(f"lap3d{k} tck bf16: {tp.nlvl} levels, phase A "
              f"{ms_a.sum():.3f} ms; phase B {len(tp.host['bl'])} products "
              f"in {len(tp.host['tiles'])} tiles or "
              f"{int(tp.chains.qptr[-1])} chunks; the longest chains of one "
              f"position summed over the levels: {longest} products",
              flush=True)
        for lab in labels:
            print(f"  {lab:34s} phase B {ms[lab].sum():9.3f} ms, "
                  f"tck_update_bf16 {ms_a.sum() + ms[lab].sum():9.3f} ms "
                  f"per factor; largest distance from old {diff[lab]:.3e} "
                  "of scale", flush=True)
        for lvl in sorted(np.argsort(-ms["old"])[:6]):
            nt, tl, chain, nq, ql = _chain_stats(tp, lvl)
            print(f"  level {lvl:3d}: phase A {ms_a[lvl]:.3f} ms; {nt} tiles "
                  f"(longest list {tl}), longest chain of one position "
                  f"{chain}; {nq} chunks (longest {ql}); " + ", ".join(
                      f"{lab} {ms[lab][lvl]:.3f} ms" for lab in labels),
                  flush=True)


if __name__ == "__main__":
    args = sys.argv[1:]
    if args[:1] == ["--bf16"]:
        main_bf16(args[1], [int(a) for a in args[2:]] or [32, 50])
    else:
        main([int(a) for a in args] or [32, 50])
