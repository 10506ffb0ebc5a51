"""Time clk_update's wave kernel on one card: the FP32 pass at several
strip widths, or the bf16 pass against variants of an earlier checkout's.

    python -m superlu_dist_tpu_torch.tools.clk_strip_ab [K ...]
    python -m superlu_dist_tpu_torch.tools.clk_strip_ab --bf16 OLD_CSRC [K ...]
    python -m superlu_dist_tpu_torch.tools.clk_strip_ab --trsm OLD_CSRC [K ...]

FP32 (the first form): for each strip width TN of ``WIDTHS`` it copies
``csrc/clk.cu`` and its headers into ``build/torch_kernels/ab/tn<TN>``
with ``constexpr int TN`` set to TN, builds the copies with the port's
nvcc flags (all at once) and loads them. On the clk plan of
``laplacian_3d(K)`` at block size 128 (K = 32 and 50 unless given) it
runs the left-looking factor once per width in the order ``ORDER``: per
level clk_update, timed by CUDA events with L2 flushed before (as
``chip_smoke.py``'s check_kernels times it), then diag_lu and clk_trsm.
It prints the card, each run's clk_update ms per factor, and whether each
width's factor equals the shipped width's bit for bit (an output element
sums the same products in the same order at any width).

bf16 (``--bf16 OLD_CSRC``, the ``csrc`` directory of an earlier
checkout, e.g. from ``git archive``): the bf16 wave launches of clk's
plan and of tck's phase-A tapes on the same plan (``laplacian_3d(K)``,
bs 128), level by level with L2 flushed before each, for: OLD's
``slu_clk_waves_bf16`` as it is and cut by text patches of its
``wave_mma`` (``BF16_VARIANTS``: a deeper ring; the staging only, the
``mma``s removed; fragments and ``mma``s from one resident chunk, the
staging removed; the barriers only); and, where the checkout has
``clk.wave_geom``, the shipped kernel at its own choice of geometry, at
the rules of ``BF16_RULES`` (forced (strip width, ring depth) pairs, or
the widest strip that still gives k CTAs an SM) and as the patched
copies of ``NEW_VARIANTS``. Every run gets a copy of the same input at
every level, in the order of the runs and then back, and the factor goes
on with the shipped kernel. Before that, the main path's warm FACT under
"auto" by SamePattern_SameRowPerm refactors with OLD's bf16 waves and
the shipped ones in turns (old, new, new, old, after one untimed call
through each). It prints per run the ms per factor, the µs per product
on the critical path (the longest list of each wave, summed over the
waves) over all levels and over the four levels with the longest
critical paths, and whether its output equals OLD's bit for bit; then
the split of OLD's per-product time on those levels into barriers and
loop (the barriers-only cut), fragments and ``mma``s (the resident chunk
less that) and bytes in flight (the staging less that). Each run is
called once, untimed, before the first timed level (a library's runtime
sets up at its first call), and kernels load eagerly
(``CUDA_MODULE_LOADING=EAGER``). Needs a CUDA device.

trsm (``--trsm OLD_CSRC``, a checkout whose bf16 TRSM is ``panel.cuh``'s
``band_product_mma``, as before the bf16 TRSM had a kernel of its own):
clk's bf16 TRSM (``slu_clk_trsm_bf16``) on the clk plan of
``laplacian_3d(K)`` (bs 128; K = 32 and 50 unless given), level by level
in a bf16 factor that goes on with the shipped kernels: each level's L
panels, from the same input, L2 flushed before each, through OLD's entry
as it is and cut by text patches of its ``band_product_mma``
(``TRSM_VARIANTS``: the staging only, the ``mma``s removed; fragments and
``mma``s from one resident chunk, the staging removed; the barriers
only), and through the shipped entry, each run in the order of the runs
and then back, a ``torch.cuda._sleep`` holding the card while the host
enqueues each timed launch (the events read the card's time, not the
host's, where the hold outlasts the host's enqueue: both are printed). It
prints per level the panels and columns and each run's ms (the
faster of its two), per run the ms per factor and whether its output
equals OLD's bit for bit, and the split of OLD's time per band product
on an SM (the launch's ms times the SMs over its CTAs, summed over the
launches of bands of 64 and, apart, of bands of 16) into barriers and
loop (the barriers-only cut), fragments and ``mma``s (the resident chunk
less that) and bytes in flight (the staging less that). Before that,
the main path's warm FACT under "auto" by SamePattern_SameRowPerm
refactors with OLD's bf16 TRSM and the shipped one in turns (old, new,
new, old, after one untimed call through each).
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

from ..ops.kernels import _build
from ..ops.kernels import clk as _clk

WIDTHS = (16, 8, 32)
ORDER = (16, 8, 32, 32, 8, 16)

#: the patches of OLD's waves.cuh per variant: (pattern, replacement),
#: each matched once inside wave_mma (STAGES in the whole header)
_NO_MMA = (r"slu_mma::mma_chunk<KC, LD, UL, 2, 2>\(\s*Ls, p < np \? Ls \+ "
           r"S::kL : fstrip \+ k0 \* UL, r0, 0, prod\);", "(void)k0;")
_NO_STAGE = ((r"if \(c \+ STAGES - 1 < nchunks\) load\(c \+ STAGES - 1\);",
              ""),
             (r"const float\* Ls = smem \+ \(c % STAGES\) \* S::kStage;",
              "const float* Ls = smem;"))
_RING = r"constexpr int STAGES = 3;"
BF16_VARIANTS = {
    "old": (),
    "old ring 5": ((_RING, "constexpr int STAGES = 5;"),),
    "old ring 8": ((_RING, "constexpr int STAGES = 8;"),),
    "old staging only": (_NO_MMA,),
    "old resident chunk": _NO_STAGE,
    "old barriers only": (_NO_MMA,) + _NO_STAGE,
}


def _copy_headers(src_dir: str, d: str) -> None:
    os.makedirs(d, exist_ok=True)
    for f in os.listdir(src_dir):
        if f.endswith(".cuh"):
            shutil.copy(os.path.join(src_dir, f), d)


def _nvcc(d: str, path: str):
    so = os.path.join(d, "clk.so")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    return subprocess.Popen([_build._nvcc(), *flags, "-o", so, path]), so


def _start(tn: int):
    """Write the TN variant and start its nvcc; returns (process, .so)."""
    d = os.path.join(_build.BUILD_DIR, "ab", f"tn{tn}")
    _copy_headers(_build._CSRC, d)
    with open(os.path.join(_build._CSRC, "clk.cu")) as f:
        src, n = re.subn(r"constexpr int TN = \d+;",
                         f"constexpr int TN = {tn};", f.read())
    if n != 1:
        raise SystemExit("clk.cu: no single `constexpr int TN` to set")
    path = os.path.join(d, "clk.cu")
    with open(path, "w") as f:
        f.write(src)
    return _nvcc(d, path)


def _start_bf16(label: str, src_dir: str, patches, region="void wave_mma(",
                header="waves.cuh", end="__global__"):
    """Copy ``src_dir``'s clk.cu and headers into a build directory of
    its own, patch its ``header`` (each pattern matched once: inside the
    text from ``region`` to the next ``end``, or anywhere with None;
    STAGES anywhere), start nvcc; returns (process, .so)."""
    d = os.path.join(_build.BUILD_DIR, "ab", "bf16_" +
                     re.sub(r"\W+", "_", label))
    _copy_headers(src_dir, d)
    shutil.copy(os.path.join(src_dir, "clk.cu"), d)
    path = os.path.join(d, header)
    with open(path) as f:
        text = f.read()

    def cut(t):
        if region is None:
            return 0, len(t)
        a = t.index(region)
        return a, t.index(end, a)
    for pat, rep in patches:
        a, b = (0, len(text)) if "STAGES =" in pat else cut(text)
        part, n = re.subn(pat, rep, text[a:b])
        if n != 1:
            raise SystemExit(f"{label}: {pat!r} matched {n} times")
        text = text[:a] + part + text[b:]
    with open(path, "w") as f:
        f.write(text)
    return _nvcc(d, os.path.join(d, "clk.cu"))


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


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


def main(ks) -> None:
    import torch

    from .. import Options, gssvx
    from ..utils.testing import laplacian_3d
    if not torch.cuda.is_available():
        raise SystemExit("clk_strip_ab needs a CUDA device")
    print("card:", _card(), flush=True)
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


# ---------------------------------------------------------------------------
# the bf16 pass
# ---------------------------------------------------------------------------


def _old_launcher(lib):
    """A function (pool, linv, tp, level) launching ``level``'s waves
    through OLD's slu_clk_waves_bf16 (one call, as its wrapper did)."""
    fn = lib.slu_clk_waves_bf16
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def go(pool, linv, tp, level):
        w0, w1 = int(tp.lwave[level]), int(tp.lwave[level + 1])
        if w1 == w0:
            return
        args = [_build.ptr(t) for t in (pool, linv, tp.tslot, tp.tstep,
                                        tp.tfin, tp.pptr, tp.cl, tp.cu)]
        err = fn(*args, ctypes.c_void_p(tp.wptr.ctypes.data + 8 * w0),
                 w1 - w0, pool.shape[-1], _build.stream_ptr(pool.device))
        if err:
            raise RuntimeError(f"old slu_clk_waves_bf16: cudaError {err}")
    return go


def _new_launcher(rule, lib=None):
    """A function (pool, linv, tp, level) launching ``level``'s waves
    through the shipped slu_clk_waves_bf16 (or ``lib``'s), wave w at
    ``rule(bs, targets of w)`` (a (strip width, ring depth) pair)."""
    if lib is None:
        fn = _clk.UPDATE_BF16.fn("slu_clk_waves_bf16")
    else:
        fn = lib.slu_clk_waves_bf16
        fn.argtypes = _clk.UPDATE_BF16.entries["slu_clk_waves_bf16"]
        fn.restype = ctypes.c_int

    def go(pool, linv, tp, level):
        w0, w1 = int(tp.lwave[level]), int(tp.lwave[level + 1])
        if w1 == w0:
            return
        bs = pool.shape[-1]
        g = np.array([(tn << 8) | st for tn, st in (
            rule(bs, int(n)) for n in np.diff(tp.wptr[w0:w1 + 1]))],
            dtype=np.int32)
        args = [_build.ptr(t) for t in (pool, linv, tp.tslot, tp.tstep,
                                        tp.tfin, tp.pptr, tp.cl, tp.cu)]
        _clk.UPDATE_BF16.check("slu_clk_waves_bf16", fn(
            *args, ctypes.c_void_p(tp.wptr.ctypes.data + 8 * w0),
            ctypes.c_void_p(g.ctypes.data), w1 - w0, bs, pool.shape[0],
            linv.shape[0], _build.stream_ptr(pool.device)))
    return go


def _bf16_factor(torch, lu, tp, tck, runs, flush, order):
    """One bf16 factor of ``lu``'s plan on the wave tapes ``tp`` (clk's,
    or tck's with ``tck``), timing every run of ``runs`` (label -> launch
    function of (pool, linv, tp, level)) on a copy of each level's input
    in ``order`` (L2 flushed before each); the factor goes on with the
    shipped kernel. Returns {label: ms per level} (the mean of its runs)
    and {label: its outputs' bit-equality to the first label's}."""
    from ..ops import blocklu
    from ..ops.kernels import diag_lu
    from ..ops.kernels import tck as _tck
    plan = lu.plan
    pool = blocklu.init_pool(plan, lu._a3_data, np.float32, "cuda")
    linv = torch.zeros((plan.nb, plan.bs, plan.bs), device="cuda")
    uinv = torch.zeros_like(linv)
    tiny = torch.zeros(1, dtype=torch.int32, device="cuda")
    ms = {lab: np.zeros(tp.nlvl) for lab in runs}
    same = dict.fromkeys(runs, True)
    for lab in runs:   # each library's runtime set up, untimed
        runs[lab](pool.clone(), linv, tp, 0)
    for lvl in range(tp.nlvl):
        outs = {}
        for lab in order:
            a = pool.clone()
            flush.zero_()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            runs[lab](a, linv, tp, lvl)
            ev[1].record()
            torch.cuda.synchronize()
            ms[lab][lvl] += ev[0].elapsed_time(ev[1])
            outs.setdefault(lab, a)
        ref = outs[order[0]]
        for lab, a in outs.items():
            same[lab] &= bool(torch.equal(a, ref))
        del outs, ref
        if tck:
            _tck.tck_update(pool, linv, tp, lvl, "default")
        else:
            _clk.clk_update(pool, linv, tp, lvl, "default")
        lo, hi = int(tp.dptr[lvl]), int(tp.dptr[lvl + 1])
        diag_lu.diag_lu(pool, linv, uinv, tp.dslot[lo:hi], tp.dstep[lo:hi],
                        lu._thresh(), tiny)
        _clk.clk_trsm(pool, uinv, tp, lvl, "default")
    for lab in ms:
        ms[lab] /= order.count(lab)
    return ms, same


def _fixed(tn, st):
    return lambda bs, n: (tn, st)


def _fill(k, st, narrow=None):
    """The widest strip whose CTAs fill the card ``k`` times over (else
    16), ``st`` deep; ``narrow`` deep where strips of 16 leave SMs idle."""
    def rule(bs, n):
        if narrow is not None and n * (bs // 16) < _clk.SMS:
            return 16, narrow
        tn = max(w for w in _clk.WAVE_WIDTHS
                 if w == 16 or (w <= bs and n * (bs // w) >= k * _clk.SMS))
        return tn, st
    return rule


#: the shipped kernel's rules beside its own choice (``clk.wave_geom``):
#: label -> (block size, targets of a wave) -> (strip width, ring depth)
BF16_RULES = {
    "new TN=16 ring 3": _fixed(16, 3),
    "new TN=16 ring 8": _fixed(16, 8),
    "new TN=32 ring 3": _fixed(32, 3),
    "new TN=64 ring 3": _fixed(64, 3),
    "new fill 1, ring 3": _fill(1, 3),
    "new fill 2, ring 3": _fill(2, 3),
    "new fill 4, ring 3": _fill(4, 3),
    "new fill 8, ring 3": _fill(8, 3),
    "new fill 4, ring 4": _fill(4, 4),
    "new fill 4, ring 2": _fill(4, 2),
}
#: variants of the shipped kernel (patches of its waves.cuh), run at the
#: rule "fill 4, ring 3": label -> patches
NEW_VARIANTS = {
    "new fill 4, ring 3, no early start": (
        (r"constexpr bool kWaveEarly = true;",
         "constexpr bool kWaveEarly = false;"),),
    "new fill 4, ring 3, 4 (2) CTAs an SM": (
        (r"__launch_bounds__\(WaveMma<BS, TN>::kThreads\)",
         "__launch_bounds__(WaveMma<BS, TN>::kThreads, TN == 64 ? 2 : 4)"),),
}


def _fact_turns(torch, A, lu, old_go, order=("old", "new", "new", "old")):
    """The main path's warm FACT under "auto" (bf16-first) by
    SamePattern_SameRowPerm refactors of ``lu``, the bf16 wave launches
    through OLD's entry (``old_go``) or the shipped one, in ``order``
    after one untimed call through each; prints each call's FACT device
    ms, the refinement steps and berr."""
    from .. import Fact, gssvx
    from ..ops.kernels import tck as _tck
    shipped = _clk.launch_waves

    def through_old(kernel, fn, pool, linv, tp, level, geom=None):
        if not fn.endswith("_bf16"):
            return shipped(kernel, fn, pool, linv, tp, level, geom)
        kernel.count(fn, int(tp.lwave[level + 1] - tp.lwave[level]))
        old_go(pool, linv, tp, level)

    b = np.ones(A.shape[0])
    opts = lu.options.replace(fact=Fact.SAME_PATTERN_SAME_ROWPERM,
                              gemm_precision="auto")
    try:
        for i, lab in enumerate(("old", "new") + tuple(order)):
            _clk.launch_waves = _tck.launch_waves = (
                through_old if lab == "old" else shipped)
            lu._prec_sticky = False
            res, _ = gssvx(A, b, opts, lu=lu)
            torch.cuda.synchronize()
            if i < 2:   # one untimed call through each first
                continue
            dm = res.stat.device_ms
            print(f"  warm FACT under auto, {lab}: {dm['FACT']:.3f} ms "
                  f"(gemm_precision {res.stat.counters['gemm_precision']}, "
                  f"{res.stat.refine_steps} refinement steps, REFINE "
                  f"{dm['REFINE']:.3f} ms, berr {float(res.berr.max()):.2e})",
                  flush=True)
    finally:
        _clk.launch_waves = _tck.launch_waves = shipped


def main_bf16(old: str, ks) -> None:
    # every library's kernels loaded when it loads
    os.environ["CUDA_MODULE_LOADING"] = "EAGER"
    import torch

    from .. import Options, gssvx
    from ..ops.kernels import tck as _tck
    from ..utils.testing import laplacian_3d
    if not torch.cuda.is_available():
        raise SystemExit("clk_strip_ab needs a CUDA device")
    print("card:", _card(), flush=True)
    new = hasattr(_clk, "wave_geom")
    started = {lab: _start_bf16(lab, old, p)
               for lab, p in BF16_VARIANTS.items()}
    if new:
        started.update({lab: _start_bf16(lab, _build._CSRC, p, None)
                        for lab, p in NEW_VARIANTS.items()})
    libs = {}
    for lab, (proc, so) in started.items():
        if proc.wait() != 0:
            raise SystemExit(f"nvcc failed for {lab}")
        libs[lab] = ctypes.CDLL(so)
    runs = {lab: _old_launcher(libs[lab]) for lab in BF16_VARIANTS}
    if new:
        runs["new, its own choice"] = _new_launcher(_clk.wave_geom)
        runs.update({lab: _new_launcher(r) for lab, r in BF16_RULES.items()})
        runs.update({lab: _new_launcher(_fill(4, 3), libs[lab])
                     for lab in NEW_VARIANTS})
    labels = list(runs)
    order = labels + labels[::-1]
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for k in ks:
        A = laplacian_3d(k)
        _, lu = gssvx(A, np.ones(A.shape[0]),
                      Options(dtype="float32", block_size=128,
                              gemm_precision="highest"))
        if new:
            _fact_turns(torch, A, lu, runs["old"])
        for what, tp, tck in (
                ("clk", lu._ftapes, False),
                ("tck phase A", _tck.build_tck_tapes(lu.plan, "cuda"),
                 True)):
            ms, same = _bf16_factor(torch, lu, tp, tck, runs, flush, order)
            cnt = np.diff(tp.host["pptr"])
            crit = np.array([sum(int(cnt[tp.wptr[w]:tp.wptr[w + 1]].max(
                initial=0)) for w in range(int(tp.lwave[lvl]),
                                            int(tp.lwave[lvl + 1])))
                for lvl in range(tp.nlvl)])
            deep = np.argsort(-crit)[:4]
            print(f"lap3d{k} {what} bf16 waves: {int(tp.lwave[-1])} "
                  f"launches over {tp.nlvl} levels, {cnt.size} products, "
                  f"critical path {int(crit.sum())} products; levels "
                  f"{sorted(deep.tolist())} hold the longest "
                  f"({int(crit[deep].sum())})", flush=True)
            per = {}
            for lab in labels:
                m = ms[lab]
                per[lab] = 1e3 * m[deep].sum() / crit[deep].sum()
                print(f"  {lab:24s} {m.sum():9.3f} ms per factor "
                      f"({1e3 * m.sum() / crit.sum():.3f} us per critical "
                      f"product; {per[lab]:.3f} on those levels); "
                      f"bit-equal to {labels[0]}: {same[lab]}", flush=True)
            bar = per["old barriers only"]
            print(f"  split of the old kernel's {per['old']:.3f} us per "
                  f"critical product on those levels: barriers and loop "
                  f"{bar:.3f}, fragments and mma "
                  f"{per['old resident chunk'] - bar:.3f}, bytes in flight "
                  f"{per['old staging only'] - bar:.3f}", flush=True)


# ---------------------------------------------------------------------------
# the bf16 TRSM
# ---------------------------------------------------------------------------

#: the patches of OLD's panel.cuh per variant, inside band_product_mma
_T_NO_MMA = (r"slu_mma::mma_chunk<[^;]*;", "(void)A;")
_T_NO_STAGE = ((r"if \(c \+ ST - 1 < NK\)\s*stage_chunk<P, Q::LDB>\([^;]*;",
                ""),
               (r"if \(c < NK\)", "if (c < 1)"),
               (r"const float\* A = ring \+ \(c % ST\) \* Q::kStage;",
                "const float* A = ring;"))
TRSM_VARIANTS = {
    "old": (),
    "old staging only": (_T_NO_MMA,),
    "old resident chunk": _T_NO_STAGE,
    "old barriers only": (_T_NO_MMA,) + _T_NO_STAGE,
}


#: cycles of torch.cuda._sleep before a timed launch: the card waits on it
#: while the host enqueues the launch, so the events hold the kernel's
#: time on the card and not the host's time to launch it (a launch's
#: enqueue now and then takes the host 0.1-0.3 ms)
HOLD_CYCLES = 2_000_000


def _old_trsm(lib):
    """A function (pool, uinv, tp, level) launching ``level``'s L panels
    through OLD's slu_clk_trsm_bf16."""
    fn = lib.slu_clk_trsm_bf16
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def go(pool, uinv, tp, level):
        lo, hi = int(tp.lptr[level]), int(tp.lptr[level + 1])
        if hi == lo:
            return
        err = fn(_build.ptr(pool), _build.ptr(uinv),
                 _build.ptr(tp.lslot[lo:hi]), _build.ptr(tp.lstep[lo:hi]),
                 hi - lo, pool.shape[-1], _build.stream_ptr(pool.device))
        if err:
            raise RuntimeError(f"old slu_clk_trsm_bf16: cudaError {err}")
    return go


def _new_trsm(pool, uinv, tp, level):
    """``level``'s L panels through the shipped slu_clk_trsm_bf16."""
    _clk.clk_trsm(pool, uinv, tp, level, "default")


def _trsm_factor(torch, lu, runs, flush, order):
    """One bf16 clk factor of ``lu``'s plan with the shipped kernels;
    before each level's TRSM, every run of ``runs`` on the level's L
    panels from the same input (L2 flushed) in ``order``; prints each
    run's longest host enqueue beside the hold's card time. Returns
    {label: ms per level} (the least of its runs) and {label: bit-equality
    of its outputs to the first label's}."""
    from ..ops import blocklu
    from ..ops.kernels import diag_lu
    plan, tp = lu.plan, lu._ftapes
    pool = blocklu.init_pool(plan, lu._a3_data, np.float32, "cuda")
    linv = torch.zeros((plan.nb, plan.bs, plan.bs), device="cuda")
    uinv = torch.zeros_like(linv)
    tiny = torch.zeros(1, dtype=torch.int32, device="cuda")
    ms = {lab: np.full(tp.nlvl, np.inf) for lab in runs}
    same = dict.fromkeys(runs, True)
    host = dict.fromkeys(runs, 0.0)
    for lvl in range(tp.nlvl):
        _clk.clk_update(pool, linv, tp, lvl, "default")
        lo, hi = int(tp.dptr[lvl]), int(tp.dptr[lvl + 1])
        diag_lu.diag_lu(pool, linv, uinv, tp.dslot[lo:hi], tp.dstep[lo:hi],
                        lu._thresh(), tiny)
        lo, hi = int(tp.lptr[lvl]), int(tp.lptr[lvl + 1])
        if hi > lo:
            idx = tp.lslot[lo:hi].long()
            X0 = pool[idx]
            if lvl == 0:   # each library's runtime set up, untimed
                for lab in runs:
                    runs[lab](pool, uinv, tp, lvl)
                    pool[idx] = X0
            outs = {}
            for lab in order:
                pool[idx] = X0
                flush.zero_()
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                torch.cuda._sleep(HOLD_CYCLES)
                ev[0].record()
                t0 = time.perf_counter()
                runs[lab](pool, uinv, tp, lvl)
                host[lab] = max(host[lab], 1e3 * (time.perf_counter() - t0))
                ev[1].record()
                torch.cuda.synchronize()
                ms[lab][lvl] = min(ms[lab][lvl], ev[0].elapsed_time(ev[1]))
                outs.setdefault(lab, pool[idx])
            for lab, a in outs.items():
                same[lab] &= bool(torch.equal(a, outs[order[0]]))
            pool[idx] = X0
            del outs, X0
        else:
            for lab in runs:
                ms[lab][lvl] = 0.0
        _clk.clk_trsm(pool, uinv, tp, lvl, "default")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    torch.cuda._sleep(HOLD_CYCLES)
    ev[1].record()
    torch.cuda.synchronize()
    print("  the host's longest enqueue, ms: "
          + "; ".join(f"{lab} {h:.4f}" for lab, h in host.items())
          + f"; the hold on the card {ev[0].elapsed_time(ev[1]):.4f}",
          flush=True)
    return ms, same


def _trsm_fact_turns(torch, A, lu, old_go, order=("old", "new", "new", "old")):
    """The main path's warm FACT under "auto" by SamePattern_SameRowPerm
    refactors of ``lu``, the bf16 TRSM through OLD's entry (``old_go``) or
    the shipped one, in ``order`` after one untimed call through each;
    prints each call's FACT device ms, the refinement steps and berr."""
    from .. import Fact, gssvx
    shipped = _clk.clk_trsm

    def through_old(pool, uinv, tp, level, precision="highest"):
        if precision != "default":
            return shipped(pool, uinv, tp, level, precision)
        if tp.lptr[level + 1] > tp.lptr[level]:
            _clk.TRSM_BF16.count("slu_clk_trsm_bf16")
        old_go(pool, uinv, tp, level)

    b = np.ones(A.shape[0])
    opts = lu.options.replace(fact=Fact.SAME_PATTERN_SAME_ROWPERM,
                              gemm_precision="auto")
    try:
        for i, lab in enumerate(("old", "new") + tuple(order)):
            _clk.clk_trsm = through_old if lab == "old" else shipped
            lu._prec_sticky = False
            res, _ = gssvx(A, b, opts, lu=lu)
            torch.cuda.synchronize()
            if i < 2:   # one untimed call through each first
                continue
            dm = res.stat.device_ms
            print(f"  warm FACT under auto, {lab}: {dm['FACT']:.3f} ms "
                  f"(gemm_precision {res.stat.counters['gemm_precision']}, "
                  f"{res.stat.refine_steps} refinement steps, REFINE "
                  f"{dm['REFINE']:.3f} ms, berr {float(res.berr.max()):.2e})",
                  flush=True)
    finally:
        _clk.clk_trsm = shipped


def main_trsm(old: str, ks) -> None:
    os.environ["CUDA_MODULE_LOADING"] = "EAGER"
    import torch

    from .. import Options, gssvx
    from ..utils.testing import laplacian_3d
    if not torch.cuda.is_available():
        raise SystemExit("clk_strip_ab needs a CUDA device")
    print("card:", _card(), flush=True)
    started = {lab: _start_bf16(lab, old, p, "void band_product_mma(",
                                "panel.cuh", "\n}\n")
               for lab, p in TRSM_VARIANTS.items()}
    libs = {}
    for lab, (proc, so) in started.items():
        if proc.wait() != 0:
            raise SystemExit(f"nvcc failed for {lab}")
        libs[lab] = ctypes.CDLL(so)
    runs = {lab: _old_trsm(libs[lab]) for lab in TRSM_VARIANTS}
    runs["new"] = _new_trsm
    labels = list(runs)
    order = labels + labels[::-1]
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for k in ks:
        A = laplacian_3d(k)
        _, lu = gssvx(A, np.ones(A.shape[0]),
                      Options(dtype="float32", block_size=128,
                              gemm_precision="highest"))
        _trsm_fact_turns(torch, A, lu, runs["old"])
        tp, bs = lu._ftapes, lu.plan.bs
        ms, same = _trsm_factor(torch, lu, runs, flush, order)
        steps = tp.host["lstep"]
        cnt = np.diff(tp.lptr)
        wide = np.zeros(tp.nlvl, dtype=bool)
        for lvl in range(tp.nlvl):
            lo, hi = int(tp.lptr[lvl]), int(tp.lptr[lvl + 1])
            if hi == lo:
                continue
            ncol = len(np.unique(steps[lo:hi]))
            wide[lvl] = 2 * (hi - lo) >= _clk.SMS
            print(f"  lap3d{k} level {lvl:3d}: {hi - lo:4d} panels, {ncol} "
                  f"columns; "
                  + "; ".join(f"{lab} {ms[lab][lvl]:.4f}" for lab in labels)
                  + " ms", flush=True)
        print(f"lap3d{k} bf16 TRSM: {int((cnt > 0).sum())} launches, "
              f"{int(cnt.sum())} L panels", flush=True)
        for lab in labels:
            print(f"  {lab:28s} {ms[lab].sum():8.4f} ms per factor; "
                  f"bit-equal to {labels[0]}: {same[lab]}", flush=True)
        for what, sel, bands in (("bands of 64", wide, bs // 64),
                                 ("bands of 16", ~wide & (cnt > 0),
                                  bs // 16)):
            ctas = float(cnt[sel].sum() * bands)
            if not ctas:
                continue
            per = {lab: 1e3 * ms[lab][sel].sum() * _clk.SMS / ctas
                   for lab in TRSM_VARIANTS}
            bar = per["old barriers only"]
            print(f"  old, {what} ({int(sel.sum())} launches, {int(ctas)} "
                  f"CTAs): {per['old']:.3f} us per band product on an SM "
                  f"= barriers and loop {bar:.3f} + fragments and mma "
                  f"{per['old resident chunk'] - bar:.3f} + bytes in "
                  f"flight {per['old staging only'] - bar:.3f} (overlap "
                  f"{per['old resident chunk'] + per['old staging only'] - bar - per['old']:.3f})",
                  flush=True)


if __name__ == "__main__":
    args = sys.argv[1:]
    if args[:1] == ["--bf16"]:
        main_bf16(args[1], [int(a) for a in args[2:]] or [32, 50])
    elif args[:1] == ["--trsm"]:
        main_trsm(args[1], [int(a) for a in args[2:]] or [32, 50])
    else:
        main([int(a) for a in args] or [32, 50])
