"""Time the level executor's ``schur`` per level on one card, in each band
geometry.

    python -m superlu_dist_tpu_torch.tools.schur_ab [K[:dtype] ...]
    python -m superlu_dist_tpu_torch.tools.schur_ab --trsm OLD_CSRC [K[:dtype[:bs]] ...]
    python -m superlu_dist_tpu_torch.tools.schur_ab --mma

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

trsm (``--trsm OLD_CSRC``, the ``csrc`` directory of an earlier
checkout, e.g. from ``git archive``): on the level-executor plan of
``helmholtz_3d(K)`` (complex types; ``laplacian_3d(K)`` for real ones;
``K:dtype`` and the like, 32 in complex128 unless given) at block size
128 (``K:dtype:bs`` for another), the level factor runs with the shipped
kernels, and before each level's trsm of each flag the same panels go
through OLD's ``slu_trsm_<type>``, the shipped one, and one
``torch.bmm`` of the gathered blocks (the library yardstick, as
``chip_smoke.py`` times it), in the order old, new, bmm and then back
(each library called once, untimed, first, and bmm once on each level's
shapes), each on the level's input with L2 flushed before it. Before
each timed launch a ``torch.cuda._sleep`` of ``HOLD_CYCLES`` holds the
card while the host enqueues it, so the events read the card's time and
not the host's; the host's longest enqueue of each run is printed beside
the hold's own time on the card, which must exceed it. It prints per
level and flag the panels, each run's ms (the faster of its two) and
bmm's two; the sums per flag and in all (bmm's faster and slower), with
the bound (operations at 67 TFLOP/s, a complex multiply-add 8 flops) and
the share of it each reaches; whether each run repeats its own first run
bit for bit and
equals the shipped kernel's output bit for bit, and each one's largest
distance from the plain version (``schur.trsm_plain`` on the card)
against the smoke's tolerance (1e-12 of the output's magnitude in 64-bit
types, 1e-4 in 32-bit ones). Kernels load eagerly
(``CUDA_MODULE_LOADING=EAGER``).

``--mma``: the FP64 tensor cores' ``mma.sync`` shapes (m8n8k4, and
m16n8k4, m16n8k8, m16n8k16, which the PTX ISA offers for ``sm_90``):
one tile product of each through the fragment layout that
``csrc/panel.cuh``'s ``mma_f64`` takes (a[2q + h] = A(gid + 8h, tig +
4q), b[q] = B(tig + 4q, gid)) against ``torch.matmul``, then each
shape's rate in registers (528 CTAs of 128 and 256 threads, 8
independent accumulators a warp).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import time

import numpy as np

from ..ops.kernels import schur as _schur
from ..ops.kernels.flk import band_width

#: the settings; the first is the automatic one
SETTINGS = (-1, 0, 1)
ORDER = SETTINGS + SETTINGS[::-1]
NAMES = {-1: "bands by rule", 0: "bands of 16", 1: "bands of 64"}
#: FLOP/s of the CUDA cores (no tensor cores), which the kernel runs on
PEAK = {"float32": 67e12, "float64": 34e12}
TOL = {"float32": 1e-4, "float64": 1e-12, "complex64": 1e-4,
       "complex128": 1e-12}


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


# ---------------------------------------------------------------------------
# trsm against an earlier checkout's
# ---------------------------------------------------------------------------

#: the peak of each type's operations (NVIDIA's H100 SXM data sheet: FP32
#: on the CUDA cores, FP64 on the tensor cores) and real flops per complex
#: multiply-add over a real one's
TRSM_PEAK = 67e12
FLOP_MUL = {"float32": 1, "float64": 1, "complex64": 4, "complex128": 4}


#: cycles of torch.cuda._sleep before a timed launch: the card waits on it
#: while the host enqueues the launch, so the events hold the launch's
#: time on the card and not the host's time to make it (a first bmm on a
#: shape takes the host far longer than a kernel launch)
HOLD_CYCLES = 2_000_000


def _start(label: str, src_dir: str):
    """Build ``src_dir``'s schur.cu (with its headers) into a directory
    of its own; returns (process, .so)."""
    from ..ops.kernels import _build
    d = os.path.join(_build.BUILD_DIR, "ab", "trsm_" + label)
    os.makedirs(d, exist_ok=True)
    for f in os.listdir(src_dir):
        if f.endswith(".cuh") or f == "schur.cu":
            shutil.copy(os.path.join(src_dir, f), d)
    so = os.path.join(d, "schur.so")
    log = open(so + ".log", "w")
    proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so,
                             os.path.join(d, "schur.cu")], stdout=log,
                            stderr=subprocess.STDOUT)
    log.close()
    return proc, so


def _trsm_runs(libs, pool):
    """{label: launch(pool, dinv, slots, steps, left)} for each library of
    ``libs`` (label -> ctypes library, None for the shipped one), the
    entry of ``pool``'s type."""
    from ..ops.kernels.diag_lu import entry
    fn = entry("trsm", pool)

    def bind(lib):
        if lib is None:
            return _schur.TRSM.fn(fn)
        f = getattr(lib, fn)
        f.argtypes = _schur.TRSM.entries[fn]
        f.restype = ctypes.c_int
        return f

    def launcher(f):
        def go(p, dinv, slots, steps, left):
            from ..ops.kernels._build import ptr, stream_ptr
            _schur.TRSM.check(fn, f(ptr(p), ptr(dinv), ptr(slots),
                                    ptr(steps), len(slots), p.shape[-1],
                                    int(left), stream_ptr(p.device)))
        return go
    return {lab: launcher(bind(lib)) for lab, lib in libs.items()}


def _trsm_case(torch, libs, k, dtype, bs, flush):
    from .. import Options, gssvx
    from ..ops import blocklu
    from ..ops.kernels import diag_lu
    from ..utils.testing import helmholtz_3d, laplacian_3d
    A = (helmholtz_3d(k) if dtype.startswith("complex")
         else laplacian_3d(k)).tocsc()
    rng = np.random.default_rng(0)
    b = rng.standard_normal(A.shape[0])
    _, lu = gssvx(A, b, Options(dtype=dtype, block_size=bs,
                                executor="pallas"))
    plan, tp = lu.plan, lu._ftapes
    pool = blocklu.init_pool(plan, lu._a3_data, lu._fdtype, "cuda")
    linv = torch.zeros((plan.nb, bs, bs), dtype=pool.dtype, device="cuda")
    uinv = torch.zeros_like(linv)
    tiny = torch.zeros(1, dtype=torch.int32, device="cuda")
    runs = _trsm_runs(libs, pool)
    order = tuple(runs) + ("bmm", "bmm") + tuple(runs)[::-1]
    for go in runs.values():   # each library's runtime set up, untimed
        go(pool.clone(), linv, tp.lslot[:1], tp.lstep[:1], False)
    rows = []
    same = dict.fromkeys(runs, True)
    eqnew = dict.fromkeys(runs, True)
    err = dict.fromkeys(runs, 0.0)
    host = dict.fromkeys(order, 0.0)
    worst = 0.0

    def timed(go):
        """(card ms, host ms) of go(), L2 flushed, the card held."""
        flush.zero_()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda._sleep(HOLD_CYCLES)
        ev[0].record()
        t0 = time.perf_counter()
        go()
        t1 = time.perf_counter()
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]), 1e3 * (t1 - t0)
    for lvl in range(tp.nlvl):
        d = slice(int(tp.dptr[lvl]), int(tp.dptr[lvl + 1]))
        diag_lu.diag_lu(pool, linv, uinv, tp.dslot[d], tp.dstep[d],
                        lu._thresh(), tiny)
        for left, dinv, sl, st, ptr, f in (
                (False, uinv, tp.lslot, tp.lstep, tp.lptr, "L"),
                (True, linv, tp.uslot, tp.ustep, tp.uptr, "U")):
            s = slice(int(ptr[lvl]), int(ptr[lvl + 1]))
            if s.stop == s.start:
                continue
            slots, steps = sl[s], st[s]
            idx = slots.long()
            X0 = pool[idx]
            want = pool.clone()
            _schur.trsm_plain(want, dinv, slots, steps, left)
            Y = want[idx]
            del want
            scale = max(1.0, float(Y.abs().max()))
            ms = dict.fromkeys(runs, float("inf"))
            ms["bmm"] = []
            first = {}
            Dg = dinv[steps.long()]
            C = torch.empty_like(X0)

            def bmm():
                if left:
                    torch.bmm(Dg, X0, out=C)
                else:
                    torch.bmm(X0, Dg, out=C)
            bmm()   # the library's choice for these shapes made, untimed
            for lab in order:
                if lab == "bmm":
                    m, h = timed(bmm)
                    ms["bmm"].append(m)
                    host["bmm"] = max(host["bmm"], h)
                    continue
                pool[idx] = X0
                m, h = timed(lambda: runs[lab](pool, dinv, slots, steps,
                                               left))
                ms[lab] = min(ms[lab], m)
                host[lab] = max(host[lab], h)
                out = pool[idx]
                if lab in first:
                    same[lab] &= bool(torch.equal(out, first[lab]))
                else:
                    first[lab] = out
                    err[lab] = max(err[lab], float((out - Y).abs().max())
                                   / scale)
            worst = max(worst, float((first["new"] - first["old"]).abs()
                                     .max()) / scale)
            for lab in runs:
                eqnew[lab] &= bool(torch.equal(first[lab], first["new"]))
            pool[idx] = first["new"]
            del Dg, C, X0, Y, first
            rows.append((lvl, f, s.stop - s.start, ms))
        _schur.schur(pool, tp, lvl)
    what = f"{dtype} bs={bs} " + ("helm" if dtype.startswith("complex")
                                  else "lap3d") + f"{k}"
    for lvl, f, n, ms in rows:
        print(f"  {what} level {lvl:3d} {f}: {n:5d} panels; "
              + "; ".join(f"{lab} {ms[lab]:.4f} ms" for lab in runs)
              + "; bmm " + ", ".join(f"{m:.4f}" for m in ms["bmm"])
              + " ms", flush=True)
    flop = 2.0 * bs ** 3 * FLOP_MUL[dtype]
    for f in ("L", "U", "LU"):
        sel = [r for r in rows if r[1] in f]
        n = sum(r[2] for r in sel)
        bound = flop * n / TRSM_PEAK * 1e3
        cells = []
        sums = {lab: sum(r[3][lab] for r in sel) for lab in runs}
        sums["bmm, faster"] = sum(min(r[3]["bmm"]) for r in sel)
        sums["bmm, slower"] = sum(max(r[3]["bmm"]) for r in sel)
        for lab, m in sums.items():
            cells.append(f"{lab} {m:.3f} ms ({100 * bound / m:.1f}% of "
                         "the bound)")
        print(f"{what} trsm {f}: {len(sel)} launches, {n} panels, bound "
              f"{bound:.4f} ms (operations); " + "; ".join(cells),
              flush=True)
    tol = TOL[dtype]
    for lab in runs:
        print(f"{what} {lab}: bit-equal on repeat {same[lab]}, to new "
              f"{eqnew[lab]}; max |out - plain| / scale {err[lab]:.3e} "
              f"(tolerance {tol:.0e})", flush=True)
        if err[lab] > tol or not same[lab]:
            raise SystemExit(f"{what}: {lab} trsm disagrees")
    print(f"{what}: max |new - old| / scale {worst:.3e}", flush=True)
    print(f"{what}: the host's longest enqueue, ms: "
          + "; ".join(f"{lab} {h:.4f}" for lab, h in host.items())
          + f"; the hold on the card {_hold_ms(torch):.4f}", flush=True)


def _hold_ms(torch) -> float:
    """The card's ms for one torch.cuda._sleep(HOLD_CYCLES)."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    torch.cuda._sleep(HOLD_CYCLES)
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1])


def main_trsm(old: str, cases) -> None:
    os.environ["CUDA_MODULE_LOADING"] = "EAGER"
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("schur_ab needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print("card:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    proc, so = _start("old", old)
    _schur.TRSM.lib()
    if proc.wait() != 0:
        raise SystemExit("nvcc failed for old")
    libs = {"old": ctypes.CDLL(so), "new": None}
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for k, dtype, bs in cases:
        _trsm_case(torch, libs, k, dtype, bs, flush)


_MMA_SRC = r"""
#include <cuda_runtime.h>
// d (M x 8) += a (M x K, row) . b (K x 8, col), float64
template <int SH>
__device__ __forceinline__ void mma(double (&d)[4], const double* a,
                                    const double* b) {
  if constexpr (SH == 0)
    asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
                 "{%0,%1}, {%2}, {%3}, {%0,%1};"
                 : "+d"(d[0]), "+d"(d[1]) : "d"(a[0]), "d"(b[0]));
  if constexpr (SH == 1)
    asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
                 "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};"
                 : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
                 : "d"(a[0]), "d"(a[1]), "d"(b[0]));
  if constexpr (SH == 2)
    asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
                 "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                 : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
                 : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]),
                   "d"(b[1]));
  if constexpr (SH == 3)
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
                 "{%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, "
                 "{%12,%13,%14,%15}, {%0,%1,%2,%3};"
                 : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
                 : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]),
                   "d"(a[5]), "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]),
                   "d"(b[2]), "d"(b[3]));
}
template <int SH, int M, int K>
__global__ void layout(const double* A, const double* B, double* C) {
  const int gid = threadIdx.x >> 2, tig = threadIdx.x & 3;
  double a[8], b[4], d[4] = {0, 0, 0, 0};
  for (int q = 0; q < (K + 3) / 4; ++q) {
    for (int h = 0; h < M / 8; ++h)
      a[(M / 8) * q + h] = A[(gid + 8 * h) * K + tig + 4 * q];
    b[q] = B[(tig + 4 * q) * 8 + gid];
  }
  mma<SH>(d, a, b);
  for (int h = 0; h < M / 8; ++h)
    for (int j = 0; j < 2; ++j)
      C[(gid + 8 * h) * 8 + 2 * tig + j] = d[2 * h + j];
}
template <int SH>
__global__ void rate(double* out, int iters) {
  double acc[8][4] = {}, a[8], b[4];
  for (int i = 0; i < 8; ++i) a[i] = 1e-3 * (threadIdx.x + i);
  for (int i = 0; i < 4; ++i) b[i] = 1e-3 * (threadIdx.x - i);
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < 8; ++j) mma<SH>(acc[j], a, b);
  double s = 0;
  for (int j = 0; j < 8; ++j)
    for (int e = 0; e < 4; ++e) s += acc[j][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int probe_layout(int sh, const void* A, const void* B, void* C) {
  const double *a = (const double*)A, *b = (const double*)B;
  double* c = (double*)C;
  if (sh == 0) layout<0, 8, 4><<<1, 32>>>(a, b, c);
  if (sh == 1) layout<1, 16, 4><<<1, 32>>>(a, b, c);
  if (sh == 2) layout<2, 16, 8><<<1, 32>>>(a, b, c);
  if (sh == 3) layout<3, 16, 16><<<1, 32>>>(a, b, c);
  return (int)cudaGetLastError();
}
extern "C" int probe_rate(int sh, void* out, int blocks, int threads,
                          int iters) {
  double* o = (double*)out;
  if (sh == 0) rate<0><<<blocks, threads>>>(o, iters);
  if (sh == 1) rate<1><<<blocks, threads>>>(o, iters);
  if (sh == 2) rate<2><<<blocks, threads>>>(o, iters);
  if (sh == 3) rate<3><<<blocks, threads>>>(o, iters);
  return (int)cudaGetLastError();
}
"""
#: (M, K) of each probed shape, n = 8
_MMA_SHAPES = ((8, 4), (16, 4), (16, 8), (16, 16))


def main_mma() -> None:
    import torch

    from ..ops.kernels import _build
    if not torch.cuda.is_available():
        raise SystemExit("schur_ab needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    d = os.path.join(_build.BUILD_DIR, "ab", "f64mma")
    os.makedirs(d, exist_ok=True)
    src, so = os.path.join(d, "f64mma.cu"), os.path.join(d, "f64mma.so")
    with open(src, "w") as f:
        f.write(_MMA_SRC)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    if subprocess.run([_build._nvcc(), *flags, "-o", so, src]).returncode:
        raise SystemExit("nvcc failed on the mma probe")
    lib = ctypes.CDLL(so)
    V, I = ctypes.c_void_p, ctypes.c_int
    lib.probe_layout.argtypes = [I, V, V, V]
    lib.probe_rate.argtypes = [I, V, I, I, I]
    print("card:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    rng = np.random.default_rng(0)
    out = torch.zeros(528 * 256, dtype=torch.float64, device="cuda")
    for sh, (m, k) in enumerate(_MMA_SHAPES):
        A = torch.tensor(rng.standard_normal((m, k)), device="cuda")
        B = torch.tensor(rng.standard_normal((k, 8)), device="cuda")
        C = torch.zeros((m, 8), dtype=torch.float64, device="cuda")
        err = lib.probe_layout(sh, A.data_ptr(), B.data_ptr(), C.data_ptr())
        torch.cuda.synchronize()
        print(f"m{m}n8k{k}: launch {err}, max |C - A B| "
              f"{float((C - A @ B).abs().max()):.3e}", flush=True)
        for threads in (128, 256):
            lib.probe_rate(sh, out.data_ptr(), 528, threads, 10)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            lib.probe_rate(sh, out.data_ptr(), 528, threads, 2000)
            ev[1].record()
            torch.cuda.synchronize()
            ms = ev[0].elapsed_time(ev[1])
            flop = 528 * (threads // 32) * 2000 * 8 * 2 * m * 8 * k
            print(f"  {threads} threads: {flop / ms / 1e9:.1f} TFLOP/s",
                  flush=True)


def _parse_trsm(arg: str):
    k, dtype, bs = (arg.split(":") + ["", ""])[:3]
    return int(k), dtype or "complex128", int(bs or 128)


if __name__ == "__main__":
    args = sys.argv[1:]
    if args[:1] == ["--mma"]:
        main_mma()
    elif args[:1] == ["--trsm"]:
        main_trsm(args[1], [_parse_trsm(a) for a in args[2:]]
                  or [(32, "complex128", 128)])
    else:
        main([_parse(a) for a in args]
             or [(32, "float32"), (50, "float32"), (32, "float64")])
