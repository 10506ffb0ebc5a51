"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):

1. the card's name and power limit (nvidia-smi), and the native host
   engine (g++), which must load;
2. build every CUDA kernel (one nvcc per source, in parallel) and print
   the build seconds and the ptxas resource lines;
3. the main path through the user entry point:
   ``gssvx(A, b, Options(dtype="float32", block_size=128))`` on
   ``laplacian_3d(32)`` (n = 32,768), with every launch count set to 0
   just before and read just after; berr <= 1e-12 and
   ||Ax - b||inf / ||b||inf <= 1e-10 are required and every kernel of
   the path must have been launched; a second, warm call is timed the
   same way, and one refinement is profiled (device busy and idle share);
4. every clk-path kernel against its plain PyTorch version on the card,
   level by level on the main path's own inputs (both get the same input;
   the run goes on with the kernel's output), timed with CUDA events;
   then the whole clk factor against the independent right-looking
   float64 reference ``blocklu.factor_plain``;
5. the other factor executors on the same matrix, each driven and
   checked like the main path: ``executor="flk"`` (flk and diag_lu, no
   clk_update), ILU(1) (flk; its slots and refinement steps printed) and
   ``executor="pallas"`` (diag_lu, trsm, schur), ILU(1)'s two calls held
   to bit-equal x and equal refinement steps; then flk, schur and trsm
   against their plain versions level by level on their paths' inputs,
   and each whole factor against ``factor_plain`` on its plan; then
   ``executor="tck"`` on the same matrix (tck_update, diag_lu, clk_trsm),
   driven the same way, with tck_update against its plain version beside
   clk_update's time; and ``SparseLU.profile_levels`` on the level
   executor's factor (its six costliest levels), with the solve checked
   after it;
6. the transposed path on ``lap3d32u`` (``laplacian_3d(32)`` with
   unsymmetric off-diagonal values, the same plan):
   ``gssvx(A, b, Options(dtype="float32", block_size=128,
   trans=Trans.TRANS, condition_number=True))``, driven and checked like
   the main path in Aᵀ (solve_gemm and diag_apply must launch, rcond must
   lie in (0, 1], two transposed solves of one b must be bit-equal); then
   the reuse modes on perturbed values (SamePattern_SameRowPerm,
   SamePattern, FACTORED), each held to the same limits with the phases
   and launches that its mode implies; then the fused ``solve_level``
   (pass 1, solve_gemm, over chunks of the chains; pass 2, diag_apply,
   per row) against ``solve_level_plain`` level by level on the
   transposed tapes, each pass timed beside its library call, with the
   costliest levels' chunks and CTAs; the pair against the library pair
   at 32 right-hand sides; and the pair with ``transpose=False`` on the
   main path's L and U tapes beside the sweep (printed); and at block
   size 64 on ``laplacian_3d_unsym(16)``: x against scipy's
   ``spsolve(A.T, b)``, rcond against the dense 1-norm truth, ``logdet``
   against the plain CPU factor and ``numpy.linalg.slogdet``, and a
   ``save_factors`` / ``load_factors`` round trip;
7. the same checks at the Options default block size 64 on
   ``laplacian_3d(16)``, whose solution (by each executor, ``"tck"`` and
   ``"xla"`` included) is held against scipy's;
8. the tiled column factor at full width:
   ``gssvx(A, b, Options(dtype="float32", block_size=128,
   executor="tck"))`` on ``laplacian_3d(50)`` (n = 125,000, the matrix
   with many columns taller than the TPU clk's 104-block panel), driven
   like the main path (tck_update, diag_lu, clk_trsm and sweep must
   launch, clk_update, flk and schur must not), a warm call,
   ``tck_update`` against its plain version level by level and the
   whole factor against the float64 reference; the solve_level pair with
   ``transpose=False`` beside the sweep on its L and U tapes (printed);
   then clk, flk and the level executor on the same plan
   (SamePattern_SameRowPerm refactors), each held to the same limits,
   with clk_update's costliest levels;
9. float64 on the card, which runs the level executor:
   ``Options(dtype="float64", block_size=128)`` on lap3d32, and TRANS +
   ``condition_number`` on lap3d32u, each held to the same limits; every
   float64 kernel (diag_lu, trsm, schur, sweep, solve_gemm, diag_apply)
   against its plain version, each bound taken at the FP64 peak;
10. the 2D block-cyclic driver with every rank of a 2x2 grid on the card:
   ``gssvx_dist(A, b, Grid2D(2, 2), Options(dtype="float32",
   block_size=128, dist_executor="rdma"))`` on lap3d32, driven like the
   main path (every entry of rdma_factor and rdma_solve must launch, no
   single-device factor, sweep or solve kernel may), the receive counters
   against the TPU's receive tapes, a warm call beside the level
   executor's FACT, each entry against its plain version level by level
   on the path's inputs, the gathered factor against the float64
   reference, the warm call's x and refinement steps equal to the first
   call's; ``dist_executor="xla"``, which runs the same entries; and at
   block size 64 on lap3d16 the grids 2x2, 1x4, 4x1 and 2x4, x against
   scipy's;
11. one JSON line of per-kernel results (the float64 instantiations in
   rows of their own, with a ``dtype`` field; the RDMA rows with their
   launches per entry), the nvidia-smi line, the seconds the run held the
   card, and the final ``{"ok": true, "device": ...}`` line.

Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np

#: the best IEEE rate of an H100 SXM for each type and its memory rate
#: (NVIDIA data sheet): FP32 67 TFLOP/s on the CUDA cores (TF32 is not
#: FP32); FP64 67 TFLOP/s on the tensor cores (DMMA), twice the CUDA
#: cores' 34
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}
PEAK_BYTES = 3.35e12
#: kernel against plain version: max |difference| <= REL_TOL * max(1,
#: max |plain output|). Both compute in float32 from the same input but
#: sum in other orders (128-long dot products, a 128-step elimination
#: whose inverses carry the tile's conditioning); 1e-4 is ~840 float32
#: ulp, while a wrong block or index gives errors of order 1. The float64
#: instantiations are held to REL_TOL_F64, ~4,500 float64 ulp.
REL_TOL = 1e-4
REL_TOL_F64 = 1e-12
#: a whole factor against the float64 right-looking reference: 512
#: float32 ulp at the pool scale, the tolerance tests/test_clk.py gives
#: random patterns (the top separator blocks of lap3d32 sum hundreds of
#: products)
FACTOR_ULPS = 512

#: the TPU kernel each port kernel replaces (file:line of its body)
REPLACES = {
    "diag_lu": "superlu_dist_tpu/ops/kernels/flk.py:339",
    "clk_update": "superlu_dist_tpu/ops/kernels/clk.py:248",
    "clk_trsm": "superlu_dist_tpu/ops/kernels/clk.py:248",
    "sweep": "superlu_dist_tpu/ops/kernels/pallas_exec.py:680",
    "flk": "superlu_dist_tpu/ops/kernels/flk.py:434",
    # _schur_kernel_db (on the executor's path) and _schur_kernel compute
    # the same function; one CUDA kernel stands for both
    "schur": "superlu_dist_tpu/ops/kernels/pallas_exec.py:942",
    "trsm": "superlu_dist_tpu/ops/kernels/pallas_exec.py:93",
    "solve_gemm": "superlu_dist_tpu/ops/kernels/pallas_exec.py:433",
    "diag_apply": "superlu_dist_tpu/ops/kernels/pallas_exec.py:513",
    "tck_update": "superlu_dist_tpu/ops/kernels/tck.py:220",
    "rdma_factor": "superlu_dist_tpu/parallel/dist2d_rdma.py:120",
    "rdma_solve": "superlu_dist_tpu/parallel/dist2d_rdma.py:534",
}
ALSO_REPLACES = {"schur": "superlu_dist_tpu/ops/kernels/pallas_exec.py:52"}
#: the kernels with a float64 instantiation, which the float64 path runs
F64_KERNELS = ("diag_lu", "trsm", "schur", "sweep", "solve_gemm",
               "diag_apply")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def main() -> None:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import scipy.sparse.linalg as spla

    from superlu_dist_tpu_torch import Options
    from superlu_dist_tpu_torch.ops import blocklu
    from superlu_dist_tpu_torch.ops.host.native import get_lib
    from superlu_dist_tpu_torch.ops.kernels import (_build, clk, diag_lu, flk,
                                                    schur, solve_gemm, sweep,
                                                    tck)
    from superlu_dist_tpu_torch.parallel import dist2d_rdma as rdma
    from superlu_dist_tpu_torch.utils.testing import laplacian_3d

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    if get_lib() is None:
        fail("the native host engine did not load")
    print("native host engine: loaded", flush=True)

    kernels = {"diag_lu": diag_lu.KERNEL, "clk_update": clk.UPDATE,
               "clk_trsm": clk.TRSM, "sweep": sweep.KERNEL,
               "flk": flk.KERNEL, "schur": schur.SCHUR, "trsm": schur.TRSM,
               "solve_gemm": solve_gemm.SOLVE_GEMM,
               "diag_apply": solve_gemm.DIAG_APPLY,
               "tck_update": tck.UPDATE, "rdma_factor": rdma.RDMA_FACTOR,
               "rdma_solve": rdma.RDMA_SOLVE}
    build_s = _build.build_all(list(kernels.values()))
    print(f"kernels built in {build_s:.1f} s", flush=True)
    for k in (diag_lu.KERNEL, clk.UPDATE, sweep.KERNEL, flk.KERNEL,
              schur.SCHUR, solve_gemm.SOLVE_GEMM, tck.UPDATE,
              rdma.RDMA_FACTOR):
        print(f"ptxas {k.source}:\n{_build.ptxas_report(k)}", end="")
    ctx = dict(torch=torch, blocklu=blocklu, clk=clk, diag_lu=diag_lu,
               flk=flk, schur=schur, sweep=sweep, solve_gemm=solve_gemm,
               tck=tck, rdma=rdma, kernels=kernels, entry_launches={})

    # ---- 3. the main path ---------------------------------------------
    A = laplacian_3d(32)
    n = A.shape[0]
    rng = np.random.default_rng(0)
    b = np.asarray(A @ rng.standard_normal(n))
    opts = Options(dtype="float32", block_size=128)
    res, lu, launches = drive(ctx, "main path", A, b, opts,
                              ("diag_lu", "clk_update", "clk_trsm", "sweep"))
    plan = lu.plan
    print(f"main path: lap3d32 n={n} aligned to {plan.n} rows, "
          f"{plan.nb} block columns, {plan.nslots} slots, pool "
          f"{plan.pool_bytes(np.float32) / 2**20:.0f} MiB, "
          f"{plan.n_flevels} factor levels, {plan.lsol_nlvl}+"
          f"{plan.usol_nlvl} solve levels, {len(plan.g_l)} Schur triples, "
          f"{plan.factor_flops / 1e9:.1f} GFLOP (padded block model)")
    warm_call(ctx, "main path", A, b, opts)
    profile_refine(torch, lu, b, res.x)

    # ---- 4. clk-path kernels against plain versions --------------------
    checks = check_kernels(lu, ctx, launches)

    # ---- 5. the flk, ILU(1), level and tck executors -------------------
    paths = {
        "flk": (Options(dtype="float32", block_size=128, executor="flk"),
                ("flk", "diag_lu", "sweep"), ("clk_update",)),
        "ilu1": (Options(dtype="float32", block_size=128, ilu_level=1,
                         max_refine_steps=60, refine_rthresh=1.0),
                 ("flk", "diag_lu", "sweep"), ("clk_update",)),
        "pallas": (Options(dtype="float32", block_size=128,
                           executor="pallas"),
                   ("schur", "trsm", "diag_lu", "sweep"),
                   ("clk_update", "flk")),
        "tck": (Options(dtype="float32", block_size=128, executor="tck"),
                ("tck_update", "diag_lu", "clk_trsm", "sweep"),
                ("clk_update", "flk", "schur")),
    }
    lus, got = {}, {}
    for name, (o, need, zero) in paths.items():
        r, lus[name], got[name] = drive(ctx, name, A, b, o, need, zero)
        print(f"{name}: {lus[name].plan.nslots} slots, {r.stat.refine_steps}"
              f" refinement steps, executor {r.stat.counters['executor']}",
              flush=True)
        r2 = warm_call(ctx, name, A, b, o)
        if name == "pallas":
            ctx["level_fact_ms"] = r2.stat.device_ms["FACT"]
        if name == "ilu1":
            check_repeat("ILU(1) lap3d32", r, r2)
    # each new kernel's launches come from the path that it serves
    launches["flk"] = got["flk"]["flk"]
    launches["schur"] = got["pallas"]["schur"]
    launches["trsm"] = got["pallas"]["trsm"]
    checks.update(check_flk(lus["flk"], ctx, report=True))
    o = check_flk(lus["ilu1"], ctx, report=False)["flk"]
    print(f"ILU(1) flk: max_abs_err {o['max_abs_err']:.3e} (tolerance "
          f"{o['tol']:.3e}), {got['ilu1']['flk']} launches on its path",
          flush=True)
    checks.update(check_level(lus["pallas"], ctx, report=True))
    for name in ("flk", "schur", "trsm"):
        print_check(name, checks[name], launches[name])
    o = check_tck(lus["tck"], ctx, report=False)["tck_update"]
    print(f"lap3d32 tck_update: max_abs_err {o['max_abs_err']:.3e} "
          f"(tolerance {o['tol']:.3e}); kernel {o['ms']:.3f} ms, plain "
          f"{o['plain_ms']:.3f} ms, bound {o['bound_ms']:.4f} ms "
          f"({o['bound_by']}); clk_update on the same plan "
          f"{checks['clk_update']['ms']:.3f} ms; {got['tck']['tck_update']}"
          f" launches on its path", flush=True)
    profile_phase(lus["pallas"], A, b)

    # ---- 6. the transposed path, the condition estimate, reuse ---------
    got = trans_phase(ctx, rng, lu, checks)
    launches["solve_gemm"] = got["solve_gemm"]
    launches["diag_apply"] = got["diag_apply"]
    for name in ("solve_gemm", "diag_apply"):
        print_check(name, checks[name], launches[name])

    # ---- 7. the Options default block size ----------------------------
    A2 = laplacian_3d(16)
    b2 = np.asarray(A2 @ rng.standard_normal(A2.shape[0]))
    x_ref = spla.spsolve(A2.tocsc(), b2)
    for executor in ("clk", "flk", "pallas", "tck", "xla"):
        res2, lu2, _ = drive(ctx, f"bs=64 {executor}", A2, b2, Options(
            dtype="float32", block_size=64, executor=executor), ())
        err2 = float(np.abs(res2.x - x_ref).max() / np.abs(x_ref).max())
        print(f"bs=64 {executor}: lap3d16 |x - scipy|/|x| {err2:.3e} "
              f"(tolerance 1e-10)", flush=True)
        if err2 > 1e-10:
            fail(f"bs=64 {executor} solution disagrees with scipy")
        c64 = {"clk": check_kernels, "flk": check_flk, "pallas": check_level,
               "tck": check_tck, "xla": check_level}[executor](lu2, ctx,
                                                                None)
        for name, c in c64.items():
            print(f"bs=64 {name}: max_abs_err {c['max_abs_err']:.3e} "
                  f"(tolerance {c['tol']:.3e})", flush=True)

    # ---- 8. tck at full width on lap3d50 -------------------------------
    tck_phase(ctx, rng, checks, launches)

    # ---- 9. float64 on the card ---------------------------------------
    f64_phase(ctx, rng, checks, launches)

    # ---- 10. the 2D grid on one card -----------------------------------
    dist_phase(ctx, rng, checks, launches)

    rows = []
    for name, dtype in [(k, "float32") for k in kernels] + \
            [(k, "float64") for k in F64_KERNELS]:
        key = name if dtype == "float32" else f"{name}_f64"
        c = checks[key]
        row = dict(
            name=key, route="cuda",
            source=("superlu_dist_tpu_torch/ops/kernels/csrc/"
                    f"{kernels[name].source}"),
            replaces=REPLACES[name], launches=launches[key],
            max_abs_err=c["max_abs_err"], ms=c["ms"],
            plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
            bound_by=c["bound_by"], library_ms=c["library_ms"],
            per=c["per"], dtype=dtype)
        if name in ctx["entry_launches"]:
            row["entry_launches"] = ctx["entry_launches"][name]
        if name in ALSO_REPLACES:
            row["also_replaces"] = ALSO_REPLACES[name]
        rows.append(row)
    print(json.dumps({"kernels": rows}))
    print(f"smoke held the card {time.perf_counter() - t_start:.1f} s")
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def drive(ctx, what, A, b, opts, need, zero=(), lu=None, grid=None):
    """One ``gssvx`` call (``gssvx_dist`` over ``grid``) with every launch
    count set to 0 just before and read just after; checks the accuracy
    limits (in Aᵀ under ``opts.trans``), that every kernel of ``need``
    launched and that none of ``zero`` did. ``lu`` is passed on for the
    reuse modes."""
    from superlu_dist_tpu_torch import Trans, gssvx, gssvx_dist
    torch = ctx["torch"]
    for k in ctx["kernels"].values():
        k.reset_counts()
    t0 = time.perf_counter()
    if grid is None:
        res, lu = gssvx(A, b, opts, lu=lu)
    else:
        res, lu = gssvx_dist(A, b, grid, opts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in ctx["kernels"].items()}
    op, tag = (A.T, "A^T") if opts.trans != Trans.NOTRANS else (A, "A")
    resid = float(np.abs(op @ res.x - b).max() / np.abs(b).max())
    berr = float(np.max(res.berr))
    print_phases(what, wall, res.stat)
    print(f"{what}: berr {berr:.3e}, ||{tag}x-b||/||b|| {resid:.3e}, tiny "
          f"pivots {res.stat.tiny_pivots}, launches {launches}", flush=True)
    if not np.all(np.isfinite(res.x)) or res.x.shape != (A.shape[0],):
        fail(f"{what}: solution not finite or of the wrong shape")
    if berr > 1e-12 or resid > 1e-10:
        fail(f"{what} accuracy: berr {berr:.3e} (<= 1e-12), residual "
             f"{resid:.3e} (<= 1e-10)")
    for name in need:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the {what} path")
    for name in zero:
        if launches[name] != 0:
            fail(f"kernel {name} was launched on the {what} path")
    return res, lu, launches


def warm_call(ctx, what, A, b, opts, grid=None):
    """The same call again, with kernels loaded and allocator warm: the
    first call's phases also hold one-time module loads. Returns its
    result."""
    from superlu_dist_tpu_torch import gssvx, gssvx_dist
    t0 = time.perf_counter()
    res, _ = gssvx(A, b, opts) if grid is None else gssvx_dist(A, b, grid,
                                                               opts)
    ctx["torch"].cuda.synchronize()
    print_phases(f"{what}, second call", time.perf_counter() - t0, res.stat)
    if float(np.max(res.berr)) > 1e-12:
        fail(f"{what} second call: berr {np.max(res.berr):.3e} > 1e-12")
    return res


def check_repeat(what, first, second):
    """Two calls of one system give bit-equal x and the same refinement
    steps (every sum of the path has a fixed order on the card)."""
    same = np.array_equal(first.x, second.x)
    steps = (first.stat.refine_steps, second.stat.refine_steps)
    print(f"{what}: two calls bit-equal x {same}, refinement steps "
          f"{steps[0]} / {steps[1]}", flush=True)
    if not same or steps[0] != steps[1]:
        fail(f"{what}: two calls of the same system differ")


def print_phases(what, wall, st):
    """A gssvx call's wall seconds, its phases' CUDA-event ms (the stream's
    elapsed time, host gaps included; SOLVE also counts the solves inside
    RCOND) and its host seconds per phase."""
    rc = (f", rcond {st.device_ms['RCOND']:.3f}" if "RCOND" in st.device_ms
          else "")
    print(f"{what}: gssvx wall {wall:.2f} s; device ms: factor "
          f"{st.device_ms['FACT']:.3f}, solve {st.device_ms['SOLVE']:.3f}, "
          f"refine {st.device_ms['REFINE']:.3f} ({st.refine_steps} steps)"
          f"{rc}; host s: " + ", ".join(f"{k} {v:.3f}"
                                        for k, v in sorted(st.utime.items())),
          flush=True)


def profile_refine(torch, lu, b, x):
    """Where the time of one refinement goes: ``torch.profiler`` over a
    refine call from the f32 solution (one SpMV residual, one L+U solve
    per step), summed by device kernel; the device's idle share is 1 -
    busy / wall."""
    from torch.profiler import ProfilerActivity, profile
    x0 = lu.solve(b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        lu.refine(b, x0)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # device kernels and copies only: a CPU operator carries the device
    # time of the kernels it launched, and the ``slu:`` phase spans show a
    # device range, so either would count the same time twice
    rows = [e for e in prof.key_averages()
            if e.device_type != torch.autograd.DeviceType.CPU
            and e.self_device_time_total > 0
            and not e.key.startswith("slu:")]
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"profile of one refine ({lu.stat.refine_steps} steps): wall "
          f"{wall:.3f} ms, device busy {busy:.3f} ms, idle share "
          f"{max(0.0, 1 - busy / wall):.3f}")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x {e.key[:90]}")


#: device buffer written before each timed call, five times the H100's
#: 50 MB L2, so that no call finds its inputs left in L2 by the one before
#: (the library call of a level reads the same blocks as its kernel)
_FLUSH = []
FLUSH_BYTES = 256 << 20


def _timed(torch, fn):
    """Device ms of ``fn`` by CUDA events, with L2 flushed before."""
    if not _FLUSH:
        _FLUSH.append(torch.empty(FLUSH_BYTES, dtype=torch.uint8,
                                  device="cuda"))
    _FLUSH[0].zero_()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    fn()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1])


class Checker:
    """Kernel-against-plain comparisons of one factor (or solve): per
    kernel the max abs error, its tolerance and the summed kernel and
    plain ms."""

    def __init__(self, torch, bs, names, library=()):
        self.torch = torch
        self.bs = bs
        self.out = {k: dict(max_abs_err=0.0, tol=0.0, ms=0.0, plain_ms=0.0,
                            library_ms=0.0 if k in library else None)
                    for k in names}

    def compare(self, name, kern, plain, state):
        """Run kernel and plain on copies of ``state``; keep the kernel's
        copy. Returns it and the kernel's ms."""
        torch = self.torch
        a = [t.clone() for t in state]
        p = [t.clone() for t in state]
        ms = _timed(torch, lambda: kern(*a))
        self.record(name, ms, _timed(torch, lambda: plain(*p)), a, p)
        return a, ms

    def record(self, name, ms, plain_ms, got, want):
        """Add a kernel's and its plain version's ms to ``name`` and hold
        the kernel's outputs ``got`` to the plain ones ``want``."""
        o = self.out[name]
        o["ms"] += ms
        o["plain_ms"] += plain_ms
        err = max(float((x - y).abs().max()) for x, y in zip(got, want))
        scale = max(1.0, max(float(y.abs().max()) for y in want))
        dtype = want[0].dtype
        rel = REL_TOL_F64 if dtype == self.torch.float64 else REL_TOL
        o["max_abs_err"] = max(o["max_abs_err"], err)
        o["tol"] = max(o["tol"], rel * scale)
        if err > rel * scale:
            fail(f"{name} (bs={self.bs}, {dtype}) disagrees with its "
                 f"plain version: {err:.3e} > {rel * scale:.3e}")

    def library(self, name, fn):
        """One untimed call first: the kernels ran warm on their path, so
        cuBLAS's first call at a shape is left out too."""
        fn()
        self.out[name]["library_ms"] += _timed(self.torch, fn)


def _state(lu, torch, blocklu):
    plan, dev = lu.plan, lu.device
    bs, nb = plan.bs, plan.nb
    pool = blocklu.init_pool(plan, lu._a3_data, lu.dtype, dev)
    linv = torch.zeros((nb, bs, bs), dtype=pool.dtype, device=dev)
    uinv = torch.zeros_like(linv)
    tiny = torch.zeros(1, dtype=torch.int32, device=dev)
    return pool, linv, uinv, tiny


def check_whole_factor(what, lu, ctx, pool, tiny):
    """A whole factor against the float64 right-looking reference on its
    plan."""
    blocklu = ctx["blocklu"]
    plan = lu.plan
    ref, _, _, _ = blocklu.factor_plain(
        plan, blocklu.init_pool(plan, lu._a3_data, np.float64, lu.device),
        lu._thresh())
    ns = plan.nslots
    scale = max(1.0, float(ref[:ns].abs().max()))
    ferr = float((pool[:ns].double() - ref[:ns]).abs().max())
    ftol = FACTOR_ULPS * float(np.finfo(lu.dtype).eps) * scale
    print(f"bs={plan.bs}: {what} factor vs float64 right-looking reference:"
          f" max abs err {ferr:.3e} (tolerance {ftol:.3e}); tiny pivots "
          f"{int(tiny.item())}", flush=True)
    if ferr > ftol:
        fail(f"{what} factor disagrees with the float64 reference")


def print_check(name, o, launches):
    lib = "none" if o["library_ms"] is None else f"{o['library_ms']:.3f} ms"
    print(f"{name}: max_abs_err {o['max_abs_err']:.3e} (tolerance "
          f"{o['tol']:.3e}); kernel {o['ms']:.3f} ms, plain "
          f"{o['plain_ms']:.3f} ms, library {lib}, bound "
          f"{o['bound_ms']:.4f} ms ({o['bound_by']}) per {o['per']}; "
          f"{launches} launches on its path", flush=True)


def check_kernels(lu, ctx, launches, levels=False):
    """Each clk-path kernel against its plain version on ``lu``'s plan,
    level by level: both get the same input and the factor goes on with
    the kernel's output. Returns per kernel the max abs error, its
    tolerance, the summed kernel and plain ms of one factor (one L+U solve
    for the sweep) and the bound of that work. With ``launches`` (or
    ``levels``) it prints clk_update's costliest levels."""
    torch, clk, diag_lu, sweep = (ctx[k] for k in
                                  ("torch", "clk", "diag_lu", "sweep"))
    plan, tp, dev = lu.plan, lu._ftapes, lu.device
    bs, nb = plan.bs, plan.nb
    th = lu._thresh()
    pool, linv, uinv, tiny = _state(lu, torch, ctx["blocklu"])
    # library_ms: clk_trsm is a batched product per level, timed as one
    # torch.bmm on the level's gathered L blocks and U inverses. No one
    # PyTorch call computes diag_lu (no-pivot LU with both inverses and
    # tiny-pivot replacement), clk_update (a chain of dependent products
    # per column) or the sweep (a level of a block-sparse triangular
    # solve), so theirs stays None.
    ck = Checker(torch, bs, ("diag_lu", "clk_update", "clk_trsm", "sweep"),
                 library=("clk_trsm",))

    per_level = []
    for lvl in range(tp.nlvl):
        (pool,), ms = ck.compare(
            "clk_update", lambda p: clk.clk_update(p, linv, tp, lvl),
            lambda p: clk.clk_update_plain(p, linv, tp, lvl), [pool])
        per_level.append((ms, lvl))
        lo, hi = int(tp.dptr[lvl]), int(tp.dptr[lvl + 1])
        ds, dk = tp.dslot[lo:hi], tp.dstep[lo:hi]
        (pool, linv, uinv, tiny), _ = ck.compare(
            "diag_lu",
            lambda p, li, ui, t: diag_lu.diag_lu(p, li, ui, ds, dk, th, t),
            lambda p, li, ui, t: diag_lu.diag_lu_plain(
                p, li, ui, ds.long(), dk.long(), th, t),
            [pool, linv, uinv, tiny])
        lo, hi = int(tp.lptr[lvl]), int(tp.lptr[lvl + 1])
        if hi > lo:
            Lg = pool[tp.lslot[lo:hi].long()]
            Ug = uinv[tp.lstep[lo:hi].long()]
            C = torch.empty_like(Lg)
            ck.library("clk_trsm", lambda: torch.bmm(Lg, Ug, out=C))
            del Lg, Ug, C
        (pool,), _ = ck.compare(
            "clk_trsm", lambda p: clk.clk_trsm(p, uinv, tp, lvl),
            lambda p: clk.clk_trsm_plain(p, uinv, tp, lvl), [pool])
    if levels or launches is not None:
        print_update_levels(tp, per_level)
    check_whole_factor("clk", lu, ctx, pool, tiny)
    check_sweep(lu, ctx, ck)

    out = ck.out
    bounds = work_bounds(plan, tp, lu)
    for name, o in out.items():
        o.update(bounds[name])
        if launches is not None:
            print_check(name, o, launches[name])
    return out


def check_sweep(lu, ctx, ck):
    """The sweep against its plain version over one L+U solve of a
    right-hand side, level by level, into ``ck``'s "sweep" entry."""
    torch, sweep = ctx["torch"], ctx["sweep"]
    plan = lu.plan
    rng = np.random.default_rng(1)
    X = torch.as_tensor(rng.standard_normal((plan.nb, plan.bs, 1)),
                        dtype=lu.pool.dtype, device=lu.device)
    for tape, dinv in ((lu._ltape, lu.linv), (lu._utape, lu.uinv)):
        for lvl in range(tape.nlvl):
            (X,), _ = ck.compare(
                "sweep", lambda x: sweep.sweep_level(lu.pool, dinv, x, tape,
                                                     lvl),
                lambda x: sweep.sweep_level_plain(lu.pool, dinv, x, tape,
                                                  lvl), [X])


def check_tck(lu, ctx, report):
    """tck_update against its plain version on ``lu``'s tck plan, level by
    level (diag_lu and clk_trsm run as kernels after it), then the whole
    factor against the float64 reference. No one PyTorch call computes
    tck_update (per column a chain of dependent products), so its
    library_ms stays None. It computes clk_update's function, so its
    bound is clk_update's on the same plan."""
    torch, tck, clk, diag_lu = (ctx[k] for k in ("torch", "tck", "clk",
                                                 "diag_lu"))
    plan, tp = lu.plan, lu._ftapes
    th = lu._thresh()
    pool, linv, uinv, tiny = _state(lu, torch, ctx["blocklu"])
    ck = Checker(torch, plan.bs, ("tck_update",))
    per_level = []
    for lvl in range(tp.nlvl):
        (pool,), ms = ck.compare(
            "tck_update", lambda p: tck.tck_update(p, linv, tp, lvl),
            lambda p: tck.tck_update_plain(p, linv, tp, lvl), [pool])
        per_level.append((ms, lvl))
        lo, hi = int(tp.dptr[lvl]), int(tp.dptr[lvl + 1])
        diag_lu.diag_lu(pool, linv, uinv, tp.dslot[lo:hi], tp.dstep[lo:hi],
                        th, tiny)
        clk.clk_trsm(pool, uinv, tp, lvl)
    if report:
        print_tck_levels(tp, per_level)
    check_whole_factor("tck", lu, ctx, pool, tiny)
    ck.out["tck_update"].update(update_bound(
        plan, clk.build_clk_tapes(plan, "cpu"), lu.dtype))
    return ck.out


def check_flk(lu, ctx, report):
    """flk_update against its plain version on ``lu``'s flk plan, level by
    level (diag_lu runs as the kernel between the two groups). No one
    PyTorch call computes flk (per target a chain of products, then a
    product by a stored inverse), so its library_ms stays None."""
    torch, flk, diag_lu = ctx["torch"], ctx["flk"], ctx["diag_lu"]
    plan, tp = lu.plan, lu._ftapes
    th = lu._thresh()
    pool, linv, uinv, tiny = _state(lu, torch, ctx["blocklu"])
    ck = Checker(torch, plan.bs, ("flk",))
    per_group = []
    for lvl in range(tp.nlvl):
        for g in (2 * lvl, 2 * lvl + 1):
            (pool,), ms = ck.compare(
                "flk", lambda p: flk.flk_update(p, linv, uinv, tp, g),
                lambda p: flk.flk_update_plain(p, linv, uinv, tp, g), [pool])
            per_group.append((ms, g))
            if g == 2 * lvl:
                lo, hi = int(tp.dptr[lvl]), int(tp.dptr[lvl + 1])
                diag_lu.diag_lu(pool, linv, uinv, tp.dslot[lo:hi],
                                tp.dstep[lo:hi], th, tiny)
    what = "ILU(1) flk" if lu.options.ilu_level is not None else "flk"
    if report:
        print_flk_groups(tp, per_group)
    check_whole_factor(what, lu, ctx, pool, tiny)
    ck.out["flk"].update(flk_bounds(plan, tp, flk))
    return ck.out


def check_level(lu, ctx, report, full=False):
    """trsm (both flags) and schur against their plain versions on
    ``lu``'s plan, level by level (diag_lu runs as the kernel; with
    ``full`` it is compared too, and so is the sweep over one L+U solve).
    library_ms: trsm is a batched product, timed as one torch.bmm per
    panel list per level on the gathered panels and inverses; no one
    PyTorch call computes schur (per target a sum of products of gathered
    blocks; an ``index_add_`` of batched products is two calls and a
    temporary of every product), so its library_ms stays None."""
    torch, schur, diag_lu = ctx["torch"], ctx["schur"], ctx["diag_lu"]
    plan, tp = lu.plan, lu._ftapes
    th = lu._thresh()
    pool, linv, uinv, tiny = _state(lu, torch, ctx["blocklu"])
    ck = Checker(torch, plan.bs, ("schur", "trsm") + (
        ("diag_lu", "sweep") if full else ()), library=("trsm",))
    per_level = []
    for lvl in range(tp.nlvl):
        d = slice(int(tp.dptr[lvl]), int(tp.dptr[lvl + 1]))
        ds, dk = tp.dslot[d], tp.dstep[d]
        if full:
            (pool, linv, uinv, tiny), _ = ck.compare(
                "diag_lu",
                lambda p, li, ui, t: diag_lu.diag_lu(p, li, ui, ds, dk, th,
                                                     t),
                lambda p, li, ui, t: diag_lu.diag_lu_plain(
                    p, li, ui, ds.long(), dk.long(), th, t),
                [pool, linv, uinv, tiny])
        else:
            diag_lu.diag_lu(pool, linv, uinv, ds, dk, th, tiny)
        for left, dinv, sl, st, ptr in (
                (False, uinv, tp.lslot, tp.lstep, tp.lptr),
                (True, linv, tp.uslot, tp.ustep, tp.uptr)):
            s = slice(int(ptr[lvl]), int(ptr[lvl + 1]))
            if s.stop > s.start:
                Xg, Dg = pool[sl[s].long()], dinv[st[s].long()]
                C = torch.empty_like(Xg)
                ck.library("trsm", (lambda: torch.bmm(Dg, Xg, out=C)) if left
                           else (lambda: torch.bmm(Xg, Dg, out=C)))
                del Xg, Dg, C
            (pool,), _ = ck.compare(
                "trsm", lambda p: schur.trsm(p, dinv, sl[s], st[s], left),
                lambda p: schur.trsm_plain(p, dinv, sl[s], st[s], left),
                [pool])
        (pool,), ms = ck.compare(
            "schur", lambda p: schur.schur(p, tp, lvl),
            lambda p: schur.schur_plain(p, tp, lvl), [pool])
        per_level.append((ms, lvl))
    if report:
        print_schur_levels(tp, per_level)
    check_whole_factor("level executor", lu, ctx, pool, tiny)
    b = level_bounds(plan, tp, lu.dtype)
    if full:
        check_sweep(lu, ctx, ck)
        b.update(diag_bound(plan, lu.dtype), sweep=sweep_bound(plan, lu))
    for name, o in ck.out.items():
        o.update(b[name])
    return ck.out


def trans_phase(ctx, rng, lu_main, checks):
    """Phase 6: the TRANS + condition_number path on lap3d32u, the reuse
    modes, solve_gemm and diag_apply against their plain versions, and
    the block size 64 checks. Adds the two kernels to ``checks``; returns
    the launches of the TRANS call."""
    from superlu_dist_tpu_torch import Fact, Options, Trans
    from superlu_dist_tpu_torch.utils.testing import laplacian_3d_unsym
    A = laplacian_3d_unsym(32)
    n = A.shape[0]
    b = rng.standard_normal(n)
    opts = Options(dtype="float32", block_size=128, trans=Trans.TRANS,
                   condition_number=True)
    res, lu, got = drive(ctx, "trans", A, b, opts, (
        "solve_gemm", "diag_apply", "diag_lu", "clk_update", "clk_trsm",
        "sweep"))
    st = res.stat
    if res.rcond is None or not 0 < res.rcond <= 1 or "RCOND" not in \
            st.utime:
        fail(f"trans: rcond {res.rcond} not in (0, 1] or no RCOND phase")
    print(f"trans: rcond {res.rcond:.6e} after {st.counters['rcond_iters']}"
          f" Hager steps (converged {st.counters['rcond_converged']}), "
          f"{st.refine_steps} refinement steps; lap3d32u {lu.plan.nslots} "
          f"slots (main path {lu_main.plan.nslots})", flush=True)
    for name, tape in zip(("U^T", "L^T"), lu._ttapes):
        chain = np.diff(tape.host["rowptr"])
        print(f"{name} sweep: {tape.nlvl} levels, {len(tape.host['cslot'])}"
              f" triples, longest destination chain {chain.max()}",
              flush=True)
    warm_call(ctx, "trans", A, b, opts)
    check_trans_repeat("trans", lu, b)

    # the reuse modes (pddrive1/2/3), on values perturbed from a seed
    pr = np.random.default_rng(7)

    def perturb(M):
        M = M.copy()
        M.data = M.data * (1.0 + 0.05 * pr.standard_normal(M.nnz))
        return M

    ropts = Options(dtype="float32", block_size=128, trans=Trans.TRANS)
    A2, plan0 = perturb(A), lu.plan
    r, lu, _ = drive(ctx, "SamePattern_SameRowPerm", A2, b, ropts.replace(
        fact=Fact.SAME_PATTERN_SAME_ROWPERM), ("clk_update", "diag_lu",
                                               "solve_gemm", "diag_apply"),
        lu=lu)
    if set(r.stat.utime) & {"EQUIL", "ROWPERM", "COLPERM"} \
            or lu.plan is not plan0:
        fail("SamePattern_SameRowPerm redid preprocessing or the plan")
    A3, colperm0 = perturb(A2), lu.colperm.copy()
    r, lu, _ = drive(ctx, "SamePattern", A3, b, ropts.replace(
        fact=Fact.SAME_PATTERN), ("clk_update", "diag_lu", "solve_gemm",
                                  "diag_apply"), lu=lu)
    if "ROWPERM" not in r.stat.utime or not np.array_equal(lu.colperm,
                                                          colperm0):
        fail("SamePattern skipped row matching or changed the column order")
    drive(ctx, "FACTORED", A3, rng.standard_normal(n), ropts.replace(
        fact=Fact.FACTORED), ("solve_gemm", "diag_apply"),
        ("clk_update", "diag_lu"), lu=lu)

    checks.update(check_solve(lu, ctx, lu_main))
    trans_bs64(ctx, rng)
    return got


def check_trans_repeat(what, lu, b):
    """Two transposed solves of one b give bit-equal x."""
    from superlu_dist_tpu_torch import Trans
    same = np.array_equal(lu.solve(b, trans=Trans.TRANS),
                          lu.solve(b, trans=Trans.TRANS))
    print(f"{what}: two transposed solves of one b bit-equal {same}",
          flush=True)
    if not same:
        fail(f"{what}: two transposed solves of one b differ")


def check_solve(lu, ctx, lu_main):
    """The transposed solve's kernels against their plain versions on
    ``lu``, level by level from the same X over one transposed solve (Uᵀ,
    then Lᵀ) of one right-hand side, the solve going on with the kernel's
    output: solve_level (pass 1 over the level's chunks, then the fused
    pass 2) against solve_level_plain; pass 1's time is solve_gemm's,
    pass 2's diag_apply's, and the plain versions are timed phase by
    phase. library_ms, each timed warm into a preallocated output:
    solve_gemm is X − M·X with M the level's block-sparse matrix of
    op(pool[slot]) at (dst, src), one ``torch.addmm`` of a BSR tensor
    (cuSPARSE), held against the plain solve_gemm's output too;
    diag_apply is a batched product per level, one ``torch.bmm`` on the
    gathered Dinv[I]ᵀ and X[I]. Returns these numbers; then prints the
    pair against the library pair at 32 right-hand sides, and the pair
    with ``transpose=False`` on ``lu_main``'s L and U tapes beside the
    sweep."""
    torch, sg = ctx["torch"], ctx["solve_gemm"]
    plan = lu.plan
    tu, tl = lu._ttapes
    tapes = ((tu, lu.uinv), (tl, lu.linv))
    ck = Checker(torch, plan.bs, ("solve_gemm", "diag_apply"),
                 library=("solve_gemm", "diag_apply"))
    rng = np.random.default_rng(2)
    X = torch.as_tensor(rng.standard_normal((plan.nb, plan.bs, 1)),
                        dtype=lu.pool.dtype, device=lu.device)
    per_level = []
    for name, (tape, dinv) in zip(("U^T", "L^T"), tapes):
        for lvl in range(tape.nlvl):
            M = level_bsr(torch, lu.pool, tape, lvl, True, plan.nb)
            if M is not None:
                X2 = X.view(-1, X.shape[2])
                C = torch.empty_like(X2)
                ck.library("solve_gemm", lambda: torch.addmm(
                    X2, M, X2, alpha=-1, out=C))
                ref = X.clone()
                sg.solve_gemm_plain(lu.pool, ref, tape, lvl, True)
                lerr = float((C.view_as(ref) - ref).abs().max())
                if lerr > REL_TOL * max(1.0, float(ref.abs().max())):
                    fail(f"solve_gemm's library call (BSR addmm) "
                         f"disagrees with the plain version: {lerr:.3e}")
                del M, X2, C, ref
            r = tape.rows[int(tape.dptr[lvl]):int(tape.dptr[lvl + 1])].long()
            Dg, Xg = dinv[r].mT, X[r]
            C = torch.empty_like(Xg)
            ck.library("diag_apply", lambda: torch.bmm(Dg, Xg, out=C))
            del Dg, Xg, C
            X, ms = compare_level(ck, sg, lu.pool, dinv, X, tape, lvl)
            per_level.append(ms + (name, lvl, tape))
    bounds = solve_bounds(plan, [t for t, _ in tapes], lu.dtype)
    for name, o in ck.out.items():
        o.update(bounds[name])
        print(f"bs={plan.bs} {lu.dtype} {name} transpose=True: "
              f"max_abs_err {o['max_abs_err']:.3e} (tolerance "
              f"{o['tol']:.3e}); kernel {o['ms']:.3f} ms, plain "
              f"{o['plain_ms']:.3f} ms, library {o['library_ms']:.3f} "
              f"ms per solve", flush=True)
    print_solve_levels(per_level)
    wide_pair(lu, ctx, 32)
    notrans_pair(lu_main, ctx)
    return ck.out


def compare_level(ck, sg, pool, dinv, X, tape, lvl):
    """One level of a transposed sweep: solve_chunks then solve_rows (the
    fused solve_level) and the two plain phases on copies of X, each timed
    alone; holds the kernels' X to the plain one and returns it with
    (pass 1 ms, pass 2 ms)."""
    torch = ck.torch
    a, p = X.clone(), X.clone()
    held = []
    ms1 = _timed(torch, lambda: held.append(
        sg.solve_chunks(pool, a, tape, lvl, True)))
    ms2 = _timed(torch, lambda: sg.solve_rows(dinv, a, held[0], tape, lvl,
                                              True))
    pm1 = _timed(torch, lambda: sg.solve_gemm_plain(pool, p, tape, lvl, True))
    pm2 = _timed(torch, lambda: sg.diag_apply_plain(dinv, p, tape, lvl,
                                                    True))
    ck.record("solve_gemm", ms1, pm1, [a], [p])
    ck.record("diag_apply", ms2, pm2, [a], [p])
    return a, (ms1, ms2)


def wide_pair(lu, ctx, nrhs):
    """One transposed solve of ``nrhs`` right-hand sides: the kernel pair
    (pass 1, pass 2) against the library pair (BSR addmm, bmm) level by
    level, each timed warm with L2 flushed (printed)."""
    torch, sg = ctx["torch"], ctx["solve_gemm"]
    plan = lu.plan
    X = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (plan.nb, plan.bs, nrhs)), dtype=lu.pool.dtype, device=lu.device)
    warm_solve(sg, lu.pool, zip(lu._ttapes, (lu.uinv, lu.linv)), X, True)
    t = dict(p1=0.0, p2=0.0, addmm=0.0, bmm=0.0)

    def lib(key, fn):
        fn()
        t[key] += _timed(torch, fn)

    for tape, dinv in zip(lu._ttapes, (lu.uinv, lu.linv)):
        for lvl in range(tape.nlvl):
            M = level_bsr(torch, lu.pool, tape, lvl, True, plan.nb)
            if M is not None:
                X2 = X.view(-1, nrhs)
                C = torch.empty_like(X2)
                lib("addmm", lambda: torch.addmm(X2, M, X2, alpha=-1, out=C))
                del M, X2, C
            r = tape.rows[int(tape.dptr[lvl]):int(tape.dptr[lvl + 1])].long()
            Dg, Xg = dinv[r].mT, X[r]
            C = torch.empty_like(Xg)
            lib("bmm", lambda: torch.bmm(Dg, Xg, out=C))
            del Dg, Xg, C
            held = []
            t["p1"] += _timed(torch, lambda: held.append(
                sg.solve_chunks(lu.pool, X, tape, lvl, True)))
            t["p2"] += _timed(torch, lambda: sg.solve_rows(
                dinv, X, held[0], tape, lvl, True))
    if not bool(torch.isfinite(X).all()):
        fail(f"the transposed solve at nrhs={nrhs} is not finite")
    print(f"bs={plan.bs} {lu.dtype} transposed solve at nrhs={nrhs}: kernel "
          f"pair {t['p1'] + t['p2']:.3f} ms (solve_gemm {t['p1']:.3f}, "
          f"diag_apply {t['p2']:.3f}), library pair "
          f"{t['addmm'] + t['bmm']:.3f} ms (BSR addmm {t['addmm']:.3f}, bmm "
          f"{t['bmm']:.3f}) per solve", flush=True)


def warm_solve(sg, pool, tapes, X, transpose):
    """One untimed solve_level sweep over ``tapes`` on a copy of X: the
    card loads a kernel on its first launch, which no timed call should
    hold."""
    W = X.clone()
    for tape, dinv in tapes:
        for lvl in range(tape.nlvl):
            sg.solve_level(pool, dinv, W, tape, lvl, transpose)


def notrans_pair(lu, ctx, what=""):
    """solve_level with ``transpose=False`` on ``lu``'s L and U tapes
    beside the sweep kernel that the NOTRANS solve runs, level by level
    from the same X over one L+U solve of one right-hand side, each timed
    alone with L2 flushed; the pair's output held to the sweep's
    (REL_TOL). Printed only."""
    torch, sg, sweep = ctx["torch"], ctx["solve_gemm"], ctx["sweep"]
    plan = lu.plan
    X = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (plan.nb, plan.bs, 1)), dtype=lu.pool.dtype, device=lu.device)
    warm_solve(sg, lu.pool, ((lu._ltape, lu.linv), (lu._utape, lu.uinv)), X,
               False)
    t = dict(p1=0.0, p2=0.0, sweep=0.0)
    err = 0.0
    for tape, dinv in ((lu._ltape, lu.linv), (lu._utape, lu.uinv)):
        for lvl in range(tape.nlvl):
            a, w = X.clone(), X.clone()
            held = []
            t["p1"] += _timed(torch, lambda: held.append(
                sg.solve_chunks(lu.pool, a, tape, lvl, False)))
            t["p2"] += _timed(torch, lambda: sg.solve_rows(
                dinv, a, held[0], tape, lvl, False))
            t["sweep"] += _timed(torch, lambda: sweep.sweep_level(
                lu.pool, dinv, w, tape, lvl))
            err = max(err, float((a - w).abs().max()))
            rel = REL_TOL_F64 if a.dtype == torch.float64 else REL_TOL
            if err > rel * max(1.0, float(w.abs().max())):
                fail(f"solve_level transpose=False disagrees with the "
                     f"sweep: {err:.3e}")
            X = a
    print(f"bs={plan.bs} {lu.dtype} {what}NOTRANS L+U solve: solve_level "
          f"pair {t['p1'] + t['p2']:.3f} ms (pass 1 {t['p1']:.3f}, pass 2 "
          f"{t['p2']:.3f}), sweep {t['sweep']:.3f} ms; max abs difference "
          f"{err:.3e}", flush=True)


def level_bsr(torch, pool, tape, lvl, transpose, nb):
    """The level's contributions as one BSR matrix (nb·bs)² with block
    (dst, src) = op(pool[slot]), so that solve_gemm is X − M·X; None for
    a level without contributions. Built outside any timed window."""
    h = tape.host
    lo, hi = int(tape.dptr[lvl]), int(tape.dptr[lvl + 1])
    rp = h["rowptr"]
    c0, c1 = int(rp[lo]), int(rp[hi])
    if c1 == c0:
        return None
    bs = pool.shape[-1]
    dst = np.repeat(h["rows"][lo:hi], np.diff(rp[lo:hi + 1]))
    src, slot = h["csrc"][c0:c1], h["cslot"][c0:c1]
    order = np.lexsort((src, dst))
    crow = np.zeros(nb + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=nb), out=crow[1:])
    V = pool[torch.as_tensor(slot[order], device=pool.device).long()]
    V = (V.mT if transpose else V).contiguous()
    idx = dict(dtype=torch.int32, device=pool.device)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "Sparse BSR tensor support")
        return torch.sparse_bsr_tensor(
            torch.as_tensor(crow, **idx), torch.as_tensor(src[order], **idx),
            V, size=(nb * bs, nb * bs), check_invariants=True)


def print_solve_levels(per_level, top=6):
    """Where one transposed solve's time goes: the costliest levels by
    pass 1 + pass 2, with their destination rows, products, longest
    chain, chunks (pass 1's CTAs at one right-hand side; pass 2 runs one
    CTA per row)."""
    t1 = sum(m1 for m1, *_ in per_level)
    t2 = sum(m2 for _, m2, *_ in per_level)
    print(f"transposed solve by level (pass 1 {t1:.3f} ms, pass 2 "
          f"{t2:.3f} ms over {len(per_level)} levels; top {top}):")
    for m1, m2, name, lvl, tape in sorted(per_level,
                                          key=lambda t: -t[0] - t[1])[:top]:
        lo, hi = int(tape.dptr[lvl]), int(tape.dptr[lvl + 1])
        chain = np.diff(tape.host["rowptr"][lo:hi + 1])
        nq = int(tape.qptr[lvl + 1] - tape.qptr[lvl])
        print(f"  {name} level {lvl:3d}: pass 1 {m1:8.3f} ms, pass 2 "
              f"{m2:8.3f} ms; {hi - lo} rows, {int(chain.sum())} products, "
              f"longest chain {int(chain.max(initial=0))}, {nq} chunks "
              f"(pass 1 CTAs), {hi - lo} pass 2 CTAs", flush=True)


def solve_bounds(plan, tapes, dtype):
    """Least time of one solve's solve_gemm and diag_apply launches (two
    sweeps, one right-hand side): 2·bs² operations per triple (per
    diagonal inverse); bytes: each stored block (inverse) read once per
    sweep, and X read and written once per sweep."""
    bs = plan.bs
    blk = _blk(plan, dtype)
    xb = 2 * 2 * float(np.dtype(dtype).itemsize) * plan.n_pad
    ntrip = sum(len(t.host["cslot"]) for t in tapes)
    nblk = sum(len(np.unique(t.host["cslot"])) for t in tapes)
    ninv = sum(len(t.host["rows"]) for t in tapes)
    return {"solve_gemm": _bound(2.0 * bs * bs * ntrip, blk * nblk + xb,
                                 "solve", dtype),
            "diag_apply": _bound(2.0 * bs * bs * ninv, blk * ninv + xb,
                                 "solve", dtype)}


def trans_bs64(ctx, rng):
    """At block size 64 on laplacian_3d_unsym(16): the TRANS solution
    against scipy's, rcond against the dense truth (the 30x bound of
    tests/test_trans_cond.py), logdet, a save_factors / load_factors
    round trip, and the two kernels against their plain versions.

    logdet is held to 1e-8 relative against the same plan factored on
    the CPU by the plain versions (float32 both, so the bias of the
    float32 pivots, which both carry, cancels), and against numpy's
    slogdet to the sign and n·eps32 absolute in log|det| (one float32 ulp of
    relative error per pivot; the float32 factor's pivots carry a bias
    that reaches ~1e-8 relative of log|det| here)."""
    import tempfile

    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from superlu_dist_tpu_torch import (Options, SparseLU, Trans,
                                        load_factors, save_factors)
    from superlu_dist_tpu_torch.utils.norms import langs
    from superlu_dist_tpu_torch.utils.testing import laplacian_3d_unsym
    A = laplacian_3d_unsym(16).tocsc()
    n = A.shape[0]
    b = rng.standard_normal(n)
    opts = Options(dtype="float32", block_size=64, trans=Trans.TRANS,
                   condition_number=True)
    res, lu, _ = drive(ctx, "bs=64 trans", A, b, opts,
                       ("solve_gemm", "diag_apply"))
    x_ref = spla.spsolve(sp.csc_matrix(A.T), b)
    err = float(np.abs(res.x - x_ref).max() / np.abs(x_ref).max())
    Ad = A.toarray()
    truth = 1.0 / (langs("1", A) * np.abs(np.linalg.inv(Ad)).sum(
        axis=0).max())
    sign, logabs = lu.logdet()
    csign, clog = SparseLU(A, opts, device="cpu").logdet()
    ds, dl = np.linalg.slogdet(Ad)
    cerr = abs(logabs - clog) / abs(clog)
    derr, dtol = abs(logabs - dl), n * float(np.finfo(np.float32).eps)
    print(f"bs=64 trans: lap3d16u |x - scipy|/|x| {err:.3e} (tolerance "
          f"1e-10); rcond {res.rcond:.6e}, dense {truth:.6e} (within 30x); "
          f"logdet sign {sign:+.0f} (CPU {csign:+.0f}, slogdet {ds:+.0f}), "
          f"log|det| {logabs:.10f}: vs the CPU factor's {clog:.10f} rel "
          f"err {cerr:.3e} (tolerance 1e-8), vs slogdet's {dl:.10f} abs "
          f"err {derr:.3e} (tolerance {dtol:.3e})", flush=True)
    if err > 1e-10:
        fail("bs=64 TRANS solution disagrees with scipy")
    if not truth / 30 < res.rcond < 30 * truth:
        fail("bs=64 rcond outside 30x of the dense truth")
    if sign != csign or cerr > 1e-8:
        fail("bs=64 logdet disagrees with the CPU factor's")
    if sign != ds or derr > dtol:
        fail("bs=64 logdet disagrees with slogdet")
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as d:
        path = os.path.join(d, "factors.npz")
        save_factors(lu, path)
        lu2 = load_factors(path, device="cuda")
        for trans, op in ((Trans.NOTRANS, A), (Trans.TRANS, A.T)):
            x, berr = lu2.refine(b, lu2.solve(b, trans=trans), trans=trans)
            resid = float(np.abs(op @ x - b).max() / np.abs(b).max())
            print(f"bs=64 load_factors {trans.name}: berr {berr.max():.3e},"
                  f" residual {resid:.3e}", flush=True)
            if berr.max() > 1e-12 or resid > 1e-10:
                fail(f"bs=64 loaded factors miss the limits in {trans.name}")
    check_solve(lu, ctx, lu)


def tck_phase(ctx, rng, checks, launches):
    """Phase 8: ``executor="tck"`` on lap3d50 at block size 128, its warm
    call, tck_update against its plain version and the whole factor
    against the float64 reference; then clk, flk and the level executor
    on the same plan through SamePattern_SameRowPerm refactors (the host
    phases are not redone), with clk_update's costliest levels."""
    from superlu_dist_tpu_torch import Fact, Options
    from superlu_dist_tpu_torch.utils.testing import laplacian_3d
    A = laplacian_3d(50)
    n = A.shape[0]
    b = np.asarray(A @ rng.standard_normal(n))
    opts = Options(dtype="float32", block_size=128, executor="tck")
    res, lu, got = drive(ctx, "tck lap3d50", A, b, opts, (
        "tck_update", "diag_lu", "clk_trsm", "sweep"),
        ("clk_update", "flk", "schur"))
    launches["tck_update"] = got["tck_update"]
    plan, tp = lu.plan, lu._ftapes
    colptr = np.searchsorted(plan.slot_col, np.arange(plan.nb + 1))
    height = np.diff(colptr)
    dpos = np.asarray(plan.diag_slot) - colptr[:-1]
    c = tp.host["counts"]
    print(f"lap3d50: n={n} aligned to {plan.n} rows, {plan.nb} block "
          f"columns, {plan.nslots} slots, pool "
          f"{plan.pool_bytes(np.float32) / 2**20:.0f} MiB, {plan.n_flevels} "
          f"factor levels, {len(plan.g_l)} Schur triples, "
          f"{plan.factor_flops / 1e9:.1f} GFLOP (padded block model); "
          f"tallest column {height.max()} blocks, {(height > 104).sum()} "
          f"columns > 104 and {(height > 64).sum()} > 64 blocks, at most "
          f"{dpos.max()} U / {(height - dpos - 1).max()} L blocks in a "
          f"column; tck tiles of {tp.w} rows: {c['tiles']} tiles, "
          f"{c['gemm']} GEMM chunks, {c['finu']} FINU jobs", flush=True)
    warm_call(ctx, "tck lap3d50", A, b, opts)
    checks.update(check_tck(lu, ctx, report=True))
    print_check("tck_update", checks["tck_update"], launches["tck_update"])
    notrans_pair(lu, ctx, "lap3d50 ")

    ssr = Fact.SAME_PATTERN_SAME_ROWPERM
    for exc, need, zero in (
            ("clk", ("clk_update", "diag_lu", "clk_trsm", "sweep"),
             ("tck_update", "flk", "schur")),
            ("flk", ("flk", "diag_lu", "sweep"),
             ("clk_update", "tck_update", "schur")),
            ("pallas", ("schur", "trsm", "diag_lu", "sweep"),
             ("clk_update", "tck_update", "flk"))):
        _, lu, _ = drive(ctx, f"{exc} lap3d50", A, b,
                         opts.replace(executor=exc, fact=ssr), need, zero,
                         lu=lu)
        if lu.plan is not plan:
            fail(f"{exc} lap3d50: the refactor rebuilt the plan")
        if exc == "clk":
            o = check_kernels(lu, ctx, None, levels=True)["clk_update"]
            print(f"lap3d50 clk_update: max_abs_err {o['max_abs_err']:.3e} "
                  f"(tolerance {o['tol']:.3e}); kernel {o['ms']:.3f} ms, "
                  f"plain {o['plain_ms']:.3f} ms, bound {o['bound_ms']:.4f}"
                  f" ms ({o['bound_by']})", flush=True)


def f64_phase(ctx, rng, checks, launches):
    """Phase 9: float64 on the card. lap3d32 NOTRANS and lap3d32u TRANS +
    condition_number run the level executor whatever ``executor`` says;
    every float64 kernel against its plain version on their inputs."""
    from superlu_dist_tpu_torch import Options, Trans
    from superlu_dist_tpu_torch.utils.testing import (laplacian_3d,
                                                      laplacian_3d_unsym)
    level = ("diag_lu", "trsm", "schur", "sweep")
    fused = ("clk_update", "clk_trsm", "tck_update", "flk")
    A = laplacian_3d(32)
    n = A.shape[0]
    b = np.asarray(A @ rng.standard_normal(n))
    opts = Options(dtype="float64", block_size=128)
    res, lu, got = drive(ctx, "float64", A, b, opts, level, fused)
    if res.stat.counters["executor"] != "pallas" or \
            lu.pool.dtype != ctx["torch"].float64:
        fail("float64 did not run the level executor in float64")
    warm_call(ctx, "float64", A, b, opts)
    c = check_level(lu, ctx, report=True, full=True)
    for name in level:
        checks[f"{name}_f64"] = c[name]
        launches[f"{name}_f64"] = got[name]
        print_check(f"{name}_f64", c[name], got[name])

    Au = laplacian_3d_unsym(32)
    bu = rng.standard_normal(Au.shape[0])
    topts = Options(dtype="float64", block_size=128, trans=Trans.TRANS,
                    condition_number=True, executor="tck")
    res, lut, got = drive(ctx, "float64 trans", Au, bu, topts,
                          ("solve_gemm", "diag_apply") + level, fused)
    if res.rcond is None or not 0 < res.rcond <= 1:
        fail(f"float64 trans: rcond {res.rcond} not in (0, 1]")
    print(f"float64 trans: rcond {res.rcond:.6e}, executor "
          f"{res.stat.counters['executor']} (asked for tck)", flush=True)
    check_trans_repeat("float64 trans", lut, bu)
    c = check_solve(lut, ctx, lu)
    for name in ("solve_gemm", "diag_apply"):
        checks[f"{name}_f64"] = c[name]
        launches[f"{name}_f64"] = got[name]
        print_check(f"{name}_f64", c[name], got[name])


#: the single-device factor, sweep and solve kernels, none of which the
#: grid path may launch
SINGLE_DEVICE = ("clk_update", "clk_trsm", "tck_update", "flk", "schur",
                 "trsm", "diag_lu", "sweep", "solve_gemm", "diag_apply")
GRID_NEED = ("rdma_factor", "rdma_solve")


def dist_phase(ctx, rng, checks, launches):
    """Phase 10: ``gssvx_dist`` over a 2x2 grid of ranks on the card, on
    lap3d32 at block size 128: driven like the main path, the receive
    counters against the tapes, a warm call beside the level executor's
    FACT, every entry against its plain version level by level, the
    gathered factor against the float64 reference; then
    ``dist_executor="xla"`` and the bs 64 grids against scipy."""
    import scipy.sparse.linalg as spla

    from superlu_dist_tpu_torch import Grid2D, Options
    from superlu_dist_tpu_torch.utils.testing import laplacian_3d
    torch = ctx["torch"]
    A = laplacian_3d(32)
    n = A.shape[0]
    b = np.asarray(A @ rng.standard_normal(n))
    opts = Options(dtype="float32", block_size=128, dist_executor="rdma")
    grid = Grid2D(2, 2)
    torch.cuda.reset_peak_memory_stats()
    res, lu, got = drive(ctx, "grid 2x2 rdma", A, b, opts, GRID_NEED,
                         SINGLE_DEVICE, grid=grid)
    peak = torch.cuda.max_memory_allocated() / 2**20
    entries = {k: dict(ctx["kernels"][k].entry_launches) for k in GRID_NEED}
    for k, e in entries.items():
        if not all(e.values()):
            fail(f"an entry of {k} was not launched on the grid path: {e}")
    ctx["entry_launches"] = entries
    for k in GRID_NEED:
        launches[k] = got[k]
    print_grid(lu, peak, entries)
    check_recv(lu, "grid 2x2 rdma")
    r2 = warm_call(ctx, "grid 2x2 rdma", A, b, opts, grid=grid)
    check_repeat("grid 2x2 rdma lap3d32", res, r2)
    st = r2.stat
    print(f"grid 2x2 rdma, second call: device ms FACT "
          f"{st.device_ms['FACT']:.3f}, SOLVE {st.device_ms['SOLVE']:.3f}, "
          f"REFINE {st.device_ms['REFINE']:.3f} ({st.refine_steps} steps); "
          f"the level executor's FACT on one rank "
          f"{ctx['level_fact_ms']:.3f} ms", flush=True)
    checks.update(check_dist(lu, ctx))
    for k in GRID_NEED:
        print_check(k, checks[k], launches[k])
    pool, _, _ = lu._export_factors()
    tiny = torch.tensor([res.stat.tiny_pivots])
    check_whole_factor("grid 2x2 rdma (gathered)", lu, ctx, pool, tiny)

    _, _, gx = drive(ctx, "grid 2x2 xla", A, b,
                     opts.replace(dist_executor="xla"), GRID_NEED,
                     SINGLE_DEVICE, grid=grid)
    ex = {k: dict(ctx["kernels"][k].entry_launches) for k in GRID_NEED}
    print(f"grid 2x2 xla: launches per entry {ex}", flush=True)
    if ex != entries:
        fail("dist_executor='xla' did not run the same launches as 'rdma'")

    A2 = laplacian_3d(16)
    b2 = np.asarray(A2 @ rng.standard_normal(A2.shape[0]))
    x_ref = spla.spsolve(A2.tocsc(), b2)
    for pr, pc in ((2, 2), (1, 4), (4, 1), (2, 4)):
        what = f"bs=64 grid {pr}x{pc}"
        r2, lu2, _ = drive(ctx, what, A2, b2, Options(
            dtype="float32", block_size=64, dist_executor="rdma"),
            GRID_NEED, SINGLE_DEVICE, grid=Grid2D(pr, pc))
        err = float(np.abs(r2.x - x_ref).max() / np.abs(x_ref).max())
        print(f"{what}: lap3d16 |x - scipy|/|x| {err:.3e} (tolerance "
              f"1e-10)", flush=True)
        if err > 1e-10:
            fail(f"{what} solution disagrees with scipy")
        check_recv(lu2, what)


def print_grid(lu, peak_mib, entries):
    """The grid path's sizes: per-rank slots, Schur products and state,
    the broadcast buffers' heights and the puts of one factor."""
    dp, ft = lu.dplan, lu._ft
    nd = ft.ndev
    gemms = np.asarray(dp.gptr).reshape(nd, -1)[:, -1]
    puts = {k: int(v.sum()) for k, v in ft.recv.items()}
    rows = (dp.n_local + 2 * (ft.dlen + 1) + 2 * dp.max_dlvl + dp.max_lbuf
            + dp.max_ubuf)
    mib = rows * lu.plan.bs ** 2 * 4 / 2**20
    print(f"grid {dp.pr}x{dp.pc}: {dp.nlvl} levels, n_local {dp.n_local}, "
          f"Schur products per rank {gemms.min()}-{gemms.max()} "
          f"({gemms.sum()} in all), max_lbuf {dp.max_lbuf}, max_ubuf "
          f"{dp.max_ubuf}, max_dlvl {dp.max_dlvl}, dlen {ft.dlen}; factor "
          f"state {mib:.0f} MiB per rank; factor puts {puts} "
          f"({sum(puts.values())} blocks, "
          f"{sum(puts.values()) * lu.plan.bs ** 2 * 4 / 2**20:.0f} MiB); "
          f"peak device memory of the first call {peak_mib:.0f} MiB; "
          f"launches per entry {entries}", flush=True)


def check_recv(lu, what):
    """The receive counters that the puts tallied against the TPU's
    receive tapes: the factor's, and the last solve's L and U sweeps'."""
    bad = [k for k, v in lu.factor_recv().items()
           if not np.array_equal(v, lu._ft.recv[k])]
    for got, tp in zip(lu.solve_recv(), (lu._lt, lu._ut)):
        bad += [f"{tp.which}:{k}" for k, v in got.items()
                if not np.array_equal(v, tp.recv[k])]
    print(f"{what}: receive counters equal the tapes: {not bad}", flush=True)
    if bad:
        fail(f"{what}: receive counters differ from the tapes in {bad}")


def compare_state(torch, o, state, kern, plain, of, flat, table):
    """Run an RDMA entry and its plain version on copies of ``state`` (a
    FactorState or SweepState; ``of`` rebuilds one from ``flat``'s tensor
    list), time both, hold the float buffers to REL_TOL and the receive
    counters to equality, and keep the kernel's copy. ``table`` makes the
    copy's pointer table before the timed call, as a factor or a sweep
    makes it once. Returns the kernel's copy and its ms."""
    ts = flat(state)
    a = [t.clone() for t in ts]
    p = [t.clone() for t in ts]
    sa = of(a)
    if a[0].is_cuda:
        table(sa)
    ms = _timed(torch, lambda: kern(sa))
    o["ms"] += ms
    o["plain_ms"] += _timed(torch, lambda: plain(of(p)))
    fl = [(x, y) for x, y in zip(a, p) if x.is_floating_point()]
    err = max(float((x - y).abs().max()) for x, y in fl)
    scale = max(1.0, max(float(y.abs().max()) for _, y in fl))
    o["max_abs_err"] = max(o["max_abs_err"], err)
    o["tol"] = max(o["tol"], REL_TOL * scale)
    if err > REL_TOL * scale:
        fail(f"an RDMA entry disagrees with its plain version: {err:.3e} > "
             f"{REL_TOL * scale:.3e}")
    if any(not torch.equal(x, y) for x, y in zip(a, p)
           if not x.is_floating_point()):
        fail("an RDMA entry's receive counters differ from its plain "
             "version's")
    return sa, ms


def check_dist(lu, ctx):
    """rdma_factor's three entries over one factor and rdma_solve's two
    over one L+U solve of a right-hand side, each against its plain
    version level by level from the same state (the run goes on with the
    kernel's output). No one PyTorch call computes a distributed factor
    or sweep, so library_ms stays None."""
    from collections import defaultdict

    from superlu_dist_tpu_torch.parallel import dist2d
    torch, rdma = ctx["torch"], ctx["rdma"]
    plan, ft = lu.plan, lu._ft
    out = {k: dict(max_abs_err=0.0, tol=0.0, ms=0.0, plain_ms=0.0,
                   library_ms=None) for k in GRID_NEED}
    per_entry = defaultdict(float)
    th = lu._thresh()
    st = rdma.new_factor_state(dist2d.init_local_pools(
        plan, lu.dplan, lu._a3_data, lu.dtype, lu.device), ft)
    for lvl in range(ft.nlvl):
        for entry, kern, plain in (
                ("rdma_diag", lambda s: rdma.rdma_diag(s, th, ft, lvl),
                 lambda s: rdma.rdma_diag_plain(s, th, ft, lvl)),
                ("rdma_panel", lambda s: rdma.rdma_panel(s, ft, lvl),
                 lambda s: rdma.rdma_panel_plain(s, ft, lvl)),
                ("rdma_schur", lambda s: rdma.rdma_schur(s, ft, lvl),
                 lambda s: rdma.rdma_schur_plain(s, ft, lvl))):
            st, ms = compare_state(
                torch, out["rdma_factor"], st, kern, plain,
                lambda ts: rdma.FactorState.of(ts, ft.ndev),
                rdma.FactorState.tensors, rdma.FactorState.table)
            per_entry[entry] += ms
    rng = np.random.default_rng(1)
    B = torch.as_tensor(rng.standard_normal((plan.nb, plan.bs, 1)),
                        dtype=torch.float32, device=lu.device)
    X = [B.clone() for _ in range(ft.ndev)]
    for tp, dinv in ((lu._lt, lu.linv), (lu._ut, lu.uinv)):
        ss = rdma.new_sweep_state(X, tp)
        for lvl in range(tp.nlvl):
            for entry, kern, plain, M in (
                    ("rdma_solve_gemm", rdma.rdma_solve_gemm,
                     rdma.rdma_solve_gemm_plain, lu.pool),
                    ("rdma_solve_diag", rdma.rdma_solve_diag,
                     rdma.rdma_solve_diag_plain, dinv)):
                ss, ms = compare_state(
                    torch, out["rdma_solve"], ss,
                    lambda s: kern(M, s, tp, lvl),
                    lambda s: plain(M, s, tp, lvl),
                    lambda ts: rdma.SweepState(*(
                        ts[i * ft.ndev:(i + 1) * ft.ndev] for i in range(4))),
                    lambda s: s.X + s.P + s.slots + s.recv,
                    lambda s: s.table(M))
                per_entry[entry] += ms
        X = ss.X
    print("RDMA entries, kernel ms summed over the levels (one factor, one "
          "L+U solve): " + ", ".join(f"{k} {v:.3f}"
                                     for k, v in per_entry.items()),
          flush=True)
    out["rdma_factor"].update(grid_factor_bound(lu))
    out["rdma_solve"].update(grid_solve_bound(lu))
    return out


def grid_factor_bound(lu):
    """Least time of one 2D factor: 2·bs³ per Schur product and per panel,
    (4/3)·bs³ per tile (operations); bytes: each tile read and written,
    its two inverses stored and put into Pr + Pc broadcast rows, each
    panel read, written and put into its Pc (L) or Pr (U) buffer rows,
    each rank's inverses read once per level by its panels, and per level
    and rank the distinct targets read and written and the distinct
    broadcast rows read once."""
    plan, ft = lu.plan, lu._ft
    h, bs = ft.host, plan.bs
    blk = _blk(plan, np.float32)
    nprod, npanel = len(h["c_l"]), len(h["b_loc"])
    flops = 2.0 * bs ** 3 * (nprod + npanel) + (4.0 / 3.0) * bs ** 3 * plan.nb
    side = h["b_side"]
    nblk = plan.nb * (4 + ft.pr + ft.pc) + int(
        ((side == 0) * (2 + ft.pc) + (side == 1) * (2 + ft.pr)).sum())
    for lvl in range(ft.nlvl):
        b = slice(ft.bptr[lvl, 0], ft.bptr[lvl, -1])
        nblk += len(set(zip(h["b_rank"][b], h["b_pil"][b], side[b])))
        s = slice(ft.sptr[lvl, 0], ft.sptr[lvl, -1])
        c = slice(h["cptr"][s.start], h["cptr"][s.stop])
        rk = np.repeat(h["s_rank"][s], np.diff(h["cptr"][s.start:s.stop + 1]))
        nblk += 2 * (s.stop - s.start) + len(set(zip(rk, h["c_l"][c]))) \
            + len(set(zip(rk, h["c_u"][c])))
    return _bound(flops, blk * nblk, "factor")


def grid_solve_bound(lu, nrhs=1):
    """Least time of one 2D L+U solve of one right-hand side: 2·bs²·nrhs
    per product and per diagonal inverse (operations); bytes: per sweep
    each rank's distinct pool blocks and the inverses read once, the
    partials written, put (non-owners) and read by the owner, the solved
    rows read by their owner and written into every rank's X."""
    plan = lu.plan
    blk = _blk(plan, np.float32)
    xrow = 4.0 * plan.bs * nrhs
    flops = nbytes = 0.0
    for tp in (lu._lt, lu._ut):
        h = tp.host
        rk = np.repeat(h["p_rank"], np.diff(h["cptr"]))
        flops += 2.0 * plan.bs ** 2 * nrhs * (len(h["c_loc"]) + plan.nb)
        nbytes += blk * (len(set(zip(rk, h["c_loc"]))) + plan.nb)
        nsend = int(h["p_send"].sum())
        nbytes += xrow * (2 * len(h["p_pos"]) + 2 * nsend
                          + plan.nb * (1 + tp.ndev))
    return _bound(flops, nbytes, "solve")


def profile_phase(lu, A, b):
    """``SparseLU.profile_levels`` on a level-executor factor: the six
    costliest levels; the solve after it must still meet the limits."""
    rows = lu.profile_levels()
    total = sum(r["ms"] for r in rows)
    print(f"profile_levels (level executor, bs={lu.plan.bs}): {len(rows)} "
          f"levels, {total:.3f} ms in all; the six costliest:")
    for r in sorted(rows, key=lambda r: -r["ms"])[:6]:
        print(f"  level {r['level']:3d}: {r['ms']:8.3f} ms; {r['steps']} "
              f"steps, {r['lpanels']}+{r['upanels']} panels, {r['gemms']} "
              f"Schur triples, {r['gflops_model']:.1f} GFLOP/s (model)",
              flush=True)
    x, berr = lu.refine(b, lu.solve(b))
    resid = float(np.abs(A @ x - b).max() / np.abs(b).max())
    print(f"after profile_levels: berr {berr.max():.3e}, residual "
          f"{resid:.3e}", flush=True)
    if len(rows) != lu.plan.n_flevels or berr.max() > 1e-12 \
            or resid > 1e-10:
        fail("profile_levels: wrong row count, or the solve after it "
             "misses the limits")


def print_tck_levels(tp, per_level, top=6):
    """Where tck_update's time goes: the costliest levels, with their
    columns, tiles, GEMM chunks, L·U products and the tallest column."""
    h = tp.host
    total = sum(ms for ms, _ in per_level)
    print(f"tck_update by level (kernel {total:.3f} ms over {tp.nlvl} "
          f"levels; top {top}):")
    for ms, lvl in sorted(per_level, reverse=True)[:top]:
        c0, c1 = int(tp.cptr[lvl]), int(tp.cptr[lvl + 1])
        tiles = h["tiles"][h["ctile"][c0]:h["ctile"][c1]]
        jobs = [h["gjobs"][g0:g1, 1] for _, _, g0, g1, _, _ in tiles]
        print(f"  level {lvl:3d}: kernel {ms:9.3f} ms; {c1 - c0} columns, "
              f"{len(tiles)} tiles, {sum(len(j) for j in jobs)} GEMM chunks,"
              f" {sum(int(j.sum()) for j in jobs)} L·U products, tallest "
              f"tile {int(tp.hmax[lvl])} rows", flush=True)


def print_update_levels(tp, per_level, top=6):
    """Where clk_update's time goes: the costliest levels, with their
    columns, U blocks (jobs) and L·U block products."""
    h = tp.host
    total = sum(ms for ms, _ in per_level)
    print(f"clk_update by level (kernel {total:.3f} ms over {tp.nlvl} "
          f"levels; top {top}):")
    for ms, lvl in sorted(per_level, reverse=True)[:top]:
        cols = h["ucols"][tp.uptr[lvl]:tp.uptr[lvl + 1]]
        jobs = [np.arange(h["col_job0"][k], h["col_job0"][k]
                          + h["col_dpos"][k]) for k in cols]
        jobs = np.concatenate(jobs) if jobs else np.zeros(0, np.int64)
        longest = max((int(h["col_dpos"][k] + h["job_lm"][
            h["col_job0"][k]:h["col_job0"][k] + h["col_dpos"][k]].sum())
            for k in cols), default=0)
        print(f"  level {lvl:3d}: kernel {ms:9.3f} ms; {len(cols)} columns, "
              f"{len(jobs)} U blocks, {int(h['job_lm'][jobs].sum())} L·U "
              f"products, longest column chain {longest} products",
              flush=True)


def print_flk_groups(tp, per_group, top=6):
    """Where flk's time goes: the costliest target groups, with their
    targets, products and the longest chain one CTA walks."""
    h = tp.host
    total = sum(ms for ms, _ in per_group)
    print(f"flk by target group (kernel {total:.3f} ms over "
          f"{len(per_group)} groups; top {top}):")
    for ms, g in sorted(per_group, reverse=True)[:top]:
        lo, hi = tp.tptr[g], tp.tptr[g + 1]
        chain = np.diff(h["cptr"][lo:hi + 1])
        print(f"  level {g // 2:3d} {'panels' if g % 2 else 'diagonal'}: "
              f"kernel {ms:9.3f} ms; {hi - lo} targets, {int(chain.sum())} "
              f"L·U products, longest chain {int(chain.max(initial=0))}",
              flush=True)


def print_schur_levels(tp, per_level, top=6):
    """Where schur's time goes: the costliest levels, with their targets,
    products and longest per-target chain."""
    h = tp.host
    total = sum(ms for ms, _ in per_level)
    print(f"schur by level (kernel {total:.3f} ms over {tp.nlvl} levels; "
          f"top {top}):")
    for ms, lvl in sorted(per_level, reverse=True)[:top]:
        lo, hi = tp.sptr[lvl], tp.sptr[lvl + 1]
        chain = np.diff(h["cptr"][lo:hi + 1])
        print(f"  level {lvl:3d}: kernel {ms:9.3f} ms; {hi - lo} targets, "
              f"{int(chain.sum())} L·U products, longest chain "
              f"{int(chain.max(initial=0))}", flush=True)


def _bound(flops, nbytes, per, dtype=np.float32):
    tf = flops / PEAK_FLOPS[np.dtype(dtype).name]
    tb = nbytes / PEAK_BYTES
    return dict(bound_ms=max(tf, tb) * 1e3,
                bound_by="operations" if tf >= tb else "bytes",
                per=per, flops=flops, bytes=nbytes)


def _blk(plan, dtype):
    """Bytes of one stored block."""
    return float(np.dtype(dtype).itemsize) * plan.bs * plan.bs


def work_bounds(plan, tp, lu):
    """Least time for each clk-path kernel's work in one factor (one L+U
    solve for the sweep) on this plan: the larger of its operations at the
    peak of its type and its bytes (each input read once, each output
    written once) at the memory rate."""
    bs = plan.bs
    h = tp.host
    nl = len(h["lslot"])
    return {"diag_lu": diag_bound(plan, lu.dtype)["diag_lu"],
            "clk_update": update_bound(plan, tp, lu.dtype),
            "clk_trsm": _bound(2.0 * bs ** 3 * nl,
                               _blk(plan, lu.dtype) * (2 * nl + plan.nb),
                               "factor", lu.dtype),
            "sweep": sweep_bound(plan, lu)}


def diag_bound(plan, dtype):
    """diag_lu: (4/3)·bs³ per tile; the tile in and out, both inverses
    out."""
    nd, bs = plan.nb, plan.bs
    return {"diag_lu": _bound(nd * (4.0 / 3.0) * bs ** 3,
                              nd * 4 * _blk(plan, dtype), "factor", dtype)}


def sweep_bound(plan, lu):
    """One L+U solve: 2·bs² per contribution and per diagonal inverse;
    each stored block and inverse read once, X read and written once per
    sweep."""
    bs = plan.bs
    ncon = len(lu._ltape.host["cslot"]) + len(lu._utape.host["cslot"])
    nslots_read = len(np.unique(lu._ltape.host["cslot"])) + \
        len(np.unique(lu._utape.host["cslot"]))
    esz = np.dtype(lu.dtype).itemsize
    return _bound(2.0 * bs * bs * (ncon + 2 * plan.nb),
                  _blk(plan, lu.dtype) * (nslots_read + 2 * plan.nb)
                  + 2 * 2 * esz * plan.n_pad, "solve", lu.dtype)


def update_bound(plan, tp, dtype):
    """The left-looking update of one factor (clk_update, and tck_update,
    which computes the same function), from the clk tapes ``tp``: 2·bs³
    per U finalize and per L·U product; per level the distinct U blocks,
    L sources and targets read once, the U blocks and targets written
    once, each source's inverse read once."""
    bs = plan.bs
    blk = _blk(plan, dtype)
    h = tp.host
    flops = nbytes = 0.0
    for lvl in range(tp.nlvl):
        cols = h["ucols"][tp.uptr[lvl]:tp.uptr[lvl + 1]]
        if not len(cols):
            continue
        jobs = np.concatenate([np.arange(h["col_job0"][k],
                                         h["col_job0"][k] + h["col_dpos"][k])
                               for k in cols])
        uslots = np.concatenate([np.arange(h["col_base"][k],
                                           h["col_base"][k]
                                           + h["col_dpos"][k])
                                 for k in cols])
        lsrc = np.unique(np.concatenate(
            [np.arange(h["job_la0"][q], h["job_la0"][q] + h["job_lm"][q])
             for q in jobs]))
        tgt = np.unique(np.concatenate(
            [h["dst"][h["job_dst0"][q]:h["job_dst0"][q] + h["job_lm"][q]]
             for q in jobs]))
        reads = len(np.union1d(np.union1d(uslots, lsrc), tgt))
        writes = len(np.union1d(uslots, tgt))
        nlinv = len(np.unique(h["job_src"][jobs]))
        flops += 2.0 * bs ** 3 * (len(jobs) + h["job_lm"][jobs].sum())
        nbytes += blk * (reads + writes + nlinv)
    return _bound(flops, nbytes, "factor", dtype)


def flk_bounds(plan, tp, flk):
    """flk's least time per factor: 2·bs³ per Schur triple and per panel
    finalize; per launch (target group), the distinct target and source
    blocks read once, the targets written once and the inverses read
    once."""
    bs = plan.bs
    blk = _blk(plan, np.float32)
    h = tp.host
    nfin = int(np.count_nonzero(h["tfin"] != flk.FIN_NONE))
    flops = 2.0 * bs ** 3 * (len(h["cl"]) + nfin)
    nbytes = 0.0
    for g in range(2 * tp.nlvl):
        lo, hi = tp.tptr[g], tp.tptr[g + 1]
        if hi == lo:
            continue
        c = slice(h["cptr"][lo], h["cptr"][hi])
        t = h["tslot"][lo:hi]
        src = np.union1d(h["cl"][c], h["cu"][c])
        fin = h["tfin"][lo:hi] != flk.FIN_NONE
        ninv = len(np.unique(h["tstep"][lo:hi][fin]))
        nbytes += blk * (len(np.union1d(t, src)) + len(t) + ninv)
    return _bound(flops, nbytes, "factor")


def level_bounds(plan, tp, dtype):
    """schur: 2·bs³ per Schur triple; per level the distinct targets and
    sources read once and the targets written once. trsm: 2·bs³ per panel
    block; panels in and out, each step's two inverses read once."""
    bs = plan.bs
    blk = _blk(plan, dtype)
    h = tp.host
    nbytes = 0.0
    for lvl in range(tp.nlvl):
        lo, hi = tp.sptr[lvl], tp.sptr[lvl + 1]
        c = slice(h["cptr"][lo], h["cptr"][hi])
        t = h["tslot"][lo:hi]
        src = np.union1d(h["cl"][c], h["cu"][c])
        nbytes += blk * (len(np.union1d(t, src)) + len(t))
    npanel = len(h["lslot"]) + len(h["uslot"])
    return {"schur": _bound(2.0 * bs ** 3 * len(h["cl"]), nbytes, "factor",
                            dtype),
            "trsm": _bound(2.0 * bs ** 3 * npanel,
                           blk * (2 * npanel + 2 * plan.nb), "factor",
                           dtype)}


if __name__ == "__main__":
    main()
