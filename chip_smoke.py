"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):

1. the card's name and power limit (nvidia-smi), and the native host
   engine (g++), which must load;
2. build every CUDA kernel of the main path (one nvcc per source, in
   parallel) and print the build seconds and the ptxas resource lines;
3. the main path through the user entry point:
   ``gssvx(A, b, Options(dtype="float32", block_size=128))`` on
   ``laplacian_3d(32)`` (n = 32,768), with every launch count set to 0
   just before and read just after; berr <= 1e-12 and
   ||Ax - b||inf / ||b||inf <= 1e-10 are required and every kernel must
   have been launched; a second, warm call is timed the same way, and one
   refinement is profiled (device busy and idle share);
4. every kernel against its plain PyTorch version on the card, level by
   level on the main path's own inputs (both get the same input; the run
   goes on with the kernel's output), timed with CUDA events; then the
   whole clk factor against the independent right-looking float64
   reference ``blocklu.factor_plain``;
5. the same checks at the Options default block size 64 on
   ``laplacian_3d(16)``, whose solution is held against scipy's;
6. one JSON line of per-kernel results, the nvidia-smi line, and the
   final ``{"ok": true, "device": ...}`` line.

Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

#: FP32 peak outside the tensor cores and memory rate of an H100 SXM
#: (NVIDIA data sheet; the kernels run IEEE FP32 on the CUDA cores)
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
#: kernel against plain version: max |difference| <= REL_TOL * max(1,
#: max |plain output|). Both compute in float32 from the same input but
#: sum in other orders (128-long dot products, a 128-step elimination
#: whose inverses carry the tile's conditioning); 1e-4 is ~840 float32
#: ulp, while a wrong block or index gives errors of order 1.
REL_TOL = 1e-4
#: clk factor against the float64 right-looking reference: 512 float32
#: ulp at the pool scale, the tolerance tests/test_clk.py gives random
#: patterns (the top separator blocks of lap3d32 sum hundreds of products)
FACTOR_ULPS = 512


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import scipy.sparse.linalg as spla

    from superlu_dist_tpu_torch import Options, gssvx
    from superlu_dist_tpu_torch.ops import blocklu
    from superlu_dist_tpu_torch.ops.host.native import get_lib
    from superlu_dist_tpu_torch.ops.kernels import _build, clk, diag_lu
    from superlu_dist_tpu_torch.ops.kernels import sweep
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
               "clk_trsm": clk.TRSM, "sweep": sweep.KERNEL}
    build_s = _build.build_all(list(kernels.values()))
    print(f"kernels built in {build_s:.1f} s", flush=True)
    for k in (diag_lu.KERNEL, clk.UPDATE, sweep.KERNEL):
        print(f"ptxas {k.source}:\n{_build.ptxas_report(k)}", end="")
    dev = torch.device("cuda")

    # ---- 3. the main path ---------------------------------------------
    A = laplacian_3d(32)
    n = A.shape[0]
    rng = np.random.default_rng(0)
    b = np.asarray(A @ rng.standard_normal(n))
    opts = Options(dtype="float32", block_size=128)
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    res, lu = gssvx(A, b, opts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    plan = lu.plan
    resid = float(np.abs(A @ res.x - b).max() / np.abs(b).max())
    berr = float(np.max(res.berr))
    st = res.stat
    print(f"main path: lap3d32 n={n} aligned to {plan.n} rows, "
          f"{plan.nb} block columns, {plan.nslots} slots, pool "
          f"{plan.pool_bytes(np.float32) / 2**20:.0f} MiB, "
          f"{plan.n_flevels} factor levels, {plan.lsol_nlvl}+"
          f"{plan.usol_nlvl} solve levels, {len(plan.g_l)} Schur triples, "
          f"{plan.factor_flops / 1e9:.1f} GFLOP (padded block model)")
    print_phases("main path", wall, st)
    print(f"main path: berr {berr:.3e}, ||Ax-b||/||b|| {resid:.3e}, "
          f"tiny pivots {st.tiny_pivots}, launches {launches}", flush=True)
    if not np.all(np.isfinite(res.x)) or res.x.shape != (n,):
        fail("solution not finite or of the wrong shape")
    if berr > 1e-12 or resid > 1e-10:
        fail(f"main path accuracy: berr {berr:.3e} (<= 1e-12), residual "
             f"{resid:.3e} (<= 1e-10)")
    for name, c in launches.items():
        if c <= 0:
            fail(f"kernel {name} was not launched on the main path")

    # the same call again, with kernels loaded and allocator warm: the
    # first call's phases also hold one-time module loads
    t0 = time.perf_counter()
    res_w, _ = gssvx(A, b, opts)
    torch.cuda.synchronize()
    print_phases("main path, second call", time.perf_counter() - t0,
                 res_w.stat)
    if float(np.max(res_w.berr)) > 1e-12:
        fail(f"second call: berr {np.max(res_w.berr):.3e} > 1e-12")

    profile_refine(torch, lu, b, res.x)

    # ---- 4. kernels against plain versions on the main path's inputs --
    checks = check_kernels(lu, torch, blocklu, clk, sweep, diag_lu,
                           launches)

    # ---- 5. the Options default block size ----------------------------
    A2 = laplacian_3d(16)
    b2 = np.asarray(A2 @ rng.standard_normal(A2.shape[0]))
    res2, lu2 = gssvx(A2, b2, Options(dtype="float32", block_size=64))
    x_ref = spla.spsolve(A2.tocsc(), b2)
    err2 = float(np.abs(res2.x - x_ref).max() / np.abs(x_ref).max())
    print(f"bs=64: lap3d16 berr {np.max(res2.berr):.3e}, |x - scipy|/|x| "
          f"{err2:.3e} (tolerance 1e-10)", flush=True)
    if err2 > 1e-10 or np.max(res2.berr) > 1e-12:
        fail("bs=64 solution disagrees with scipy")
    checks64 = check_kernels(lu2, torch, blocklu, clk, sweep, diag_lu,
                             None)
    for name, c in checks64.items():
        print(f"bs=64 {name}: max_abs_err {c['max_abs_err']:.3e} "
              f"(tolerance {c['tol']:.3e})", flush=True)

    rows = []
    replaces = {
        "diag_lu": "superlu_dist_tpu/ops/kernels/flk.py:339",
        "clk_update": "superlu_dist_tpu/ops/kernels/clk.py:248",
        "clk_trsm": "superlu_dist_tpu/ops/kernels/clk.py:248",
        "sweep": "superlu_dist_tpu/ops/kernels/pallas_exec.py:680",
    }
    for name, k in kernels.items():
        c = checks[name]
        rows.append(dict(
            name=name, route="cuda",
            source=f"superlu_dist_tpu_torch/ops/kernels/csrc/{k.source}",
            replaces=replaces[name], launches=launches[name],
            max_abs_err=c["max_abs_err"], ms=c["ms"],
            plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
            bound_by=c["bound_by"], library_ms=c["library_ms"],
            per=c["per"]))
    print(json.dumps({"kernels": rows}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def print_phases(what, wall, st):
    """A gssvx call's wall seconds, its phases' CUDA-event ms (the stream's
    elapsed time, host gaps included) and its host seconds per phase."""
    print(f"{what}: gssvx wall {wall:.2f} s; device ms: factor "
          f"{st.device_ms['FACT']:.3f}, solve {st.device_ms['SOLVE']:.3f}, "
          f"refine {st.device_ms['REFINE']:.3f} ({st.refine_steps} steps); "
          f"host s: " + ", ".join(f"{k} {v:.3f}"
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


def _timed(torch, fn):
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    fn()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1])


def check_kernels(lu, torch, blocklu, clk, sweep, diag_lu, launches):
    """Each kernel against its plain version on ``lu``'s plan, level by
    level: both get the same input and the factor goes on with the
    kernel's output. Returns per kernel the max abs error, its tolerance,
    the summed kernel and plain ms of one factor (one L+U solve for the
    sweep) and the bound of that work."""
    plan, tp, dev = lu.plan, lu._ftapes, lu.device
    bs, nb = plan.bs, plan.nb
    th = lu._thresh()
    pool = blocklu.init_pool(plan, lu._a3_data, np.float32, dev)
    linv = torch.zeros((nb, bs, bs), dtype=torch.float32, device=dev)
    uinv = torch.zeros_like(linv)
    tiny = torch.zeros(1, dtype=torch.int32, device=dev)
    # library_ms: clk_trsm is a batched product per level, timed as one
    # torch.bmm on the level's gathered L blocks and U inverses. No one
    # PyTorch call computes diag_lu (no-pivot LU with both inverses and
    # tiny-pivot replacement), clk_update (a chain of dependent products
    # per column) or the sweep (a level of a block-sparse triangular
    # solve), so theirs stays None.
    out = {k: dict(max_abs_err=0.0, tol=0.0, ms=0.0, plain_ms=0.0,
                   library_ms=None)
           for k in ("diag_lu", "clk_update", "clk_trsm", "sweep")}
    out["clk_trsm"]["library_ms"] = 0.0

    def compare(name, kern, plain, state):
        """Run kernel and plain on copies of ``state``; keep the
        kernel's copy."""
        a = [t.clone() for t in state]
        p = [t.clone() for t in state]
        out[name]["ms"] += _timed(torch, lambda: kern(*a))
        out[name]["plain_ms"] += _timed(torch, lambda: plain(*p))
        err = max(float((x - y).abs().max()) for x, y in zip(a, p))
        scale = max(1.0, max(float(y.abs().max()) for y in p))
        o = out[name]
        o["max_abs_err"] = max(o["max_abs_err"], err)
        o["tol"] = max(o["tol"], REL_TOL * scale)
        if err > REL_TOL * scale:
            fail(f"{name} (bs={bs}) disagrees with its plain version: "
                 f"{err:.3e} > {REL_TOL * scale:.3e}")
        return a

    per_level = []
    for lvl in range(tp.nlvl):
        ms0, plain0 = out["clk_update"]["ms"], out["clk_update"]["plain_ms"]
        pool, = compare(
            "clk_update", lambda p: clk.clk_update(p, linv, tp, lvl),
            lambda p: clk.clk_update_plain(p, linv, tp, lvl), [pool])
        per_level.append((out["clk_update"]["ms"] - ms0,
                          out["clk_update"]["plain_ms"] - plain0, lvl))
        lo, hi = int(tp.dptr[lvl]), int(tp.dptr[lvl + 1])
        ds, dk = tp.dslot[lo:hi], tp.dstep[lo:hi]
        pool, linv, uinv, tiny = compare(
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
            # one untimed call first: the kernels ran warm on the main
            # path, so cuBLAS's first call at a shape is left out too
            torch.bmm(Lg, Ug, out=C)
            out["clk_trsm"]["library_ms"] += _timed(
                torch, lambda: torch.bmm(Lg, Ug, out=C))
            del Lg, Ug, C
        pool, = compare(
            "clk_trsm", lambda p: clk.clk_trsm(p, uinv, tp, lvl),
            lambda p: clk.clk_trsm_plain(p, uinv, tp, lvl), [pool])
    if launches is not None:
        print_update_levels(tp, per_level)

    # the whole clk factor against the float64 right-looking reference
    ref, _, _, _ = blocklu.factor_plain(
        plan, blocklu.init_pool(plan, lu._a3_data, np.float64, dev), th)
    ns = plan.nslots
    scale = max(1.0, float(ref[:ns].abs().max()))
    ferr = float((pool[:ns].double() - ref[:ns]).abs().max())
    ftol = FACTOR_ULPS * float(np.finfo(np.float32).eps) * scale
    print(f"bs={bs}: clk factor vs float64 right-looking reference: max "
          f"abs err {ferr:.3e} (tolerance {ftol:.3e}); tiny pivots "
          f"{int(tiny.item())}", flush=True)
    if ferr > ftol:
        fail("clk factor disagrees with the float64 reference")
    del ref

    # one L+U solve of a right-hand side, level by level
    rng = np.random.default_rng(1)
    X = torch.as_tensor(rng.standard_normal((nb, bs, 1)),
                        dtype=torch.float32, device=dev)
    for tape, dinv in ((lu._ltape, lu.linv), (lu._utape, lu.uinv)):
        for lvl in range(tape.nlvl):
            X, = compare(
                "sweep", lambda x: sweep.sweep_level(lu.pool, dinv, x, tape,
                                                     lvl),
                lambda x: sweep.sweep_level_plain(lu.pool, dinv, x, tape,
                                                  lvl), [X])

    bounds = work_bounds(plan, tp, lu)
    for name, o in out.items():
        o.update(bounds[name])
        if launches is not None:
            lib = "none" if o["library_ms"] is None \
                else f"{o['library_ms']:.3f} ms"
            print(f"{name}: max_abs_err {o['max_abs_err']:.3e} (tolerance "
                  f"{o['tol']:.3e}); kernel {o['ms']:.3f} ms, plain "
                  f"{o['plain_ms']:.3f} ms, library {lib}, bound "
                  f"{o['bound_ms']:.4f} ms "
                  f"({o['bound_by']}) per {o['per']}; "
                  f"{launches[name]} launches on the main path",
                  flush=True)
    return out


def print_update_levels(tp, per_level, top=6):
    """Where clk_update's time goes: the costliest levels, with their
    columns, U blocks (jobs) and L·U block products."""
    h = tp.host
    total = sum(ms for ms, _, _ in per_level)
    print(f"clk_update by level (kernel {total:.3f} ms over {tp.nlvl} "
          f"levels; top {top}):")
    for ms, plain_ms, lvl in sorted(per_level, reverse=True)[:top]:
        cols = h["ucols"][tp.uptr[lvl]:tp.uptr[lvl + 1]]
        jobs = [np.arange(h["col_job0"][k], h["col_job0"][k]
                          + h["col_dpos"][k]) for k in cols]
        jobs = np.concatenate(jobs) if jobs else np.zeros(0, np.int64)
        longest = max((int(h["col_dpos"][k] + h["job_lm"][
            h["col_job0"][k]:h["col_job0"][k] + h["col_dpos"][k]].sum())
            for k in cols), default=0)
        print(f"  level {lvl:3d}: kernel {ms:9.3f} ms, plain {plain_ms:9.3f}"
              f" ms; {len(cols)} columns, {len(jobs)} U blocks, "
              f"{int(h['job_lm'][jobs].sum())} L·U products, longest "
              f"column chain {longest} products", flush=True)


def work_bounds(plan, tp, lu):
    """Least time for each kernel's work in one factor (one L+U solve for
    the sweep) on this plan: the larger of its operations at FP32 peak
    and its bytes (each input read once, each output written once) at the
    memory rate."""
    bs = plan.bs
    blk = 4.0 * bs * bs
    h = tp.host
    res = {}

    def bound(flops, nbytes, per):
        tf, tb = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
        return dict(bound_ms=max(tf, tb) * 1e3,
                    bound_by="operations" if tf >= tb else "bytes",
                    per=per, flops=flops, bytes=nbytes)

    nd = plan.nb
    res["diag_lu"] = bound(nd * (4.0 / 3.0) * bs ** 3, nd * 4 * blk, "factor")

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
    res["clk_update"] = bound(flops, nbytes, "factor")

    nl = len(h["lslot"])
    res["clk_trsm"] = bound(2.0 * bs ** 3 * nl,
                            blk * (2 * nl + plan.nb), "factor")

    ncon = len(lu._ltape.host["cslot"]) + len(lu._utape.host["cslot"])
    nslots_read = len(np.unique(lu._ltape.host["cslot"])) + \
        len(np.unique(lu._utape.host["cslot"]))
    res["sweep"] = bound(2.0 * bs * bs * (ncon + 2 * plan.nb),
                         blk * (nslots_read + 2 * plan.nb)
                         + 2 * 2 * 4.0 * plan.n_pad, "solve")
    return res


if __name__ == "__main__":
    main()
