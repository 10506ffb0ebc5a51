"""Time flk_update per target group on one card, at several chunk lengths
and band geometries, or its bf16 pass against an earlier checkout's.

    python -m superlu_dist_tpu_torch.tools.flk_ab [K ...]
    python -m superlu_dist_tpu_torch.tools.flk_ab --bf16 OLD_CSRC [K ...]

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

bf16 (``--bf16 OLD_CSRC``, the ``csrc`` directory of an earlier
checkout, e.g. from ``git archive``): on the flk plan of
``laplacian_3d(K)`` (bs 128) each group's bf16 pass (pass 1 and pass 2)
through OLD's ``slu_flk_chunks_bf16`` / ``slu_flk_sum_bf16`` as they are
and cut by text patches of its ``chain_band_mma`` (``OLD_VARIANTS``: the
staging only, the ``mma``s removed; the products from one resident stage,
the staging removed; the barriers only), and through the shipped
entries, every run on a copy of the same input, L2 flushed, in the
order of the runs and then back; the
factor goes on with the shipped kernel. It prints per run the ms per
factor and whether its output equals OLD's bit for bit; the five
costliest groups (by OLD's time) with their targets, chunks, pass-2
targets and band width, each run's ms there, and µs per band product
an SM (the group's ms over its products and finalizes times bands over
the SMs); and the split of OLD's time on those groups into barriers and
loop (the barriers-only cut), fragments and ``mma`` (the resident stage
less that) and bytes in flight (the staging less that). Before that, the
warm FACT under "auto" of flk and ILU(1) by SamePattern_SameRowPerm
refactors with OLD's bf16 entries and the shipped ones in turns (old,
new, new, old, after one untimed call through each). Kernels load
eagerly (``CUDA_MODULE_LOADING=EAGER``).
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
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


# ---------------------------------------------------------------------------
# the bf16 pass
# ---------------------------------------------------------------------------

#: patches of OLD's chain.cuh inside chain_band_mma: (pattern, replacement)
_NO_MMA = (r"    if \(p < np\) \{\n      slu_mma::mma_chunk.*?\n    \}\n"
           r"(    if \(c % NK == NK - 1\))", r"    (void)st;\n\1")
_NO_STAGE = ((r"if \(c \+ ST - 1 < nchunks\) load\(c \+ ST - 1\);", ""),
             (r"const float\* st = smem \+ \(c % ST\) \* G::kStage;",
              "const float* st = smem;"))
OLD_VARIANTS = {
    "old": (),
    "old staging only": (_NO_MMA,),
    "old resident stage": _NO_STAGE,
    "old barriers only": (_NO_MMA,) + _NO_STAGE,
}
def _start(label, src_dir, patches):
    """Copy ``src_dir``'s flk.cu and headers into a build directory of its
    own, patch its chain.cuh (each pattern matched once, inside
    ``chain_band_mma``), start nvcc; returns (process, .so)."""
    from ..ops.kernels import _build
    d = os.path.join(_build.BUILD_DIR, "ab", "flk_" +
                     re.sub(r"\W+", "_", label))
    os.makedirs(d, exist_ok=True)
    for f in os.listdir(src_dir):
        if f.endswith(".cuh") or f == "flk.cu":
            shutil.copy(os.path.join(src_dir, f), d)
    path = os.path.join(d, "chain.cuh")
    with open(path) as f:
        text = f.read()
    a = text.index("void chain_band_mma(")
    b = text.index("// The Schur update", a)
    for pat, rep in patches:
        part, n = re.subn(pat, rep, text[a:b], flags=re.S)
        if n != 1:
            raise SystemExit(f"{label}: {pat!r} matched {n} times")
        text = text[:a] + part + text[b:]
        b = a + len(part)
    with open(path, "w") as f:
        f.write(text)
    so = os.path.join(d, "flk.so")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    return subprocess.Popen([_build._nvcc(), *flags, "-o", so,
                             os.path.join(d, "flk.cu")]), so


def _launcher(lib):
    """A function (pool, linv, uinv, tp, group) running ``group``'s bf16
    passes through ``lib``'s entries (whose signatures are the shipped
    ones)."""
    ch, sm = lib.slu_flk_chunks_bf16, lib.slu_flk_sum_bf16
    ch.argtypes = _flk.KERNEL_BF16.entries["slu_flk_chunks_bf16"]
    sm.argtypes = _flk.KERNEL_BF16.entries["slu_flk_sum_bf16"]
    ch.restype = sm.restype = ctypes.c_int

    def go(pool, linv, uinv, tp, group):
        import torch

        from ..ops.kernels._build import ptr, stream_ptr
        q0, q1 = int(tp.qptr[group]), int(tp.qptr[group + 1])
        if q1 == q0:
            return
        bs, stream = pool.shape[-1], stream_ptr(pool.device)
        nrow = int(tp.nrow[group])
        scratch = torch.empty((nrow, bs, bs), device=pool.device) \
            if nrow else None
        sp = ptr(scratch) if nrow else None
        _flk.KERNEL_BF16.check("slu_flk_chunks_bf16", ch(
            ptr(pool), ptr(linv), ptr(uinv), sp, ptr(tp.qtgt[q0:]),
            ptr(tp.qrow[q0:]), ptr(tp.qcptr[q0:]), ptr(tp.tslot),
            ptr(tp.tstep), ptr(tp.tfin), ptr(tp.cl), ptr(tp.cu), q1 - q0, bs,
            -1, stream))
        m0, m1 = int(tp.mptr[group]), int(tp.mptr[group + 1])
        if m1 > m0:
            _flk.KERNEL_BF16.check("slu_flk_sum_bf16", sm(
                ptr(pool), ptr(linv), ptr(uinv), sp, ptr(tp.mtgt[m0:]),
                ptr(tp.mrow[m0:]), ptr(tp.mcnt[m0:]), ptr(tp.tslot),
                ptr(tp.tstep), ptr(tp.tfin), m1 - m0, bs, -1, stream))
    return go


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


def _fact_turns(torch, A, lu, old_go, what):
    """Warm FACT under "auto" by SamePattern_SameRowPerm refactors of
    ``lu``, flk's bf16 passes through OLD's entries (``old_go``) or the
    shipped ones, in turns old, new, new, old after one untimed call
    through each; prints each call's FACT device ms, steps and berr."""
    from .. import Fact, gssvx
    shipped = _flk.flk_update

    def through_old(pool, linv, uinv, tp, group, wide=-1,
                    precision="highest"):
        if precision != "default":
            return shipped(pool, linv, uinv, tp, group, wide, precision)
        _flk.KERNEL_BF16.count("slu_flk_chunks_bf16")
        old_go(pool, linv, uinv, tp, group)

    b = np.ones(A.shape[0])
    opts = lu.options.replace(fact=Fact.SAME_PATTERN_SAME_ROWPERM,
                              gemm_precision="auto")
    try:
        for i, lab in enumerate(("old", "new", "old", "new", "new", "old")):
            _flk.flk_update = through_old if lab == "old" else shipped
            lu._prec_sticky = False
            res, _ = gssvx(A, b, opts, lu=lu)
            torch.cuda.synchronize()
            if i < 2:
                continue
            dm = res.stat.device_ms
            print(f"  {what} warm FACT under auto, {lab}: {dm['FACT']:.3f} "
                  f"ms (gemm_precision "
                  f"{res.stat.counters['gemm_precision']}, "
                  f"{res.stat.refine_steps} refinement steps, berr "
                  f"{float(res.berr.max()):.2e})", flush=True)
    finally:
        _flk.flk_update = shipped


def main_bf16(old: str, ks) -> None:
    os.environ["CUDA_MODULE_LOADING"] = "EAGER"
    import torch

    from .. import Options, gssvx
    from ..ops import blocklu
    from ..ops.kernels import diag_lu
    from ..utils.testing import laplacian_3d
    if not torch.cuda.is_available():
        raise SystemExit("flk_ab needs a CUDA device")
    print("card:", _card(), flush=True)
    started = {lab: _start(lab, old, p) for lab, p in OLD_VARIANTS.items()}
    runs = {}
    for lab, (proc, so) in started.items():
        if proc.wait() != 0:
            raise SystemExit(f"nvcc failed for {lab}")
        runs[lab] = _launcher(ctypes.CDLL(so))
    runs["new"] = _launcher(_flk.KERNEL_BF16.lib())
    labels = ["old", "new"] + [lab for lab in runs if lab not in
                               ("old", "new")]
    order = labels + labels[::-1]
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for k in ks:
        A = laplacian_3d(k)
        _, lu = gssvx(A, np.ones(A.shape[0]),
                      Options(dtype="float32", block_size=128,
                              executor="flk", gemm_precision="highest"))
        _fact_turns(torch, A, lu, runs["old"], f"lap3d{k} flk")
        _, ilu = gssvx(A, np.ones(A.shape[0]),
                       Options(dtype="float32", block_size=128,
                               executor="flk", ilu_level=1,
                               gemm_precision="highest"))
        _fact_turns(torch, A, ilu, runs["old"], f"lap3d{k} ILU(1)")
        plan, tp = lu.plan, lu._ftapes
        pool = blocklu.init_pool(plan, lu._a3_data, np.float32, "cuda")
        linv = torch.zeros((plan.nb, plan.bs, plan.bs), device="cuda")
        uinv = torch.zeros_like(linv)
        tiny = torch.zeros(1, dtype=torch.int32, device="cuda")
        ng = 2 * tp.nlvl
        ms = {lab: np.zeros(ng) for lab in labels}
        same = dict.fromkeys(labels, True)
        for lab in labels:   # each library's runtime set up, untimed
            runs[lab](pool.clone(), linv, uinv, tp, 0)
        for g in range(ng):
            outs = {}
            for lab in order:
                a = pool.clone()
                flush.zero_()
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                runs[lab](a, linv, uinv, tp, g)
                ev[1].record()
                torch.cuda.synchronize()
                ms[lab][g] += ev[0].elapsed_time(ev[1]) / 2
                outs.setdefault(lab, a)
            for lab, a in outs.items():
                same[lab] &= bool(torch.equal(a, outs["old"]))
            del outs
            _flk.flk_update(pool, linv, uinv, tp, g, precision="default")
            if g % 2 == 0:
                lvl = g // 2
                lo, hi = int(tp.dptr[lvl]), int(tp.dptr[lvl + 1])
                diag_lu.diag_lu(pool, linv, uinv, tp.dslot[lo:hi],
                                tp.dstep[lo:hi], lu._thresh(), tiny)
        h = tp.host
        print(f"lap3d{k} flk bf16: {ng} groups, {len(h['qtgt'])} chunks",
              flush=True)
        for lab in labels:
            print(f"  {lab:34s} {ms[lab].sum():9.3f} ms per factor; "
                  f"bit-equal to old: {same[lab]}", flush=True)
        top = np.argsort(-ms["old"])[:5]
        work = np.zeros(ng)
        for g in top:
            lo, hi = int(tp.tptr[g]), int(tp.tptr[g + 1])
            q0, q1 = int(tp.qptr[g]), int(tp.qptr[g + 1])
            nfin = int(np.count_nonzero(h["tfin"][lo:hi] != _flk.FIN_NONE))
            nprod = int(h["cptr"][hi] - h["cptr"][lo])
            bw = _flk.band_width(plan.bs, q1 - q0, sms)
            work[g] = (nprod + nfin) * (plan.bs // bw) / sms
            print(f"  group {g // 2}{'p' if g % 2 else 'd'}: {hi - lo} "
                  f"targets, {nprod} products, {nfin} finalizes, "
                  f"{q1 - q0} chunks, {int(tp.mptr[g + 1] - tp.mptr[g])} "
                  f"pass-2 targets, bands of {bw}; " + ", ".join(
                      f"{lab} {ms[lab][g]:.3f} ms ("
                      f"{1e3 * ms[lab][g] / work[g]:.3f} us)"
                      for lab in labels), flush=True)
        per = {lab: 1e3 * ms[lab][top].sum() / work[top].sum()
               for lab in labels}
        bar = per["old barriers only"]
        print(f"  split of old's {per['old']:.3f} us per band product an "
              f"SM on those groups: barriers and loop {bar:.3f}, fragments "
              f"and mma {per['old resident stage'] - bar:.3f}, bytes in "
              f"flight {per['old staging only'] - bar:.3f}; new "
              f"{per['new']:.3f}", flush=True)


if __name__ == "__main__":
    args = sys.argv[1:]
    if args[:1] == ["--bf16"]:
        main_bf16(args[1], [int(a) for a in args[2:]] or [32, 50])
    else:
        main([int(a) for a in args] or [32, 50])
