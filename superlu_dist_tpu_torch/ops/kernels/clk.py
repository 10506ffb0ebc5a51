"""Kernel 2: the left-looking column factor (clk), level by level.

Counterpart of the JAX package's ``ops/kernels/clk.py``. The pool is
column major (``symbolic._renumber_column_major``): block column k is the
contiguous slot range U(j,k) for ascending j, the diagonal block, then
L(i,k) for ascending i. Per elimination level, three phases run on one
stream:

1. ``clk_update`` (``csrc/clk.cu``): for each column k of the level, every
   stored block (i,k) receives −Σ L(i,j)·U(j,k) over the column's U
   blocks U(j,k) with j < i and L(i,j) stored, and every U block is
   finalized as U(i,k) ← linv(i)·U(i,k) once its sum is complete;
2. ``diag_lu`` (``csrc/diag_lu.cu``) on the level's diagonal blocks;
3. ``clk_trsm`` (``csrc/clk.cu``, the band-times-inverse kernel of
   ``csrc/panel.cuh``, as ``schur.trsm``; in the bf16 pass
   ``panel.cuh``'s ``trsm_mma_kernel``): L(i,k) ← L(i,k)·uinv(k).

Columns of one level depend only on columns of lower levels, so the
level order gives the dependencies that the TPU kernel takes from its
sequential grid. The TPU kernel's 104-block panel cap (VMEM) has no
counterpart: the panel stays in device memory.

Inside a column, U(i,k) waits on U(j,k) only when L(i,j) is stored, so
phase 1 runs in *source-ready waves*: a U block without sources is final
in wave f = 0, one with sources in wave f(i) = 1 + max f(j) over them,
and the product L(i',j)·U(j,k) is applied in wave f(j) + 1 (every column
of a level shares the wave index). One launch per wave: each target of
the wave subtracts that wave's products in ascending j and, if its sum is
complete, is finalized. A target's sum therefore runs by source wave,
then ascending j, where ``clk_update_plain`` (the reference, the JAX
kernel's order) runs by ascending j.

``precision`` is the pass precision of the update's and the TRSM's
products (the JAX package's ``gemm_precision`` as the driver resolves
it): ``"highest"`` runs them in IEEE FP32 (``slu_clk_waves_f32``,
``slu_clk_trsm_f32``); ``"default"`` in one bf16 pass with float32
accumulation, as the TPU kernel's ``dot`` at precision ``"default"``
(clk.py:257-259 there), on the tensor cores (``slu_clk_waves_bf16``,
``slu_clk_trsm_bf16``, counted on ``UPDATE_BF16`` and ``TRSM_BF16``). It
rounds exactly the operands the TPU kernel rounds: linv and the U strip
in the finalize, L and the finalized U in the update, L and uinv in the
TRSM; the sums and the pool stay float32, and ``diag_lu`` is always full
precision. The plain versions round the same operands to bf16 (nearest
even) and multiply in float32, exactly, so they differ from the kernels
only in the order of the sums.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..blocklu import level_order
from ..host.symbolic import SymbolicPlan
from ._build import CudaKernel, ptr, stream_ptr
from .diag_lu import CUDA_BLOCK_SIZES, diag_lu
from .flk import FIN_NONE, FIN_U
from .schur import check_precision, matmul_at, trsm_plain

_V = ctypes.c_void_p
_I = ctypes.c_int
UPDATE = CudaKernel("clk_update", "clk.cu", {
    "slu_clk_waves_f32": [_V] * 9 + [_I, _I, _V]})
TRSM = CudaKernel("clk_trsm", "clk.cu", {
    "slu_clk_trsm_f32": [_V, _V, _V, _V, _I, _I, _V]})
#: the same kernels' bf16 pass (precision "default"), counted apart
_L = ctypes.c_int64
UPDATE_BF16 = CudaKernel("clk_update_bf16", "clk.cu", {
    "slu_clk_waves_bf16": [_V] * 10 + [_I, _I, _L, _L, _V]})
TRSM_BF16 = CudaKernel("clk_trsm_bf16", "clk.cu", {
    "slu_clk_trsm_bf16": [_V, _V, _V, _V, _I, _I, _V]})
#: the kernel and the C entry of each pass
_UPDATE = {"highest": (UPDATE, "slu_clk_waves_f32"),
           "default": (UPDATE_BF16, "slu_clk_waves_bf16")}
_TRSM = {"highest": (TRSM, "slu_clk_trsm_f32"),
         "default": (TRSM_BF16, "slu_clk_trsm_bf16")}

#: the bf16 wave kernel (``csrc/waves.cuh``'s ``WaveMma``): k per staged
#: chunk, the strip widths it takes, the depth of a ring where a wave fills
#: the card (the FP32 kernel's) and the deepest ring it takes; a wide strip
#: must still give WAVE_FILL CTAs an SM (on an H100 at bs 128, 1 and 2
#: were slower on lap3d32's longest lists, 8 on lap3d50's widest waves:
#: ``tools/clk_strip_ab.py --bf16``)
WAVE_KC = 32
WAVE_WIDTHS = (16, 32, 64)
WAVE_SHALLOW, WAVE_DEEP = 3, 8
WAVE_FILL = 4
#: an H100's SMs (as ``sweep.CHUNK_CTAS`` takes them), and the most shared
#: memory one CTA may take
SMS = 132
CTA_SMEM_MAX = 227 * 1024


@dataclasses.dataclass
class ClkTapes:
    """Per-level schedule of the clk factor. ``lwave``, ``wptr``,
    ``dptr`` and ``lptr`` are host int64 pointers; every other field is
    an int32 tensor on the device.

    - update, in waves: level l's waves are ``lwave[l]:lwave[l+1]``, wave
      w's targets ``wptr[w]:wptr[w+1]`` (longest product list first). A
      target t is the slot ``tslot[t]``; its products of the wave are
      L = ``cl[p]``, U = ``cu[p]`` for p in ``pptr[t]:pptr[t+1]``, in
      ascending source row j; ``tfin[t]`` is FIN_U when it is then
      finalized by linv(``tstep[t]``), else FIN_NONE;
    - diag: ``dslot``/``dstep`` over ``dptr``;
    - trsm: ``lslot``/``lstep`` over ``lptr``.

    ``host`` holds numpy copies of the wave tapes and the column jobs of
    the reference order (``clk_update_plain``): ``ucols[uptr[l]:
    uptr[l+1]]`` are level l's columns with U blocks; column k's U blocks
    are jobs ``col_job0[k] + t`` for t < ``col_dpos[k]``, at slot
    ``col_base[k] + t``; job q reads linv(``job_src[q]``) and the L blocks
    at slots ``job_la0[q]`` … ``+ job_lm[q]``, whose targets are
    ``dst[job_dst0[q]:]``. ``job_fwave[q]`` is job q's finalize wave
    within its level.
    """

    nlvl: int
    uptr: np.ndarray
    lwave: np.ndarray
    wptr: np.ndarray
    tslot: torch.Tensor
    tstep: torch.Tensor
    tfin: torch.Tensor
    pptr: torch.Tensor
    cl: torch.Tensor
    cu: torch.Tensor
    dptr: np.ndarray
    dslot: torch.Tensor
    dstep: torch.Tensor
    lptr: np.ndarray
    lslot: torch.Tensor
    lstep: torch.Tensor
    host: dict


def build_clk_tapes(plan: SymbolicPlan, device) -> ClkTapes:
    """Host tapes from the column-major slot order; raises ValueError if
    the exact-LU fill closure does not hold (an ILU plan)."""
    nb = plan.nb
    scol = np.asarray(plan.slot_col)
    srow = np.asarray(plan.slot_row)
    if np.any(np.diff(scol) < 0):
        raise ValueError("clk requires column-major slots")
    colptr = np.searchsorted(scol, np.arange(nb + 1))
    diag_slot = np.asarray(plan.diag_slot, dtype=np.int64)
    dpos = diag_slot - colptr[:nb]             # U blocks above the diagonal
    la0 = diag_slot + 1                        # first L slot of each column
    lm = colptr[1:] - la0                      # L blocks of each column

    col_job0 = np.concatenate([[0], np.cumsum(dpos)[:-1]])
    njobs = int(dpos.sum())
    job_col = np.repeat(np.arange(nb), dpos)
    job_t = np.arange(njobs) - col_job0[job_col]
    job_src = srow[colptr[job_col] + job_t]
    job_lm = lm[job_src]
    job_dst0 = np.concatenate([[0], np.cumsum(job_lm)[:-1]])
    # target slot in column k of every L block L(i, j) of every job
    nd = int(job_lm.sum())
    d_job = np.repeat(np.arange(njobs), job_lm)
    d_l = la0[job_src][d_job] + np.arange(nd) - job_dst0[d_job]
    d_row = srow[d_l]
    d_col = job_col[d_job]
    key = scol.astype(np.int64) * nb + srow
    tkey = d_col.astype(np.int64) * nb + d_row
    pos = np.searchsorted(key, tkey)
    if nd and not np.all((pos < len(key)) & (key[np.minimum(pos, len(key) - 1)]
                                             == tkey)):
        raise ValueError("fill closure violated (ILU plan?) — clk requires "
                         "exact-LU symbolic")

    lev = np.asarray(plan.step_level)
    lvo = level_order(plan)
    ucols = np.argsort(lev * nb + np.arange(nb), kind="stable")
    ucols = ucols[dpos[ucols] > 0]
    uptr = np.zeros(plan.n_flevels + 1, dtype=np.int64)
    uptr[1:] = np.cumsum(np.bincount(lev[ucols], minlength=plan.n_flevels))
    dstep = lvo["dstep"]
    host = dict(col_base=colptr[:nb], col_dpos=dpos, col_job0=col_job0,
                job_src=job_src, job_la0=la0[job_src], job_lm=job_lm,
                job_dst0=job_dst0, dst=pos, ucols=ucols,
                job_slot=colptr[job_col] + job_t,
                dslot=diag_slot[dstep], dstep=dstep,
                lslot=lvo["l_slot"], lstep=lvo["l_step"])
    lwave, wptr = _waves(host, plan.n_flevels, lev, job_col, d_job, d_l,
                         pos, len(scol))

    def dev(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int32), device=device)

    return ClkTapes(
        nlvl=plan.n_flevels, uptr=uptr, lwave=lwave, wptr=wptr,
        **{k: dev(host[k]) for k in ("tslot", "tstep", "tfin", "pptr", "cl",
                                     "cu")},
        dptr=np.asarray(lvo["dptr"]), dslot=dev(host["dslot"]),
        dstep=dev(host["dstep"]), lptr=np.asarray(lvo["lptr"]),
        lslot=dev(host["lslot"]), lstep=dev(host["lstep"]), host=host)


def _waves(h, nlvl, lev, job_col, d_job, d_l, pos, nslots):
    """The wave tapes of the update (see :class:`ClkTapes`) from the
    column jobs in ``h`` (job q in column ``job_col[q]``, of level
    ``lev[job_col[q]]``) and the products (job ``d_job``, L slot ``d_l``,
    target slot ``pos``); adds them to ``h`` and returns (lwave, wptr)."""
    job_slot, job_src = h["job_slot"], h["job_src"]
    njobs = len(job_src)
    job_lev = lev[job_col]
    # position of each product's target in its column; the target is a U
    # block (a job) when it lies above the diagonal
    d_col = job_col[d_job]
    tpos = pos - h["col_base"][d_col]
    u = tpos < h["col_dpos"][d_col]
    tj = (h["col_job0"][d_col] + tpos)[u]
    sj, tp = d_job[u], tpos[u]
    o = np.argsort(tp, kind="stable")
    tj, sj, tp = tj[o], sj[o], tp[o]
    # finalize wave f of every job, by ascending target position: a
    # source sits above its target, so its f is final when it is read
    f = np.zeros(njobs, dtype=np.int64)
    cuts = np.flatnonzero(np.diff(tp)) + 1
    for a, b in zip(np.r_[0, cuts], np.r_[cuts, len(tp)]):
        np.maximum.at(f, tj[a:b], f[sj[a:b]] + 1)
    pw = f[d_job] + 1                          # each product's wave
    nw = np.zeros(nlvl, dtype=np.int64)
    np.maximum.at(nw, job_lev, f + 1)
    np.maximum.at(nw, job_lev[d_job], pw + 1)
    lwave = np.concatenate([[0], np.cumsum(nw)])
    # targets: (global wave, slot) of every product and every finalize
    pkey = (lwave[job_lev[d_job]] + pw) * nslots + pos
    fkey = (lwave[job_lev] + f) * nslots + job_slot
    tkeys = np.unique(np.concatenate([pkey, fkey]))
    pt = np.searchsorted(tkeys, pkey)
    cnt = np.bincount(pt, minlength=len(tkeys))
    fin = np.full(len(tkeys), FIN_NONE, dtype=np.int64)
    step = np.zeros(len(tkeys), dtype=np.int64)
    ft = np.searchsorted(tkeys, fkey)
    fin[ft] = FIN_U
    step[ft] = job_src
    tgw, tslot = tkeys // nslots, tkeys % nslots
    # per wave the longest product lists first, so that they start first
    order = np.lexsort((tslot, -cnt, tgw))
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    pj = job_src[d_job]
    po = np.lexsort((pj, rank[pt]))
    h.update(tslot=tslot[order], tstep=step[order], tfin=fin[order],
             pptr=np.concatenate([[0], np.cumsum(cnt[order])]),
             cl=d_l[po], cu=job_slot[d_job][po], pj=pj[po], job_fwave=f)
    return lwave, np.searchsorted(tgw[order], np.arange(lwave[-1] + 1))


# ---------------------------------------------------------------------------
# phase 1: left-looking update
# ---------------------------------------------------------------------------


def wave_stage_bytes(bs: int, tn: int) -> int:
    """One stage of the bf16 wave kernel's ring at block size ``bs`` and
    strip width ``tn``: an L chunk (bs rows of KC floats), a U chunk (KC
    rows of tn floats), both unpadded as the tensor maps write them, and
    its two mbarriers."""
    return (bs * WAVE_KC + WAVE_KC * tn) * 4 + 16


def wave_mma_bytes(bs: int, tn: int, stages: int) -> int:
    """Shared memory of the bf16 wave kernel (``WaveMma::bytes``):
    ``stages`` ring stages, 1024 bytes to align the ring to the swizzle's
    period, and the finalize operand (tn rows of bs + 8 bf16)."""
    return stages * wave_stage_bytes(bs, tn) + 1024 + tn * (bs + 8) * 2


def wave_max_stages(bs: int, tn: int) -> int:
    """The deepest ring the bf16 wave kernel takes (``WaveMma::
    kMaxStages``): WAVE_DEEP, or fewer where CTA_SMEM_MAX holds fewer."""
    return min(WAVE_DEEP, (CTA_SMEM_MAX - 1024 - tn * (bs + 8) * 2)
               // wave_stage_bytes(bs, tn))


def wave_geom(bs: int, ntargets: int, sms: int = SMS) -> tuple:
    """(strip width, ring depth) of a bf16 wave of ``ntargets`` targets:
    where strips of 16 columns would leave SMs idle, strips of 16 and the
    deepest ring; else the widest strip whose CTAs still give WAVE_FILL an
    SM (each L chunk then enters fewer SMs), at the FP32 kernel's depth."""
    if ntargets * (bs // 16) < sms:
        return 16, wave_max_stages(bs, 16)
    tn = max(w for w in WAVE_WIDTHS if w == 16 or (
        w <= bs and ntargets * (bs // w) >= WAVE_FILL * sms))
    return tn, WAVE_SHALLOW


def wave_geom_choices(bs: int) -> list:
    """Every (strip width, ring depth) that :func:`wave_geom` may give at
    block size ``bs``."""
    return sorted({wave_geom(bs, n)
                   for n in range(1, 2 * WAVE_FILL * SMS + 1)})


def wave_geoms(tp, bs: int) -> np.ndarray:
    """The geometry code (strip width << 8 | ring depth) of every wave of
    ``tp`` (clk's tapes, or tck's phase-A tapes) at block size ``bs``, by
    :func:`wave_geom` (cached in ``tp.host``)."""
    key = f"wave_geoms{bs}"
    if key not in tp.host:
        cnt = np.diff(np.asarray(tp.wptr))
        tp.host[key] = np.array(
            [(tn << 8) | st for tn, st in (wave_geom(bs, int(n))
                                           for n in cnt)], dtype=np.int32)
    return tp.host[key]


def clk_update_plain(pool, linv, tp: ClkTapes, level: int,
                     precision: str = "highest") -> None:
    """Plain version of :func:`clk_update`, in the reference order: per
    column, each U(j,k) in ascending j is finalized and then multiplies
    every L block of column j."""
    check_precision(precision)
    h = tp.host
    dev = pool.device
    for k in h["ucols"][tp.uptr[level]:tp.uptr[level + 1]]:
        base, q0 = int(h["col_base"][k]), int(h["col_job0"][k])
        for t in range(int(h["col_dpos"][k])):
            q = q0 + t
            U = matmul_at(linv[int(h["job_src"][q])], pool[base + t],
                          precision)
            pool[base + t] = U
            lm, a0 = int(h["job_lm"][q]), int(h["job_la0"][q])
            if lm:
                d0 = int(h["job_dst0"][q])
                tgt = torch.as_tensor(h["dst"][d0:d0 + lm], device=dev)
                pool.index_add_(0, tgt,
                                matmul_at(pool[a0:a0 + lm], U, precision),
                                alpha=-1)


def clk_update_waves_plain(pool, linv, tp: ClkTapes, level: int,
                           precision: str = "highest") -> None:
    """:func:`clk_update` by the wave tapes, in the kernel's order: per
    wave, every target subtracts its products in list order, then the
    FIN_U targets are finalized. It checks the tapes on the CPU, and is
    the plain version of tck's phase A (``tck.tck_waves_plain``) on tck's
    wave tapes."""
    check_precision(precision)
    h = tp.host
    dev = pool.device
    for w in range(int(tp.lwave[level]), int(tp.lwave[level + 1])):
        t0, t1 = int(tp.wptr[w]), int(tp.wptr[w + 1])
        p0, p1 = int(h["pptr"][t0]), int(h["pptr"][t1])
        ts = torch.as_tensor(h["tslot"][t0:t1], device=dev)
        T = pool[ts]
        if p1 > p0:
            row = np.repeat(np.arange(t1 - t0), np.diff(h["pptr"][t0:t1 + 1]))
            L = pool[torch.as_tensor(h["cl"][p0:p1], device=dev)]
            U = pool[torch.as_tensor(h["cu"][p0:p1], device=dev)]
            T.index_add_(0, torch.as_tensor(row, device=dev),
                         matmul_at(L, U, precision), alpha=-1)
        fin = torch.as_tensor(h["tfin"][t0:t1] == FIN_U, device=dev)
        if bool(fin.any()):
            st = torch.as_tensor(h["tstep"][t0:t1], device=dev)[fin]
            T[fin] = matmul_at(linv[st], T[fin], precision)
        pool[ts] = T


def clk_update(pool, linv, tp: ClkTapes, level: int,
               precision: str = "highest") -> None:
    """Left-looking update of the columns of ``level`` (in place), its
    products at ``precision``."""
    check_precision(precision)
    if pool.device.type == "cpu":
        return clk_update_plain(pool, linv, tp, level, precision)
    _check_cuda(pool, linv, pool.shape[-1])
    launch_waves(*_UPDATE[precision], pool, linv, tp, level)


def launch_waves(kernel, fn, pool, linv, tp, level: int,
                 geom: tuple | None = None) -> None:
    """One launch per wave of ``level`` on the tapes ``tp`` (clk's, or
    tck's phase A), issued by the C entry ``fn`` of ``kernel`` from the
    host array ``wptr``; a bf16 entry also takes each wave's geometry
    (:func:`wave_geoms`, or ``geom`` = (strip width, ring depth) forced on
    every wave, as the card tests force each one) and the pool's and
    linv's block counts (its tensor maps' extents)."""
    w0, w1 = int(tp.lwave[level]), int(tp.lwave[level + 1])
    bs = pool.shape[-1]
    if geom is not None:
        tn, st = geom
        if not fn.endswith("_bf16") or tn not in WAVE_WIDTHS or tn > bs \
                or not 2 <= st <= wave_max_stages(bs, tn):
            raise ValueError(f"{fn}: no wave geometry {geom} at block size "
                             f"{bs}")
    if w1 == w0:
        return
    kernel.count(fn, w1 - w0)
    args = [ptr(pool), ptr(linv), ptr(tp.tslot), ptr(tp.tstep),
            ptr(tp.tfin), ptr(tp.pptr), ptr(tp.cl), ptr(tp.cu),
            ctypes.c_void_p(tp.wptr.ctypes.data + 8 * w0)]
    if not fn.endswith("_bf16"):
        kernel.call(fn, *args, w1 - w0, bs, stream_ptr(pool.device))
        return
    g = wave_geoms(tp, bs)[w0:w1] if geom is None else np.full(
        w1 - w0, (geom[0] << 8) | geom[1], dtype=np.int32)
    kernel.call(fn, *args, ctypes.c_void_p(g.ctypes.data), w1 - w0, bs,
                pool.shape[0], linv.shape[0], stream_ptr(pool.device))


# ---------------------------------------------------------------------------
# phase 3: L-part TRSM by the stored U inverse
# ---------------------------------------------------------------------------


def clk_trsm_plain(pool, uinv, tp: ClkTapes, level: int,
                   precision: str = "highest") -> None:
    """Plain version of :func:`clk_trsm`."""
    lo, hi = int(tp.lptr[level]), int(tp.lptr[level + 1])
    trsm_plain(pool, uinv, tp.lslot[lo:hi], tp.lstep[lo:hi], left=False,
               precision=precision)


def clk_trsm(pool, uinv, tp: ClkTapes, level: int,
             precision: str = "highest") -> None:
    """L(i,k) ← L(i,k)·uinv(k) for the L blocks of ``level`` (in place),
    the products at ``precision``."""
    check_precision(precision)
    if pool.device.type == "cpu":
        return clk_trsm_plain(pool, uinv, tp, level, precision)
    _check_cuda(pool, uinv, pool.shape[-1])
    _launch_trsm(pool, uinv, tp, level, precision)


def _launch_trsm(pool, uinv, tp: ClkTapes, level: int,
                 precision: str = "highest") -> None:
    lo, hi = int(tp.lptr[level]), int(tp.lptr[level + 1])
    if hi == lo:
        return
    kernel, fn = _TRSM[precision]
    kernel.count(fn)
    # int32 offsets into the tapes, without a tensor op on the launch path
    kernel.call(fn, ptr(pool), ptr(uinv), _V(tp.lslot.data_ptr() + 4 * lo),
                _V(tp.lstep.data_ptr() + 4 * lo), hi - lo, pool.shape[-1],
                stream_ptr(pool.device))


def _check_cuda(pool, inv, bs):
    if pool.device.type != "cuda":
        raise ValueError(f"clk: unsupported device {pool.device}")
    for t in (pool, inv):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != pool.device or t.shape[-2:] != (bs, bs):
            raise ValueError("clk: pool and inverses must be contiguous "
                             "float32 (., bs, bs) tensors on one device")
    if bs not in CUDA_BLOCK_SIZES:
        raise ValueError(f"clk: block size {bs} not in {CUDA_BLOCK_SIZES}")


# ---------------------------------------------------------------------------
# the whole factor
# ---------------------------------------------------------------------------


def factor_level(pool, linv, uinv, tiny, thresh, tp: ClkTapes,
                 level: int, precision: str = "highest") -> None:
    """The three phases of one elimination level; the update's and the
    TRSM's products at ``precision``, diag_lu in full precision."""
    lo, hi = int(tp.dptr[level]), int(tp.dptr[level + 1])
    clk_update(pool, linv, tp, level, precision)
    diag_lu(pool, linv, uinv, tp.dslot[lo:hi], tp.dstep[lo:hi], thresh, tiny)
    clk_trsm(pool, uinv, tp, level, precision)


def factor(pool, thresh: float, tp: ClkTapes, nb: int,
           precision: str = "highest"):
    """Factor ``pool`` in place, the products at ``precision`` (see the
    module docstring). Returns (pool, linv, uinv, tiny) with linv/uinv of
    shape (nb, bs, bs) and tiny an int32 tensor (1,)."""
    bs = pool.shape[-1]
    linv = torch.zeros((nb, bs, bs), dtype=pool.dtype, device=pool.device)
    uinv = torch.zeros_like(linv)
    tiny = torch.zeros(1, dtype=torch.int32, device=pool.device)
    for level in range(tp.nlvl):
        factor_level(pool, linv, uinv, tiny, thresh, tp, level, precision)
    return pool, linv, uinv, tiny
