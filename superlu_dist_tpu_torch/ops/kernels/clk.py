"""Kernel 2: the left-looking column factor (clk), level by level.

Counterpart of the JAX package's ``ops/kernels/clk.py``. The pool is
column major (``symbolic._renumber_column_major``): block column k is the
contiguous slot range U(j,k) for ascending j, the diagonal block, then
L(i,k) for ascending i. Per elimination level, three phases run on one
stream:

1. ``clk_update`` (``csrc/clk.cu``): for each column k of the level and
   each U(j,k) in ascending j, U(j,k) ← linv(j)·U(j,k), then
   panel(i) −= L(i,j)·U(j,k) for every L block of column j;
2. ``diag_lu`` (``csrc/diag_lu.cu``) on the level's diagonal blocks;
3. ``clk_trsm`` (``csrc/clk.cu``): L(i,k) ← L(i,k)·uinv(k).

Columns of one level depend only on columns of lower levels, so the
level order gives the dependencies that the TPU kernel takes from its
sequential grid. The TPU kernel's 104-block panel cap (VMEM) has no
counterpart: the panel stays in device memory.
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

_V = ctypes.c_void_p
_I = ctypes.c_int
UPDATE = CudaKernel("clk_update", "clk.cu", {
    "slu_clk_update_f32": [_V, _V, _V, _I] + [_V] * 8 + [_I, _V]})
TRSM = CudaKernel("clk_trsm", "clk.cu", {
    "slu_clk_trsm_f32": [_V, _V, _V, _V, _I, _I, _V]})


@dataclasses.dataclass
class ClkTapes:
    """Per-level schedule of the clk factor. ``*_ptr`` are host int64
    level pointers; every other field is an int32 tensor on the device.

    - update: ``ucols[uptr[l]:uptr[l+1]]`` are the level's columns with
      U blocks; column k's U blocks are jobs ``col_job0[k] + t`` for
      t < ``col_dpos[k]``, at slot ``col_base[k] + t``. Job q reads
      linv(``job_src[q]``) and the L blocks at slots ``job_la0[q]`` …
      ``+ job_lm[q]``, whose targets are ``dst[job_dst0[q]:]``;
    - diag: ``dslot``/``dstep`` over ``dptr``;
    - trsm: ``lslot``/``lstep`` over ``lptr``.
    """

    nlvl: int
    uptr: np.ndarray
    ucols: torch.Tensor
    col_base: torch.Tensor
    col_dpos: torch.Tensor
    col_job0: torch.Tensor
    job_src: torch.Tensor
    job_la0: torch.Tensor
    job_lm: torch.Tensor
    job_dst0: torch.Tensor
    dst: torch.Tensor
    dptr: np.ndarray
    dslot: torch.Tensor
    dstep: torch.Tensor
    lptr: np.ndarray
    lslot: torch.Tensor
    lstep: torch.Tensor
    # host copies for the plain version and for work counts
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
    d_row = srow[la0[job_src][d_job] + np.arange(nd) - job_dst0[d_job]]
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
                dslot=diag_slot[dstep], dstep=dstep,
                lslot=lvo["l_slot"], lstep=lvo["l_step"])

    def dev(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int32), device=device)

    return ClkTapes(
        nlvl=plan.n_flevels, uptr=uptr, ucols=dev(ucols),
        col_base=dev(host["col_base"]), col_dpos=dev(dpos),
        col_job0=dev(col_job0), job_src=dev(job_src),
        job_la0=dev(host["job_la0"]), job_lm=dev(job_lm),
        job_dst0=dev(job_dst0), dst=dev(pos),
        dptr=np.asarray(lvo["dptr"]), dslot=dev(host["dslot"]),
        dstep=dev(dstep), lptr=np.asarray(lvo["lptr"]),
        lslot=dev(host["lslot"]), lstep=dev(host["lstep"]), host=host)


# ---------------------------------------------------------------------------
# phase 1: left-looking update
# ---------------------------------------------------------------------------


def clk_update_plain(pool, linv, tp: ClkTapes, level: int) -> None:
    """Plain version of :func:`clk_update`."""
    h = tp.host
    dev = pool.device
    for k in h["ucols"][tp.uptr[level]:tp.uptr[level + 1]]:
        base, q0 = int(h["col_base"][k]), int(h["col_job0"][k])
        for t in range(int(h["col_dpos"][k])):
            q = q0 + t
            U = linv[int(h["job_src"][q])] @ pool[base + t]
            pool[base + t] = U
            lm, a0 = int(h["job_lm"][q]), int(h["job_la0"][q])
            if lm:
                d0 = int(h["job_dst0"][q])
                tgt = torch.as_tensor(h["dst"][d0:d0 + lm], device=dev)
                pool.index_add_(0, tgt, pool[a0:a0 + lm] @ U, alpha=-1)


def clk_update(pool, linv, tp: ClkTapes, level: int) -> None:
    """Left-looking update of the columns of ``level`` (in place)."""
    if pool.device.type == "cpu":
        return clk_update_plain(pool, linv, tp, level)
    _check_cuda(pool, linv, pool.shape[-1])
    _launch_update(pool, linv, tp, level)


def _launch_update(pool, linv, tp: ClkTapes, level: int) -> None:
    lo, hi = int(tp.uptr[level]), int(tp.uptr[level + 1])
    if hi == lo:
        return
    UPDATE.launches += 1
    UPDATE.call("slu_clk_update_f32", ptr(pool), ptr(linv),
                ptr(tp.ucols[lo:hi]), hi - lo, ptr(tp.col_base),
                ptr(tp.col_dpos), ptr(tp.col_job0), ptr(tp.job_src),
                ptr(tp.job_la0), ptr(tp.job_lm), ptr(tp.job_dst0),
                ptr(tp.dst), pool.shape[-1], stream_ptr(pool.device))


# ---------------------------------------------------------------------------
# phase 3: L-part TRSM by the stored U inverse
# ---------------------------------------------------------------------------


def clk_trsm_plain(pool, uinv, tp: ClkTapes, level: int) -> None:
    """Plain version of :func:`clk_trsm`."""
    lo, hi = int(tp.lptr[level]), int(tp.lptr[level + 1])
    if hi > lo:
        s = tp.lslot[lo:hi].long()
        pool[s] = pool[s] @ uinv[tp.lstep[lo:hi].long()]


def clk_trsm(pool, uinv, tp: ClkTapes, level: int) -> None:
    """L(i,k) ← L(i,k)·uinv(k) for the L blocks of ``level`` (in place)."""
    if pool.device.type == "cpu":
        return clk_trsm_plain(pool, uinv, tp, level)
    _check_cuda(pool, uinv, pool.shape[-1])
    _launch_trsm(pool, uinv, tp, level)


def _launch_trsm(pool, uinv, tp: ClkTapes, level: int) -> None:
    lo, hi = int(tp.lptr[level]), int(tp.lptr[level + 1])
    if hi == lo:
        return
    TRSM.launches += 1
    TRSM.call("slu_clk_trsm_f32", ptr(pool), ptr(uinv),
              ptr(tp.lslot[lo:hi]), ptr(tp.lstep[lo:hi]), hi - lo,
              pool.shape[-1], stream_ptr(pool.device))


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
                 level: int) -> None:
    """The three phases of one elimination level."""
    lo, hi = int(tp.dptr[level]), int(tp.dptr[level + 1])
    clk_update(pool, linv, tp, level)
    diag_lu(pool, linv, uinv, tp.dslot[lo:hi], tp.dstep[lo:hi], thresh, tiny)
    clk_trsm(pool, uinv, tp, level)


def factor(pool, thresh: float, tp: ClkTapes, nb: int):
    """Factor ``pool`` in place. Returns (pool, linv, uinv, tiny) with
    linv/uinv of shape (nb, bs, bs) and tiny an int32 tensor (1,)."""
    bs = pool.shape[-1]
    linv = torch.zeros((nb, bs, bs), dtype=pool.dtype, device=pool.device)
    uinv = torch.zeros_like(linv)
    tiny = torch.zeros(1, dtype=torch.int32, device=pool.device)
    for level in range(tp.nlvl):
        factor_level(pool, linv, uinv, tiny, thresh, tp, level)
    return pool, linv, uinv, tiny
