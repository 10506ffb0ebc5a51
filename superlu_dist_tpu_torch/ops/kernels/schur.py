"""Kernels 6–8: the level-by-level (right-looking) factor executor.

Counterpart of the factor half of the JAX package's
``ops/kernels/pallas_exec.py`` (``pallas_factor_meta``,
``_pallas_factor_executor``, ``build_factor_fn_pallas``), which
``executor="pallas"`` runs (and ``executor="xla"``, and every float64
factor, as the JAX package runs its level-batched XLA executor there).
Per elimination level, on one stream:

1. ``diag_lu`` (``csrc/diag_lu.cu``) on the level's diagonal blocks (the
   JAX package's XLA ``block_lu_inv`` batch);
2. ``trsm`` (``csrc/schur.cu``, ``left=False``): L(i,k) ← L(i,k)·uinv(k);
3. ``trsm`` (``left=True``): U(k,j) ← linv(k)·U(k,j) (both flags, and
   ``clk.clk_trsm``, run the band-times-inverse kernel of
   ``csrc/panel.cuh``: one CTA per band of whole rows, or columns, of a
   panel, the band and the inverse staged in shared memory);
4. ``schur`` (``csrc/schur.cu`` on ``csrc/chain.cuh``'s staged chain
   product): T −= L·U over the level's Schur triples, grouped by target.

The TPU's window scheduling and bucket padding (pallas_exec.py:191-342)
keep two DMA lanes off one target on its sequential grid; here each
target's triples form one CSR row that one CTA per band of the target
sums in order.
``blocklu.factor_plain`` is the same composition in plain PyTorch (and
the independent float64 reference); :func:`schur_plain` and
:func:`trsm_plain` are its per-phase pieces.

:func:`factor_batch` runs the four phases over every member of a stacked
pool (the counterpart of the JAX package's ``jax.vmap`` of its level core
in ``models/batch.py``): one launch per level per phase for all members,
the member on ``blockIdx.z`` of the ``_batch`` entries, one set of tapes,
a threshold and a tiny counter per member.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..blocklu import level_order, subtract_products
from ..host.symbolic import SymbolicPlan
from ._build import CudaKernel, ptr, stream_ptr
from .diag_lu import (CUDA_BLOCK_SIZES, CUDA_DTYPES, DTYPE_NAMES, at,
                      check_members, diag_lu, diag_lu_batch, entry,
                      member_chunks)

_V = ctypes.c_void_p
_I = ctypes.c_int
SCHUR = CudaKernel("schur", "schur.cu", {
    f"slu_schur_{s}": [_V] * 5 + [_I, _I, _I, _V]
    for s in CUDA_DTYPES.values()})
TRSM = CudaKernel("trsm", "schur.cu", {
    f"slu_trsm_{s}": [_V] * 4 + [_I, _I, _I, _V]
    for s in CUDA_DTYPES.values()})
_LL = ctypes.c_longlong
SCHUR_BATCH = CudaKernel("schur_batch", "schur.cu", {
    f"slu_schur_batch_{s}": [_V] * 5 + [_I] * 3 + [_LL, _V]
    for s in CUDA_DTYPES.values()})
TRSM_BATCH = CudaKernel("trsm_batch", "schur.cu", {
    f"slu_trsm_batch_{s}": [_V] * 4 + [_I] * 4 + [_LL, _LL, _V]
    for s in CUDA_DTYPES.values()})


@dataclasses.dataclass
class LevelTapes:
    """Per-level lists of the level executor. ``*ptr`` are host int64
    level pointers; every other field is an int32 tensor on the device.

    - diag_lu: ``dslot``/``dstep`` over ``dptr``;
    - trsm: L panels ``lslot``/``lstep`` over ``lptr``, U panels
      ``uslot``/``ustep`` over ``uptr``;
    - schur: level l's targets ``tslot[sptr[l]:sptr[l+1]]``; target t
      sums ``pool[cl[p]]·pool[cu[p]]`` for p over ``cptr[t]:cptr[t+1]``.
    """

    nlvl: int
    dptr: np.ndarray
    dslot: torch.Tensor
    dstep: torch.Tensor
    lptr: np.ndarray
    lslot: torch.Tensor
    lstep: torch.Tensor
    uptr: np.ndarray
    uslot: torch.Tensor
    ustep: torch.Tensor
    sptr: np.ndarray
    tslot: torch.Tensor
    cptr: torch.Tensor
    cl: torch.Tensor
    cu: torch.Tensor
    # host copies for the plain version and for work counts
    host: dict


def build_level_tapes(plan: SymbolicPlan, device) -> LevelTapes:
    lv = level_order(plan)
    nlvl = plan.n_flevels
    gptr = np.asarray(lv["gptr"], dtype=np.int64)
    g_t = lv["g_t"].astype(np.int64)
    # group each level's triples by target; the stable sort keeps the
    # plan's order within a target
    glvl = np.repeat(np.arange(nlvl), np.diff(gptr))
    key = glvl * (plan.nslots + 2) + g_t
    o = np.argsort(key, kind="stable")
    key = key[o]
    first = np.flatnonzero(np.r_[True, key[1:] != key[:-1]]) if len(key) \
        else np.zeros(0, dtype=np.int64)
    cptr = np.r_[first, len(key)].astype(np.int64)
    sptr = np.searchsorted(glvl[o][first], np.arange(nlvl + 1))
    host = dict(dslot=np.asarray(plan.diag_slot)[lv["dstep"]],
                dstep=lv["dstep"], lslot=lv["l_slot"], lstep=lv["l_step"],
                uslot=lv["u_slot"], ustep=lv["u_step"], tslot=g_t[o][first],
                cptr=cptr, cl=lv["g_l"][o], cu=lv["g_u"][o])

    def dev(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int32), device=device)

    return LevelTapes(nlvl=nlvl, dptr=np.asarray(lv["dptr"]),
                      lptr=np.asarray(lv["lptr"]),
                      uptr=np.asarray(lv["uptr"]), sptr=sptr, host=host,
                      **{k: dev(v) for k, v in host.items()})


# ---------------------------------------------------------------------------
# trsm: panel solve by a stored inverse
# ---------------------------------------------------------------------------


#: the pass precisions of the products (the JAX package's
#: ``precision`` values): "highest" in the working type; "default" one
#: bf16 pass with float32 accumulation (float32 only: clk's low pass)
PRECISIONS = ("highest", "default")


def check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, not "
                         f"{precision!r}")


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (nearest even), back in its float type."""
    return t.to(torch.bfloat16).to(t.dtype)


def matmul_at(a: torch.Tensor, b: torch.Tensor,
              precision: str = "highest") -> torch.Tensor:
    """a @ b at ``precision``: at "default" both operands are rounded to
    bf16 and multiplied in float32, where each product of two bf16 values
    is exact, as a tensor core's bf16 pass with float32 accumulation
    computes it up to the order of the sums (TF32 stays off)."""
    if precision == "default":
        if a.dtype != torch.float32 or b.dtype != torch.float32:
            raise ValueError("the bf16 pass takes float32 operands")
        return _bf16(a) @ _bf16(b)
    return a @ b


def trsm_plain(pool, dinv, slots, steps, left: bool,
               precision: str = "highest") -> None:
    """Plain version of :func:`trsm` (and of ``clk.clk_trsm``, whose
    products may run at ``precision``)."""
    check_precision(precision)
    if len(slots):
        s, k = slots.long(), steps.long()
        pool[s] = (matmul_at(dinv[k], pool[s], precision) if left
                   else matmul_at(pool[s], dinv[k], precision))


def trsm(pool, dinv, slots, steps, left: bool) -> None:
    """In place over ``slots`` (int32): X ← X·dinv[step] (L panels,
    ``left=False``) or X ← dinv[step]·X (U panels, ``left=True``)."""
    if pool.device.type == "cpu":
        return trsm_plain(pool, dinv, slots, steps, left)
    _check_cuda(pool, dinv)
    if len(slots) == 0:
        return
    fn = entry("trsm", pool)
    TRSM.count(fn)
    TRSM.call(fn, ptr(pool), ptr(dinv), ptr(slots), ptr(steps), len(slots),
              pool.shape[-1], int(left), stream_ptr(pool.device))


# ---------------------------------------------------------------------------
# schur: the level's Schur update, grouped by target
# ---------------------------------------------------------------------------


def schur_plain(pool, tp: LevelTapes, level: int) -> None:
    """Plain version of :func:`schur`."""
    h = tp.host
    lo, hi = int(tp.sptr[level]), int(tp.sptr[level + 1])
    c0, c1 = int(h["cptr"][lo]), int(h["cptr"][hi])
    dst = np.repeat(h["tslot"][lo:hi], np.diff(h["cptr"][lo:hi + 1]))
    subtract_products(pool, h["cl"][c0:c1], h["cu"][c0:c1], dst)


def schur(pool, tp: LevelTapes, level: int, wide: int = -1) -> None:
    """T −= Σ L·U over the Schur triples of ``level`` (in place), one CTA
    per (target, band of whole columns). ``wide`` < 0 lets the kernel
    choose its bands (``csrc/chain.cuh``, ``flk.band_width``), 0 / 1
    force bands of 16 / 64 (complex128 takes bands of 16 always)."""
    if pool.device.type == "cpu":
        return schur_plain(pool, tp, level)
    _check_cuda(pool)
    lo, hi = int(tp.sptr[level]), int(tp.sptr[level + 1])
    if hi == lo:
        return
    fn = entry("schur", pool)
    SCHUR.count(fn)
    SCHUR.call(fn, ptr(pool), ptr(tp.tslot[lo:hi]),
               ptr(tp.cptr[lo:hi + 1]), ptr(tp.cl), ptr(tp.cu), hi - lo,
               pool.shape[-1], wide, stream_ptr(pool.device))


def _check_cuda(pool, *invs):
    bs = pool.shape[-1]
    if pool.device.type != "cuda":
        raise ValueError(f"schur/trsm: unsupported device {pool.device}")
    for t in (pool,) + invs:
        if t.dtype not in CUDA_DTYPES or t.dtype != pool.dtype \
                or not t.is_contiguous() or t.device != pool.device \
                or t.shape[-2:] != (bs, bs):
            raise ValueError("schur/trsm: pool and inverses must be "
                             "contiguous (., bs, bs) tensors of one dtype "
                             f"({DTYPE_NAMES}) on one device")
    if bs not in CUDA_BLOCK_SIZES:
        raise ValueError(f"schur/trsm: block size {bs} not in "
                         f"{CUDA_BLOCK_SIZES}")


# ---------------------------------------------------------------------------
# the whole factor
# ---------------------------------------------------------------------------


def factor_level(pool, linv, uinv, tiny, thresh, tp: LevelTapes,
                 level: int) -> None:
    """The four phases of one elimination level."""
    d = slice(int(tp.dptr[level]), int(tp.dptr[level + 1]))
    lp = slice(int(tp.lptr[level]), int(tp.lptr[level + 1]))
    up = slice(int(tp.uptr[level]), int(tp.uptr[level + 1]))
    diag_lu(pool, linv, uinv, tp.dslot[d], tp.dstep[d], thresh, tiny)
    trsm(pool, uinv, tp.lslot[lp], tp.lstep[lp], left=False)
    trsm(pool, linv, tp.uslot[up], tp.ustep[up], left=True)
    schur(pool, tp, level)


def factor(pool, thresh: float, tp: LevelTapes, nb: int):
    """Factor ``pool`` in place. Returns (pool, linv, uinv, tiny) with
    linv/uinv of shape (nb, bs, bs) and tiny an int32 tensor (1,)."""
    bs = pool.shape[-1]
    linv = torch.zeros((nb, bs, bs), dtype=pool.dtype, device=pool.device)
    uinv = torch.zeros_like(linv)
    tiny = torch.zeros(1, dtype=torch.int32, device=pool.device)
    for level in range(tp.nlvl):
        factor_level(pool, linv, uinv, tiny, thresh, tp, level)
    return pool, linv, uinv, tiny


# ---------------------------------------------------------------------------
# the stacked form: every member of a batch per launch
# ---------------------------------------------------------------------------


def trsm_batch_plain(pool, dinv, slots, steps, left: bool) -> None:
    """Plain version of :func:`trsm_batch`: :func:`trsm_plain` on each
    member."""
    for m in range(pool.shape[0]):
        trsm_plain(pool[m], dinv[m], slots, steps, left)


def trsm_batch(pool, dinv, slots, steps, left: bool) -> None:
    """:func:`trsm` on every member of a stacked ``pool`` (members, rows,
    bs, bs) with its ``dinv`` (members, nb, bs, bs) and shared
    ``slots``/``steps``: one launch per chunk of members."""
    if pool.device.type == "cpu":
        return trsm_batch_plain(pool, dinv, slots, steps, left)
    _check_cuda(pool, dinv)
    check_members(pool, dinv)
    if len(slots) == 0:
        return
    fn = entry("trsm_batch", pool)
    ps, vs = pool[0].numel(), dinv[0].numel()
    for m0, cnt in member_chunks(pool.shape[0]):
        TRSM_BATCH.count(fn)
        TRSM_BATCH.call(fn, at(pool, m0 * ps), at(dinv, m0 * vs), ptr(slots),
                        ptr(steps), len(slots), pool.shape[-1], int(left),
                        cnt, ps, vs, stream_ptr(pool.device))


def schur_batch_plain(pool, tp: LevelTapes, level: int) -> None:
    """Plain version of :func:`schur_batch`: :func:`schur_plain` on each
    member."""
    for m in range(pool.shape[0]):
        schur_plain(pool[m], tp, level)


def schur_batch(pool, tp: LevelTapes, level: int) -> None:
    """:func:`schur` on every member of a stacked ``pool`` (members, rows,
    bs, bs): one launch per chunk of members, the bands chosen from one
    member's targets as :func:`schur` chooses them when not forced."""
    if pool.device.type == "cpu":
        return schur_batch_plain(pool, tp, level)
    _check_cuda(pool)
    check_members(pool)
    lo, hi = int(tp.sptr[level]), int(tp.sptr[level + 1])
    if hi == lo:
        return
    fn = entry("schur_batch", pool)
    ps = pool[0].numel()
    for m0, cnt in member_chunks(pool.shape[0]):
        SCHUR_BATCH.count(fn)
        SCHUR_BATCH.call(fn, at(pool, m0 * ps), ptr(tp.tslot[lo:hi]),
                         ptr(tp.cptr[lo:hi + 1]), ptr(tp.cl), ptr(tp.cu),
                         hi - lo, pool.shape[-1], cnt, ps,
                         stream_ptr(pool.device))


def factor_level_batch(pool, linv, uinv, tiny, thresh, tp: LevelTapes,
                       level: int) -> None:
    """The four phases of one elimination level on every member."""
    d = slice(int(tp.dptr[level]), int(tp.dptr[level + 1]))
    lp = slice(int(tp.lptr[level]), int(tp.lptr[level + 1]))
    up = slice(int(tp.uptr[level]), int(tp.uptr[level + 1]))
    diag_lu_batch(pool, linv, uinv, tp.dslot[d], tp.dstep[d], thresh, tiny)
    trsm_batch(pool, uinv, tp.lslot[lp], tp.lstep[lp], left=False)
    trsm_batch(pool, linv, tp.uslot[up], tp.ustep[up], left=True)
    schur_batch(pool, tp, level)


def factor_batch(pool, thresh, tp: LevelTapes, nb: int):
    """Factor every member of the stacked ``pool`` (members, rows, bs, bs)
    in place, member m with threshold ``thresh[m]`` (a tensor of the
    element's real type on the pool's device). Returns (pool, linv, uinv,
    tiny): linv/uinv of shape (members, nb, bs, bs) and tiny an int32
    tensor (members,)."""
    members, bs = pool.shape[0], pool.shape[-1]
    linv = torch.zeros((members, nb, bs, bs), dtype=pool.dtype,
                       device=pool.device)
    uinv = torch.zeros_like(linv)
    tiny = torch.zeros(members, dtype=torch.int32, device=pool.device)
    for level in range(tp.nlvl):
        factor_level_batch(pool, linv, uinv, tiny, thresh, tp, level)
    return pool, linv, uinv, tiny
