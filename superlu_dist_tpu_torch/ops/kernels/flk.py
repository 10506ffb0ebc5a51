"""Kernel 4: the fused left-looking factor (flk), level by level.

Counterpart of the JAX package's ``ops/kernels/flk.py``. Every stored
block (diagonal, L panel, U panel) is a target visited once: it
accumulates T −= Σ L(I,j)·U(j,K) over its contributions (the plan's
Schur triples into it), then finalizes. Per elimination level, on one
stream:

1. ``flk_update`` (``csrc/flk.cu``) on the level's diagonal targets;
2. ``diag_lu`` (``csrc/diag_lu.cu``) factors them (the TPU kernel's
   FIN_DIAG);
3. ``flk_update`` on the level's L panels (finalize T·uinv[k], FIN_L)
   and U panels (linv[k]·T, FIN_U).

A target of step k receives contributions only from steps at strictly
lower levels (flk.py:29-32), so the level order is exact, for exact-LU
and ILU(k) plans alike (an ILU plan holds only the triples into stored
blocks). The TPU's Kc windows, ``SYNC_DIST`` hazard analysis and
``SEG_W`` segments (flk.py:137-248) exist for its SMEM and its
sequential grid and have no counterpart here; so neither does
``flk_supported``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..blocklu import level_order, subtract_products
from ..host.symbolic import SymbolicPlan
from ._build import CudaKernel, ptr, stream_ptr
from .diag_lu import CUDA_BLOCK_SIZES, diag_lu

_V = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel("flk", "flk.cu", {
    "slu_flk_f32": [_V] * 9 + [_I, _I, _V]})

# finalize codes (the JAX package's values; FIN_DIAG is diag_lu)
FIN_NONE = 0
FIN_L = 2       # T ← T·uinv[step]
FIN_U = 3       # T ← linv[step]·T


@dataclasses.dataclass
class FlkTapes:
    """Per-level schedule of the flk factor. ``*ptr`` are host int64
    level pointers; every other field is an int32 tensor on the device.

    - diag_lu: ``dslot``/``dstep`` over ``dptr`` (every diagonal block);
    - flk_update: target group g = 2l is level l's diagonal targets that
      have contributions, g = 2l + 1 its L then U panels, over
      ``tptr[g]:tptr[g+1]`` of ``tslot``/``tstep``/``tfin``; target t
      sums ``pool[cl[p]]·pool[cu[p]]`` for p over ``cptr[t]:cptr[t+1]``
      (the plan's triples, stably sorted by target).
    """

    nlvl: int
    dptr: np.ndarray
    dslot: torch.Tensor
    dstep: torch.Tensor
    tptr: np.ndarray
    tslot: torch.Tensor
    tstep: torch.Tensor
    tfin: torch.Tensor
    cptr: torch.Tensor
    cl: torch.Tensor
    cu: torch.Tensor
    # host copies for the plain version and for work counts
    host: dict


def build_flk_tapes(plan: SymbolicPlan, device) -> FlkTapes:
    lv = level_order(plan)
    nlvl = plan.n_flevels
    g_t = np.asarray(plan.g_t, dtype=np.int64)
    ncon = np.bincount(g_t, minlength=plan.nslots + 2)
    dstep = lv["dstep"]
    dslot = np.asarray(plan.diag_slot, dtype=np.int64)[dstep]

    slots, steps, fins = [], [], []
    tptr = np.zeros(2 * nlvl + 1, dtype=np.int64)
    for l in range(nlvl):
        d = slice(lv["dptr"][l], lv["dptr"][l + 1])
        has = ncon[dslot[d]] > 0
        ls = slice(lv["lptr"][l], lv["lptr"][l + 1])
        us = slice(lv["uptr"][l], lv["uptr"][l + 1])
        groups = [(dslot[d][has], dstep[d][has], FIN_NONE),
                  (lv["l_slot"][ls], lv["l_step"][ls], FIN_L),
                  (lv["u_slot"][us], lv["u_step"][us], FIN_U)]
        for s, k, f in groups:
            slots.append(s)
            steps.append(k)
            fins.append(np.full(len(s), f))
        tptr[2 * l + 1] = tptr[2 * l] + len(groups[0][0])
        tptr[2 * l + 2] = tptr[2 * l + 1] + len(groups[1][0]) \
            + len(groups[2][0])
    tslot = np.concatenate(slots).astype(np.int64)
    # contributions in target order; a stable sort keeps the plan's order
    # within each target, so every sum runs in a fixed order
    pos = np.full(plan.nslots + 2, -1, dtype=np.int64)
    pos[tslot] = np.arange(len(tslot))
    tpos = pos[g_t]
    if np.any(tpos < 0):
        raise ValueError("a Schur triple targets a block that is not a "
                         "target of the flk schedule")
    o = np.argsort(tpos, kind="stable")
    cptr = np.zeros(len(tslot) + 1, dtype=np.int64)
    cptr[1:] = np.cumsum(np.bincount(tpos, minlength=len(tslot)))
    host = dict(dslot=dslot, dstep=dstep, tslot=tslot,
                tstep=np.concatenate(steps), tfin=np.concatenate(fins),
                cptr=cptr, cl=np.asarray(plan.g_l, dtype=np.int64)[o],
                cu=np.asarray(plan.g_u, dtype=np.int64)[o])

    def dev(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int32), device=device)

    return FlkTapes(nlvl=nlvl, dptr=np.asarray(lv["dptr"]),
                    tptr=tptr, host=host,
                    **{k: dev(v) for k, v in host.items()})


def flk_update_plain(pool, linv, uinv, tp: FlkTapes, group: int) -> None:
    """Plain version of :func:`flk_update`."""
    h = tp.host
    lo, hi = int(tp.tptr[group]), int(tp.tptr[group + 1])
    if hi == lo:
        return
    c0, c1 = int(h["cptr"][lo]), int(h["cptr"][hi])
    tslot = h["tslot"][lo:hi]
    dst = np.repeat(tslot, np.diff(h["cptr"][lo:hi + 1]))
    subtract_products(pool, h["cl"][c0:c1], h["cu"][c0:c1], dst)
    fin, step = h["tfin"][lo:hi], h["tstep"][lo:hi]
    dev = pool.device
    for code in (FIN_L, FIN_U):
        sel = fin == code
        if sel.any():
            s = torch.as_tensor(tslot[sel], device=dev)
            k = torch.as_tensor(step[sel], device=dev)
            pool[s] = pool[s] @ uinv[k] if code == FIN_L \
                else linv[k] @ pool[s]


def flk_update(pool, linv, uinv, tp: FlkTapes, group: int) -> None:
    """Accumulate and finalize the targets of ``group`` (in place)."""
    if pool.device.type == "cpu":
        return flk_update_plain(pool, linv, uinv, tp, group)
    _check_cuda(pool, linv, uinv)
    lo, hi = int(tp.tptr[group]), int(tp.tptr[group + 1])
    if hi == lo:
        return
    KERNEL.launches += 1
    KERNEL.call("slu_flk_f32", ptr(pool), ptr(linv), ptr(uinv),
                ptr(tp.tslot[lo:hi]), ptr(tp.tstep[lo:hi]),
                ptr(tp.tfin[lo:hi]), ptr(tp.cptr[lo:hi + 1]), ptr(tp.cl),
                ptr(tp.cu), hi - lo, pool.shape[-1], stream_ptr(pool.device))


def _check_cuda(pool, *invs):
    bs = pool.shape[-1]
    if pool.device.type != "cuda":
        raise ValueError(f"flk: unsupported device {pool.device}")
    for t in (pool,) + invs:
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != pool.device or t.shape[-2:] != (bs, bs):
            raise ValueError("flk: pool and inverses must be contiguous "
                             "float32 (., bs, bs) tensors on one device")
    if bs not in CUDA_BLOCK_SIZES:
        raise ValueError(f"flk: block size {bs} not in {CUDA_BLOCK_SIZES}")


def factor_level(pool, linv, uinv, tiny, thresh, tp: FlkTapes,
                 level: int) -> None:
    """The three phases of one elimination level."""
    lo, hi = int(tp.dptr[level]), int(tp.dptr[level + 1])
    flk_update(pool, linv, uinv, tp, 2 * level)
    diag_lu(pool, linv, uinv, tp.dslot[lo:hi], tp.dstep[lo:hi], thresh, tiny)
    flk_update(pool, linv, uinv, tp, 2 * level + 1)


def factor(pool, thresh: float, tp: FlkTapes, nb: int):
    """Factor ``pool`` in place. Returns (pool, linv, uinv, tiny) with
    linv/uinv of shape (nb, bs, bs) and tiny an int32 tensor (1,)."""
    bs = pool.shape[-1]
    linv = torch.zeros((nb, bs, bs), dtype=pool.dtype, device=pool.device)
    uinv = torch.zeros_like(linv)
    tiny = torch.zeros(1, dtype=torch.int32, device=pool.device)
    for level in range(tp.nlvl):
        factor_level(pool, linv, uinv, tiny, thresh, tp, level)
    return pool, linv, uinv, tiny
