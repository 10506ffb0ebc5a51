"""Block pool, level schedules and the right-looking reference factor.

Counterpart of the JAX package's ``ops/kernels/blocklu.py``:

- :func:`init_pool` scatters A into the flat ``(nslots + 2, bs, bs)``
  block pool (slot ``nslots`` is the zero block, ``nslots + 1`` the
  trash block, as in the JAX package; the port does not bucket-pad);
- :func:`level_order` groups per-step factor work by elimination level;
- :func:`trans_schedule` is the level schedule of the transposed solve's
  Uᵀ and Lᵀ sweeps (the JAX package's ``_trans_schedule``);
- :func:`factor_plain` is the level-batched right-looking factor of the
  JAX package's XLA executor (``_make_level_step`` with
  ``block_lu_inv``) in plain PyTorch: per level the diagonal batch, the
  L panels times U⁻¹, L⁻¹ times the U panels, then the Schur
  gather-GEMM-scatter-add. It is the independent reference that the clk,
  flk and level-executor factors are held against; it reads the plan's
  triples, so it serves ILU(k) plans too.
"""

from __future__ import annotations

import numpy as np
import torch

from .host.symbolic import SymbolicPlan
from .kernels.diag_lu import lu_inv_plain

#: Schur triples per gathered batch in :func:`factor_plain`
SCHUR_CHUNK = 256


def init_pool(plan: SymbolicPlan, a_data, dtype, device) -> torch.Tensor:
    """Scatter the (permuted, scaled) matrix values into the block pool.
    ``a_data`` is in the CSC data order of the matrix the plan was built
    from; padding diagonal entries get 1.0. Assembled on the host with
    ``np.add.at`` and copied to ``device`` once."""
    vals = np.asarray(a_data, dtype=dtype)
    bs = plan.bs
    idx = np.asarray(plan.init_idx)
    flat = np.zeros((plan.nslots + 2) * bs * bs, dtype=dtype)
    np.add.at(flat, idx[: len(vals)], vals)
    if plan.init_ones:
        flat[idx[len(vals):]] += 1
    return torch.from_numpy(flat.reshape(plan.nslots + 2, bs, bs)).to(device)


def level_order(plan: SymbolicPlan):
    """Group per-step factor work by elimination level (host side)."""
    nb = plan.nb
    nlvl = plan.n_flevels
    lev = np.asarray(plan.step_level)
    order = np.argsort(lev * nb + np.arange(nb), kind="stable")
    dptr = np.zeros(nlvl + 1, dtype=np.int64)
    dptr[1:] = np.cumsum(np.bincount(lev, minlength=nlvl))

    def regroup(ptr, *fields):
        ptr = np.asarray(ptr, dtype=np.int64)
        lens = ptr[order + 1] - ptr[order]
        starts = ptr[order]
        # positions of each step's range, concatenated in level order
        sel = (np.repeat(starts - np.cumsum(lens) + lens, lens)
               + np.arange(int(lens.sum())))
        outs = [np.asarray(f)[sel].astype(np.int32) for f in fields]
        steps = np.repeat(order, lens).astype(np.int32)
        lptr = np.zeros(nlvl + 1, dtype=np.int64)
        lptr[1:] = np.cumsum(np.bincount(lev[order], weights=lens,
                                         minlength=nlvl)).astype(np.int64)
        return lptr, outs, steps

    lptr, (l_slot,), l_step = regroup(plan.l_ptr, plan.l_slots)
    uptr, (u_slot,), u_step = regroup(plan.u_ptr, plan.u_slots)
    gptr, (g_l, g_u, g_t), _ = regroup(plan.g_ptr, plan.g_l, plan.g_u,
                                       plan.g_t)
    return dict(dptr=dptr, dstep=order.astype(np.int32), lptr=lptr,
                l_slot=l_slot, l_step=l_step, uptr=uptr, u_slot=u_slot,
                u_step=u_step, gptr=gptr, g_l=g_l, g_u=g_u, g_t=g_t)


def trans_schedule(plan: SymbolicPlan, which: str):
    """Level schedule of a transposed sweep, as the JAX package's
    ``blocklu._trans_schedule`` builds it (same levels, same triple order).

    Uᵀ forward (``which="U"``): for each U block (I, J), I < J, the unknown
    z_J depends on z_I; Lᵀ backward (``"L"``): w_J depends on w_I for each
    L block (I, J), I > J. Block row J sits one level above its highest
    source. Returns (gptr, gslot, gsrc, gdst, dptr, diag, nlvl): the
    (slot, src, dst) triples of level l over ``gptr[l]:gptr[l+1]``, and
    its block rows ``diag[dptr[l]:dptr[l+1]]`` in ascending order."""
    nb = plan.nb
    if which == "U":
        ptr, slots, order = plan.u_ptr, plan.u_slots, range(nb)
    else:
        ptr, slots, order = plan.l_ptr, plan.l_slots, range(nb - 1, -1, -1)
    s = np.asarray(slots[int(ptr[0]):int(ptr[nb])], dtype=np.int64)
    dst = np.asarray(plan.slot_col, dtype=np.int64)[s]
    src = np.asarray(plan.slot_row, dtype=np.int64)[s]
    # each destination's sources in step order, then the slot lists' order
    o = np.argsort(dst, kind="stable")
    s, src, dst = s[o], src[o], dst[o]
    start = np.searchsorted(dst, np.arange(nb + 1))
    level = np.zeros(nb, dtype=np.int64)
    for J in order:
        if start[J + 1] > start[J]:
            level[J] = level[src[start[J]:start[J + 1]]].max() + 1
    nlvl = int(level.max()) + 1 if nb else 1
    o = np.argsort(level[dst], kind="stable")
    gptr = np.zeros(nlvl + 1, dtype=np.int64)
    gptr[1:] = np.cumsum(np.bincount(level[dst], minlength=nlvl))
    dptr = np.zeros(nlvl + 1, dtype=np.int64)
    dptr[1:] = np.cumsum(np.bincount(level, minlength=nlvl))
    diag = np.argsort(level, kind="stable")
    return gptr, s[o], src[o], dst[o], dptr, diag, nlvl


def factor_plain(plan: SymbolicPlan, pool: torch.Tensor, thresh: float):
    """Right-looking level-batched factor of ``pool`` in place.

    Returns (pool, linv, uinv, tiny) with linv/uinv of shape
    (nb, bs, bs) indexed by elimination step."""
    bs, nb = plan.bs, plan.nb
    dev = pool.device
    lv = level_order(plan)
    linv = torch.zeros((nb, bs, bs), dtype=pool.dtype, device=dev)
    uinv = torch.zeros_like(linv)
    tiny = 0
    diag_slot = np.asarray(plan.diag_slot, dtype=np.int64)

    def idx(a, lo, hi):
        return torch.as_tensor(np.asarray(a[lo:hi], dtype=np.int64),
                               device=dev)

    for l in range(plan.n_flevels):
        lo, hi = int(lv["dptr"][l]), int(lv["dptr"][l + 1])
        steps = lv["dstep"][lo:hi]
        st = idx(steps, 0, len(steps))
        dsl = torch.as_tensor(diag_slot[steps], device=dev)
        LU, li, ui, nt = lu_inv_plain(pool[dsl], thresh)
        pool[dsl] = LU
        linv[st] = li
        uinv[st] = ui
        tiny += int(nt)

        lo, hi = int(lv["lptr"][l]), int(lv["lptr"][l + 1])
        s, k = idx(lv["l_slot"], lo, hi), idx(lv["l_step"], lo, hi)
        pool[s] = pool[s] @ uinv[k]
        lo, hi = int(lv["uptr"][l]), int(lv["uptr"][l + 1])
        s, k = idx(lv["u_slot"], lo, hi), idx(lv["u_step"], lo, hi)
        pool[s] = linv[k] @ pool[s]

        lo, hi = int(lv["gptr"][l]), int(lv["gptr"][l + 1])
        subtract_products(pool, lv["g_l"][lo:hi], lv["g_u"][lo:hi],
                          lv["g_t"][lo:hi])
    return pool, linv, uinv, tiny


def subtract_products(pool: torch.Tensor, gl, gu, gt,
                      matmul=torch.matmul) -> None:
    """pool[gt[i]] −= pool[gl[i]]·pool[gu[i]] for every i, in order of i
    (host index arrays; gathered in batches of ``SCHUR_CHUNK``), each
    batch's products by ``matmul``."""
    dev = pool.device
    for c in range(0, len(gt), SCHUR_CHUNK):
        def idx(a):
            return torch.as_tensor(np.asarray(a[c:c + SCHUR_CHUNK],
                                              dtype=np.int64), device=dev)
        pool.index_add_(0, idx(gt), matmul(pool[idx(gl)], pool[idx(gu)]),
                        alpha=-1)
