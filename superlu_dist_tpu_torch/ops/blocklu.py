"""Block pool, level schedules and the right-looking reference factor.

Counterpart of the JAX package's ``ops/kernels/blocklu.py``:

- :func:`init_pool` scatters A into the flat ``(nslots + 2, bs, bs)``
  block pool (slot ``nslots`` is the zero block, ``nslots + 1`` the
  trash block, as in the JAX package; the port does not bucket-pad);
- :func:`level_order` groups per-step factor work by elimination level;
- :func:`factor_plain` is the level-batched right-looking factor of the
  JAX package's XLA executor (``_make_level_step`` with
  ``block_lu_inv``) in plain PyTorch: per level the diagonal batch, the
  L panels times U⁻¹, L⁻¹ times the U panels, then the Schur
  gather-GEMM-scatter-add. It is the independent reference that the clk
  kernel is held against.
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
        for c in range(lo, hi, SCHUR_CHUNK):
            e = min(c + SCHUR_CHUNK, hi)
            gl, gu = idx(lv["g_l"], c, e), idx(lv["g_u"], c, e)
            gt = idx(lv["g_t"], c, e)
            pool.index_add_(0, gt, pool[gl] @ pool[gu], alpha=-1)
    return pool, linv, uinv, tiny
