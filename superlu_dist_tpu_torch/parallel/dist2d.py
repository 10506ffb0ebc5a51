"""2D block-cyclic distribution of the block plan over a Pr × Pc grid.

Counterpart of the host half of the JAX package's ``parallel/dist2d.py``:

- block (I, J) → rank (I mod Pr, J mod Pc), the reference's block-cyclic
  layout (superlu_defs.h:380-397);
- :func:`partition_plan` (the pddistribute analog) builds every rank's
  work lists by elimination level, :class:`DistPlan2D`, a copy of the JAX
  package's numpy code, field for field;
- :func:`init_local_pools` scatters A into one ``(n_local, bs, bs)`` pool
  per rank (local slot 0 is the zero block, slot 1 the trash block);
- sharded NRLoc input (the dReDistribute_A analog, pddistribute.c:
  66-433): :func:`gather_values_to0`, :func:`nrloc_slot_entries`,
  :func:`nrloc_entry_offsets` and :func:`init_local_pools_nrloc`, which
  stores each process's entries into their owners' pools through the
  window (``parallel/window.py``);
- :func:`coo_shards`, :func:`make_coo_shards_nrloc` and
  :func:`dist_spmv`: the refinement's distributed SpMV (pdgsmv analog), a
  partial product per rank, each row summed in a fixed order
  (``ops/spmv.py``), then a sum over the ranks in rank order, of A or
  (``coo_shards(..., transpose=True)``) of Aᵀ; Aᴴ conjugates the
  transposed shards' values. Each rank holds whole rows of A (whole
  columns in the transposed shards) in column (row) order, so every
  output row is one rank's fixed-order sum: the result is the same bits
  whichever rank holds a row, the single-device SpMV's, in one process or
  split over several, from the whole A or from NRLoc chunks. The JAX
  package's is XLA (a psum over the mesh, over equal slices of A's COO),
  not a TPU kernel, so here it is plain PyTorch;
- :func:`sweep_schedule`: the level schedule of each sweep, the plan's L
  and U sweeps or the transposed Uᵀ and Lᵀ sweeps of
  ``blocklu.trans_schedule`` (the schedule that the JAX package's
  ``trans_partition_plan`` distributes: the blocks' owners are unchanged,
  only the direction flips).

The factor and the solves that run on these lists are
``parallel/dist2d_rdma.py``, which partitions each sweep's schedule over
the ranks itself. The JAX package's XLA executors
(``build_dist_factor_fn``, ``build_dist_solve_fn``,
``build_dist_trans_solve_fn``) and their packed tapes are not ported: the
RDMA kernels serve every executor name.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from ..ops import spmv as _spmv
from ..ops.blocklu import trans_schedule
from ..ops.host.symbolic import SymbolicPlan
from . import multihost as _mh

# local pool layout: slot 0 = zero block (never written), slot 1 = trash
_ZERO = 0
_TRASH = 1
_NLOCAL_RESERVED = 2


@dataclasses.dataclass
class DistPlan2D:
    """Per-rank instruction tapes, stacked over the (Pr, Pc) grid and
    grouped by elimination level (the JAX package's layout and pads)."""

    pr: int
    pc: int
    nb: int
    bs: int
    nlvl: int
    n_local: int          # local pool slots (incl. zero/trash)
    max_lbuf: int         # L broadcast buffer rows per level
    max_ubuf: int
    max_dlvl: int         # max elimination steps per level

    # value placement: global slot -> (rank, local slot)
    owner_dev: np.ndarray     # (nslots,) linear rank r*pc + c
    local_slot: np.ndarray    # (nslots,)

    # factor tapes, all leading dims (pr, pc, ...)
    dptr: np.ndarray          # (pr, pc, nlvl+1) owned diag ranges
    dstep: np.ndarray         # step ids of owned diag blocks
    dloc: np.ndarray          # local slots of owned diag blocks
    dpos: np.ndarray          # position of the step within its level
    lptr: np.ndarray          # (pr, pc, nlvl+1)
    lloc: np.ndarray          # owned L-panel local slots
    lpos: np.ndarray          # fill position in the level's L buffer
    lpil: np.ndarray          # owning step's position within its level
    uptr: np.ndarray
    uloc: np.ndarray
    upos: np.ndarray
    upil: np.ndarray
    gptr: np.ndarray
    glpos: np.ndarray
    gupos: np.ndarray
    gtloc: np.ndarray
    dinv_idx: np.ndarray      # (nb,) owner-local inverse index of step k

    # solve tapes (L then U), per rank, grouped by level
    lsol_gptr: np.ndarray
    lsol_gloc: np.ndarray
    lsol_gsrc: np.ndarray
    lsol_gdst: np.ndarray     # compact position within the level's buffer
    usol_gptr: np.ndarray
    usol_gloc: np.ndarray
    usol_gsrc: np.ndarray
    usol_gdst: np.ndarray
    # replicated: global rows of each solve level's compact delta buffer
    lsol_rows: np.ndarray     # (lsol_nlvl, max_lact) fill nb
    usol_rows: np.ndarray
    # owner-only diagonal applies per solve level
    ldsol_ptr: np.ndarray     # (pr, pc, lsol_nlvl+1)
    ldsol_row: np.ndarray     # global block row I
    ldsol_pos: np.ndarray     # position within the level's diag buffer
    ldsol_inv: np.ndarray     # owner-local inverse index
    udsol_ptr: np.ndarray
    udsol_row: np.ndarray
    udsol_pos: np.ndarray
    udsol_inv: np.ndarray
    lsol_drows: np.ndarray    # (lsol_nlvl, max_ldact) fill nb
    usol_drows: np.ndarray

    def comm_volume(self, itemsize: int, nrhs: int = 1) -> dict:
        """Per-phase collective volume in bytes of the JAX package's XLA
        executor (one axis-psum counted once), as its ``Stats`` counters
        record it; the puts of ``dist2d_rdma`` move the blocks that these
        psums replicate."""
        bsb = self.bs * self.bs * itemsize
        fac = self.nlvl * (2 * (self.max_dlvl + 1)
                           + (self.max_lbuf + 2) + (self.max_ubuf + 2)) * bsb
        xrow = self.bs * nrhs * itemsize
        sol = ((self.lsol_rows.shape[0] * (self.lsol_rows.shape[1] + 1)
                + self.usol_rows.shape[0] * (self.usol_rows.shape[1] + 1)
                + self.lsol_drows.shape[0] * (self.lsol_drows.shape[1] + 1)
                + self.usol_drows.shape[0] * (self.usol_drows.shape[1] + 1))
               * xrow)
        return {"factor_psum_bytes": int(fac), "solve_psum_bytes": int(sol)}


def _solve_pack(plan, owner_dev, local_slot, pr, pc,
                gptr_g, gslot_g, gsrc_g, gdst_g, snlvl):
    """Group one sweep's gemms by (rank, level); destinations remapped
    to compact per-level buffer positions."""
    nb = plan.nb
    ndev = pr * pc
    rows_per_lvl = []
    pos_of = [dict() for _ in range(snlvl)]
    for l in range(snlvl):
        dsts = np.unique(np.asarray(
            gdst_g[gptr_g[l]:gptr_g[l + 1]], dtype=np.int64))
        pos_of[l] = {int(r): i for i, r in enumerate(dsts)}
        rows_per_lvl.append(dsts)
    max_act = max(1, max((len(r) for r in rows_per_lvl), default=1))
    lvl_rows = np.full((max(snlvl, 1), max_act), nb, dtype=np.int32)
    for l, r in enumerate(rows_per_lvl):
        lvl_rows[l, : len(r)] = r

    lists = [[[] for _ in range(snlvl)] for _ in range(ndev)]
    for l in range(snlvl):
        for t in range(gptr_g[l], gptr_g[l + 1]):
            s = gslot_g[t]
            lists[owner_dev[s]][l].append(
                (int(local_slot[s]), int(gsrc_g[t]),
                 pos_of[l][int(gdst_g[t])]))
    ptr = np.zeros((ndev, snlvl + 1), dtype=np.int64)
    for d in range(ndev):
        for l in range(snlvl):
            ptr[d, l + 1] = ptr[d, l] + len(lists[d][l])
    maxlen = max(1, int(ptr[:, -1].max()))
    loc = np.full((ndev, maxlen), _ZERO, dtype=np.int32)
    src = np.zeros((ndev, maxlen), dtype=np.int32)
    dst = np.full((ndev, maxlen), max_act, dtype=np.int32)
    for d in range(ndev):
        pos = 0
        for l in range(snlvl):
            for (a, b, c) in lists[d][l]:
                loc[d, pos] = a
                src[d, pos] = b
                dst[d, pos] = c
                pos += 1
    return (ptr.reshape(pr, pc, snlvl + 1).astype(np.int32),
            loc.reshape(pr, pc, maxlen), src.reshape(pr, pc, maxlen),
            dst.reshape(pr, pc, maxlen), lvl_rows)


def _diag_pack(plan, owner_dev, local_slot, dinv_idx, pr, pc,
               dptr_g, diag_g, snlvl):
    """Owner-only diagonal applies per solve level (see _solve_pack)."""
    nb = plan.nb
    ndev = pr * pc
    lists = [[[] for _ in range(snlvl)] for _ in range(ndev)]
    max_dact = 1
    drows = np.full((max(snlvl, 1),
                     max(1, int(np.max(np.diff(dptr_g))
                                if len(dptr_g) > 1 else 1))),
                    nb, dtype=np.int32)
    for l in range(snlvl):
        rows = np.asarray(diag_g[dptr_g[l]:dptr_g[l + 1]], np.int64)
        max_dact = max(max_dact, len(rows))
        drows[l, : len(rows)] = rows
        for p, I in enumerate(rows):
            s = plan.diag_slot[I]
            lists[owner_dev[s]][l].append(
                (int(I), p, int(dinv_idx[I])))
    drows = drows[:, :max_dact]
    ptr = np.zeros((ndev, snlvl + 1), dtype=np.int64)
    for d in range(ndev):
        for l in range(snlvl):
            ptr[d, l + 1] = ptr[d, l] + len(lists[d][l])
    maxlen = max(1, int(ptr[:, -1].max()))
    row = np.full((ndev, maxlen), nb, dtype=np.int32)
    pos = np.full((ndev, maxlen), max_dact, dtype=np.int32)
    inv = np.zeros((ndev, maxlen), dtype=np.int32)
    for d in range(ndev):
        p0 = 0
        for l in range(snlvl):
            for (a, b, c) in lists[d][l]:
                row[d, p0] = a
                pos[d, p0] = b
                inv[d, p0] = c
                p0 += 1
    return (ptr.reshape(pr, pc, snlvl + 1).astype(np.int32),
            row.reshape(pr, pc, maxlen), pos.reshape(pr, pc, maxlen),
            inv.reshape(pr, pc, maxlen), drows)


def partition_plan(plan: SymbolicPlan, pr: int, pc: int) -> DistPlan2D:
    """Distribute the symbolic plan block-cyclically over a Pr×Pc grid
    (the pddistribute analog: builds every rank's local work lists)."""
    nb = plan.nb
    nlvl = plan.n_flevels
    ndev = pr * pc
    srow, scol = plan.slot_row, plan.slot_col
    owner_dev = (srow % pr) * pc + (scol % pc)

    # local slot numbering per rank (stable by global slot id)
    local_slot = np.zeros(plan.nslots, dtype=np.int64)
    counts = np.full(ndev, _NLOCAL_RESERVED, dtype=np.int64)
    order = np.argsort(owner_dev, kind="stable")
    for s in order:
        d = owner_dev[s]
        local_slot[s] = counts[d]
        counts[d] += 1
    n_local = int(counts.max())

    lev = plan.step_level
    steps_by_level = [np.flatnonzero(lev == l) for l in range(nlvl)]
    max_dlvl = max(1, max((len(s) for s in steps_by_level), default=1))
    pil_of_step = np.zeros(nb, dtype=np.int64)   # position within level
    for sl in steps_by_level:
        pil_of_step[sl] = np.arange(len(sl))

    d_lists = [[[] for _ in range(nlvl)] for _ in range(ndev)]
    l_lists = [[[] for _ in range(nlvl)] for _ in range(ndev)]
    u_lists = [[[] for _ in range(nlvl)] for _ in range(ndev)]
    g_lists = [[[] for _ in range(nlvl)] for _ in range(ndev)]

    max_lbuf = 1
    max_ubuf = 1
    for l in range(nlvl):
        # buffer positions for this level: all L blocks of all steps at the
        # level, ordered (step, I) within each grid row; same for U per col.
        lrow_count = np.zeros(pr, dtype=np.int64)
        ucol_count = np.zeros(pc, dtype=np.int64)
        lpos_of: dict[int, int] = {}
        upos_of: dict[int, int] = {}
        for k in steps_by_level[l]:
            ds = plan.diag_slot[k]
            d = owner_dev[ds]
            d_lists[d][l].append((int(k), int(local_slot[ds]),
                                  int(pil_of_step[k])))

            lo, hi = plan.l_ptr[k], plan.l_ptr[k + 1]
            for s in plan.l_slots[lo:hi]:
                r = int(srow[s] % pr)
                pos = int(lrow_count[r])
                lrow_count[r] += 1
                lpos_of[int(s)] = pos
                l_lists[owner_dev[s]][l].append(
                    (int(local_slot[s]), pos, int(pil_of_step[k])))
            uo, uh = plan.u_ptr[k], plan.u_ptr[k + 1]
            for s in plan.u_slots[uo:uh]:
                c = int(scol[s] % pc)
                pos = int(ucol_count[c])
                ucol_count[c] += 1
                upos_of[int(s)] = pos
                u_lists[owner_dev[s]][l].append(
                    (int(local_slot[s]), pos, int(pil_of_step[k])))
        max_lbuf = max(max_lbuf, int(lrow_count.max()))
        max_ubuf = max(max_ubuf, int(ucol_count.max()))
        for k in steps_by_level[l]:
            go, gh = plan.g_ptr[k], plan.g_ptr[k + 1]
            for t in range(go, gh):
                tgt = plan.g_t[t]
                g_lists[owner_dev[tgt]][l].append(
                    (lpos_of[int(plan.g_l[t])], upos_of[int(plan.g_u[t])],
                     int(local_slot[tgt])))

    def pack(lists, nfields, fills=None):
        ptr = np.zeros((ndev, nlvl + 1), dtype=np.int64)
        for d in range(ndev):
            for l in range(nlvl):
                ptr[d, l + 1] = ptr[d, l] + len(lists[d][l])
        maxlen = max(1, int(ptr[:, -1].max()))
        fills = fills or [0] * nfields
        out = [np.full((ndev, maxlen), fills[f], dtype=np.int32)
               for f in range(nfields)]
        for d in range(ndev):
            pos = 0
            for l in range(nlvl):
                for item in lists[d][l]:
                    for f in range(nfields):
                        out[f][d, pos] = item[f]
                    pos += 1
        return (ptr.reshape(pr, pc, nlvl + 1).astype(np.int32),
                [o.reshape(pr, pc, maxlen) for o in out])

    dptr, (dstep, dloc, dpos) = pack(d_lists, 3, fills=[nb, _TRASH, max_dlvl])
    lptr, (lloc, lpos, lpil) = pack(l_lists, 3, fills=[_TRASH, 0, max_dlvl])
    uptr, (uloc, upos, upil) = pack(u_lists, 3, fills=[_TRASH, 0, max_dlvl])
    gptr, (glpos, gupos, gtloc) = pack(g_lists, 3)

    # owner-local inverse index of each step: its position in the owner's
    # d tape (the factor stores inverses at that position)
    dinv_idx = np.zeros(nb, dtype=np.int64)
    dstep_flat = dstep.reshape(ndev, -1)
    for d in range(ndev):
        for i, k in enumerate(dstep_flat[d]):
            if k < nb:
                dinv_idx[k] = i

    lsg = _solve_pack(plan, owner_dev, local_slot, pr, pc,
                      plan.lsol_gptr, plan.lsol_gslot, plan.lsol_gsrc,
                      plan.lsol_gdst, plan.lsol_nlvl)
    usg = _solve_pack(plan, owner_dev, local_slot, pr, pc,
                      plan.usol_gptr, plan.usol_gslot, plan.usol_gsrc,
                      plan.usol_gdst, plan.usol_nlvl)

    ldg = _diag_pack(plan, owner_dev, local_slot, dinv_idx, pr, pc,
                     plan.lsol_dptr, plan.lsol_diag, plan.lsol_nlvl)
    udg = _diag_pack(plan, owner_dev, local_slot, dinv_idx, pr, pc,
                     plan.usol_dptr, plan.usol_diag, plan.usol_nlvl)

    return DistPlan2D(
        pr=pr, pc=pc, nb=nb, bs=plan.bs, nlvl=nlvl, n_local=n_local,
        max_lbuf=max_lbuf, max_ubuf=max_ubuf, max_dlvl=max_dlvl,
        owner_dev=owner_dev, local_slot=local_slot,
        dptr=dptr, dstep=dstep, dloc=dloc, dpos=dpos,
        lptr=lptr, lloc=lloc, lpos=lpos, lpil=lpil,
        uptr=uptr, uloc=uloc, upos=upos, upil=upil,
        gptr=gptr, glpos=glpos, gupos=gupos, gtloc=gtloc,
        dinv_idx=dinv_idx,
        lsol_gptr=lsg[0], lsol_gloc=lsg[1], lsol_gsrc=lsg[2],
        lsol_gdst=lsg[3], lsol_rows=lsg[4],
        usol_gptr=usg[0], usol_gloc=usg[1], usol_gsrc=usg[2],
        usol_gdst=usg[3], usol_rows=usg[4],
        ldsol_ptr=ldg[0], ldsol_row=ldg[1], ldsol_pos=ldg[2],
        ldsol_inv=ldg[3], lsol_drows=ldg[4],
        udsol_ptr=udg[0], udsol_row=udg[1], udsol_pos=udg[2],
        udsol_inv=udg[3], usol_drows=udg[4],
    )


def sweep_schedule(plan: SymbolicPlan, which: str):
    """The level schedule of one sweep: ``"L"`` / ``"U"`` the plan's
    forward L and backward U sweeps, ``"UT"`` / ``"LT"`` the transposed
    solve's forward Uᵀ and backward Lᵀ sweeps (``blocklu.trans_schedule``).
    Returns (gptr, gslot, gsrc, gdst, dptr, diag, nlvl): level l's (slot,
    src, dst) products over ``gptr[l]:gptr[l+1]`` and its solved block
    rows ``diag[dptr[l]:dptr[l+1]]``."""
    if which in ("UT", "LT"):
        return trans_schedule(plan, which[0])
    p = "lsol" if which == "L" else "usol"
    return tuple(getattr(plan, f"{p}_{f}") for f in
                 ("gptr", "gslot", "gsrc", "gdst", "dptr", "diag", "nlvl"))


def init_local_pools(plan: SymbolicPlan, dplan: DistPlan2D, a_data, dtype,
                     device, win=None) -> list:
    """One ``(n_local, bs, bs)`` pool per rank (rank r·Pc + c at index
    r·Pc + c), scattered on the host rank by rank and copied to
    ``device`` (the dReDistribute_A analog, pddistribute.c:66-433): peak
    host memory is one rank's shard plus the sorted value stream, never
    the whole distributed pool. ``a_data`` is in the CSC data order of the
    matrix the plan was built from (as ``blocklu.init_pool`` takes it);
    padding diagonal entries get 1.0. With a window (``parallel/
    window.py``) the pools are its tensors and this process fills its own
    ranks' only."""
    dev, off, vals = init_entries(plan, np.asarray(dplan.owner_dev),
                                  np.asarray(dplan.local_slot), a_data,
                                  dtype)
    return fill_pools(dev, off, vals, dplan.pr * dplan.pc, dplan.n_local,
                      plan.bs, dtype, device, win)


def init_entries(plan: SymbolicPlan, slot_rank, slot_local, a_data, dtype):
    """The pool entries of ``a_data`` (the CSC data of the matrix the plan
    was built from, then 1.0 on the padding diagonal): (rank, offset in
    the rank's flat pool, value), for a partition that puts global slot s
    at local slot ``slot_local[s]`` of rank ``slot_rank[s]``."""
    bb = plan.bs * plan.bs
    nnz = len(a_data)
    idx = np.asarray(plan.init_idx)
    gslot = idx // bb
    off = slot_local[gslot] * bb + idx % bb
    vals = np.concatenate([np.asarray(a_data, dtype=dtype),
                           np.ones(len(idx) - nnz, dtype=dtype)]) \
        if len(idx) > nnz else np.asarray(a_data, dtype=dtype)
    return slot_rank[gslot], off, vals


def _rank_flats(dev, off, vals, ranks, rows: int, bb: int, dtype):
    """Each rank of ``ranks`` with its flat pool of ``rows`` blocks, its
    entries added in stream order on the host (one rank's shard at a
    time)."""
    order = np.argsort(dev, kind="stable")
    dev_s, off_s, val_s = dev[order], off[order], vals[order]
    for d in ranks:
        lo, hi = np.searchsorted(dev_s, [d, d + 1])
        flat = np.zeros(rows * bb, dtype=dtype)
        np.add.at(flat, off_s[lo:hi], val_s[lo:hi])
        yield d, flat


def fill_pools(dev, off, vals, ndev: int, rows: int, bs: int, dtype,
               device, win=None) -> list:
    """One ``(rows, bs, bs)`` pool per rank from the entries (rank, flat
    offset, value), every rank's on ``device``; or, with a window, its
    tensors, of which this process fills its own ranks'."""
    if win is None:
        return [torch.from_numpy(f.reshape(rows, bs, bs)).to(device)
                for _, f in _rank_flats(dev, off, vals, range(ndev), rows,
                                        bs * bs, dtype)]
    pools = win.alloc((rows, bs, bs), _torch_dtype(dtype))
    for d, f in _rank_flats(dev, off, vals, win.ranks, rows, bs * bs, dtype):
        pools[d].copy_(torch.from_numpy(f.reshape(rows, bs, bs)))
    return pools


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype=dtype)).dtype


def scatter_pools(dev, off, vals, rows: int, bs: int, dtype, win) -> list:
    """The window's ``(rows, bs, bs)`` pools of every rank from this
    process's entries (rank, flat offset, value), which may belong to any
    rank: the processes take turns, each adding its entries into their
    owners' pools (the alltoall of dReDistribute_A as stores into the
    peers' buffers). No position holds two entries, so the pools are the
    ones that one stream of every entry gives."""
    pools = win.alloc((rows, bs, bs), _torch_dtype(dtype))
    dev = np.asarray(dev, np.int64)
    for _ in win.each_turn():
        for d in np.unique(dev):
            sel = dev == d
            pools[int(d)].view(-1).index_add_(
                0, torch.as_tensor(off[sel], device=win.device),
                torch.as_tensor(vals[sel], device=win.device))
    return pools


# ---------------------------------------------------------------------------
# sharded NRLoc input (dReDistribute_A, reference: pddistribute.c:66-433)
# ---------------------------------------------------------------------------
#
# With ``local=True`` chunks every process holds only its own rows. The
# values reach their owners' pools without any process holding the
# global matrix: each process maps its local entries to (owner rank, pool
# offset) with the broadcast transforms and the (pattern-only) plan, and
# stores them into the owners' pools through the window.


def gather_values_to0(rows, cols, vals, n, dtype):
    """Every process's COO stream gathered to process 0 only (the
    preprocessing host: the pdgssvx.c:768-794 global-gather role). Returns
    the global csc on process 0, None elsewhere."""
    got = _mh.gather_obj((np.asarray(rows, np.int64),
                          np.asarray(cols, np.int64),
                          np.asarray(vals, dtype)))
    if _mh.process_index() != 0:
        return None
    r, c, v = (np.concatenate(a) for a in zip(*got))
    return sp.csc_matrix((v, (r, c)), shape=(n, n))


def nrloc_slot_entries(plan: SymbolicPlan, chunks,
                       row_scale, col_scale, rowperm, colperm,
                       expand, n_e, n, *, embed=False,
                       with_identity=False):
    """Map local NRLoc entries (global row coords) to
    (pool slot, row-in-block, col-in-block, scaled value) — the
    grid-independent half of dReDistribute_A (the 2D/3D wrappers map
    slots to their grid's owners). ``with_identity`` adds the
    unit-diagonal entries of expansion/block padding (contributed by
    ONE process).

    A3[r, c] = (Dr·A·Dc)[rowperm[colperm[r]], colperm[c]], then the
    alignment expansion re = expand[r], then (for a ring-embedded
    complex64 factor) the embedding doubling."""
    bs = plan.bs
    inv_rp = np.empty_like(rowperm)
    inv_rp[rowperm] = np.arange(len(rowperm))
    inv_cp = np.empty_like(colperm)
    inv_cp[colperm] = np.arange(len(colperm))

    from ..utils.nrloc import NRLocMatrix
    i, j, v = NRLocMatrix(chunks, n, local=True).to_coo_arrays()
    v = row_scale[i] * v * col_scale[j]
    r = inv_cp[inv_rp[i]]
    c = inv_cp[j]
    if expand is not None:
        r = np.asarray(expand)[r]
        c = np.asarray(expand)[c]
    dim = n_e if expand is not None else n

    if embed:
        # a+bi -> [[a,-b],[b,a]] at (2r, 2c)
        re, im = np.real(v), np.imag(v)
        r = np.concatenate([2 * r, 2 * r + 1, 2 * r, 2 * r + 1])
        c0 = c
        c = np.concatenate([2 * c0, 2 * c0 + 1, 2 * c0 + 1, 2 * c0])
        v = np.concatenate([re, re, -im, im])
        dim *= 2

    if with_identity:
        # expansion pads + block pads hold a decoupled unit diagonal
        n_pad = plan.nb * bs
        ident = []
        if expand is not None:
            present = np.zeros(dim, dtype=bool)
            base = np.asarray(expand)
            if embed:
                present[2 * base] = True
                present[2 * base + 1] = True
            else:
                present[base] = True
            ident.append(np.flatnonzero(~present))
        if n_pad > dim:
            ident.append(np.arange(dim, n_pad, dtype=np.int64))
        if ident:
            p = np.concatenate(ident)
            r = np.concatenate([r, p])
            c = np.concatenate([c, p])
            v = np.concatenate([v, np.ones(len(p), v.dtype)])

    # block coords -> slot: one vectorized binary search over the
    # lexicographic (col, row) slot order (slots are column-major)
    bi, bj = r // bs, c // bs
    scol = np.asarray(plan.slot_col)
    srow = np.asarray(plan.slot_row)
    keys = bj * (plan.nb + 1) + bi
    skeys = scol.astype(np.int64) * (plan.nb + 1) + srow.astype(np.int64)
    slot = np.searchsorted(skeys, keys)
    ok = (slot < len(skeys)) & (skeys[np.minimum(slot, len(skeys) - 1)]
                                == keys)
    if not np.all(ok):
        raise ValueError("NRLoc entry outside the symbolic pattern")
    return slot, r % bs, c % bs, v


def nrloc_entry_offsets(plan: SymbolicPlan, dplan: DistPlan2D, chunks,
                        row_scale, col_scale, rowperm, colperm,
                        expand, n_e, n, *, embed=False,
                        with_identity=False):
    """2D-grid owner mapping over :func:`nrloc_slot_entries`: returns
    (owner rank, flat pool offset, scaled value)."""
    bs = plan.bs
    bb = bs * bs
    slot, ri, ci, v = nrloc_slot_entries(
        plan, chunks, row_scale, col_scale, rowperm, colperm,
        expand, n_e, n, embed=embed, with_identity=with_identity)
    dev = np.asarray(dplan.owner_dev)[slot]
    off = (np.asarray(dplan.local_slot)[slot] * bb
           + ri.astype(np.int64) * bs + ci)
    return dev.astype(np.int32), off.astype(np.int64), v


def init_local_pools_nrloc(plan: SymbolicPlan, dplan: DistPlan2D, win,
                           dev, off, vals, dtype) -> list:
    """The ranks' pools in the window ``win`` from every process's entry
    streams of :func:`nrloc_entry_offsets` (:func:`scatter_pools`). No
    process holds global values on its host."""
    return scatter_pools(dev, off, np.asarray(vals, dtype), dplan.n_local,
                         plan.bs, dtype, win)


# ---------------------------------------------------------------------------
# distributed SpMV (pdgsmv analog, reference: SRC/double/pdgsmv.c:1-383)
# ---------------------------------------------------------------------------


def _line_shards(A, parts, ranks, dtype, device, transpose):
    """``A``'s whole rows (whole columns with ``transpose``, as the rows
    of Aᵀ) split into ``parts`` runs of about equal entries, run i on rank
    ``ranks[i]``: one :class:`ops.spmv.Coo` per rank of an (n, n) output,
    each line's entries in ascending order of the other index."""
    n = A.shape[0]
    M = sp.csc_matrix(A) if transpose else sp.csr_matrix(A)
    M.sort_indices()
    ptr_ = M.indptr
    cut = np.searchsorted(ptr_, np.arange(parts + 1) * ptr_[-1] / parts)
    cut[0], cut[-1] = 0, n
    out = {}
    for i, d in enumerate(ranks):
        lo, hi = ptr_[cut[i]], ptr_[cut[i + 1]]
        major = np.repeat(np.arange(cut[i], cut[i + 1]),
                          np.diff(ptr_[cut[i]:cut[i + 1] + 1]))
        out[d] = _spmv.Coo.from_arrays(
            major, M.indices[lo:hi], np.asarray(M.data[lo:hi], dtype),
            (n, n), device)
    return out


def coo_shards(A, ndev: int, dtype, device, transpose: bool = False,
               ranks=None) -> list:
    """The refinement's shards of ``A`` on ``device``: its rows split
    into ``ndev`` runs of whole rows with about equal entries, one
    :class:`ops.spmv.Coo` per rank (rank order = row order). With
    ``transpose`` the shards of Aᵀ: A's whole columns, each as a row of
    Aᵀ. ``ranks`` (default all) are the ranks whose shards are built; the
    others are None (another process's)."""
    got = _line_shards(A, ndev, range(ndev), dtype, device, transpose)
    keep = range(ndev) if ranks is None else ranks
    return [got[d] if d in keep else None for d in range(ndev)]


def make_coo_shards_nrloc(chunks, n: int, ndev: int, ranks, dtype,
                          device) -> list:
    """The refinement's shards from this process's NRLoc ``chunks`` only
    (pdgsmv_init from local data, no global COO anywhere): its rows split
    over its own ``ranks`` as :func:`coo_shards` splits A; the other
    ranks' entries are None."""
    from ..utils.nrloc import NRLocMatrix
    local = NRLocMatrix(chunks, n, local=True).to_partial_csc()
    got = _line_shards(local, len(ranks), list(ranks), dtype, device, False)
    return [got.get(d) for d in range(ndev)]


def _partial(A, x, absolute: bool, conj: bool):
    if absolute:
        return _spmv.abs_spmv(A, x)
    if conj and A.vals.is_complex():
        return A.by_row(torch.conj_physical(A.vals)[:, None] * x[A.cols])
    return _spmv.spmv(A, x)


def dist_spmv(shards, x, n: int, absolute: bool = False,
              conj: bool = False, win=None):
    """A·x (|A|·x with ``absolute``) from the ranks' shards of
    :func:`coo_shards`, or Aᵀ·x from transposed shards (Aᴴ·x with
    ``conj``, which conjugates the values; |Aᴴ| = |Aᵀ|): each rank's
    partial product, then their sum over the ranks in rank order (the JAX
    package's psum over the mesh). ``x`` is (n, k) and replicated. With
    the ranks split over processes (``win``, whose process holds its own
    ranks' shards), each process puts its ranks' partials into the
    window, and after a fence every process sums all of them in rank
    order: the same sum, the same bits on every process."""
    if win is None or not win.shared:
        out = None
        for A in shards:
            part = _partial(A, x, absolute, conj)
            out = part if out is None else out + part
        return out[:n]
    mine = {d: _partial(shards[d], x, absolute, conj) for d in win.ranks}
    part = mine[win.lo]
    parts = win.scratch(("spmv",) + tuple(part.shape), part.shape,
                        part.dtype)
    for d, p in mine.items():
        parts[d].copy_(p)
    win.fence()
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out[:n]
