"""2D block-cyclic distribution of the block plan over a Pr × Pc grid.

Counterpart of the host half of the JAX package's ``parallel/dist2d.py``:

- block (I, J) → rank (I mod Pr, J mod Pc), the reference's block-cyclic
  layout (superlu_defs.h:380-397);
- :func:`partition_plan` (the pddistribute analog) builds every rank's
  work lists by elimination level, :class:`DistPlan2D`, a copy of the JAX
  package's numpy code, field for field;
- :func:`init_local_pools` scatters A into one ``(n_local, bs, bs)`` pool
  per rank (local slot 0 is the zero block, slot 1 the trash block);
- :func:`make_coo_shards`, :func:`coo_shards` and :func:`dist_spmv`:
  the refinement's distributed SpMV (pdgsmv analog), a partial product
  per rank, each row summed in a fixed order (``ops/spmv.py``), then a
  sum over the ranks in rank order. The JAX package's is XLA (a psum
  over the mesh), not a TPU kernel, so here it is plain PyTorch.

The factor and the solve that run on these lists are
``parallel/dist2d_rdma.py``. The JAX package's XLA executors
(``build_dist_factor_fn``, ``build_dist_solve_fn``), its transposed plan
and solve and its sharded NRLoc input are not ported (ROADMAP.md, queue 1
items 8a and 10).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from ..ops import spmv as _spmv
from ..ops.host.symbolic import SymbolicPlan

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


def init_local_pools(plan: SymbolicPlan, dplan: DistPlan2D, a_data, dtype,
                     device) -> list:
    """One ``(n_local, bs, bs)`` pool per rank (rank r·Pc + c at index
    r·Pc + c), scattered on the host rank by rank and copied to
    ``device`` (the dReDistribute_A analog, pddistribute.c:66-433): peak
    host memory is one rank's shard plus the sorted value stream, never
    the whole distributed pool. ``a_data`` is in the CSC data order of the
    matrix the plan was built from (as ``blocklu.init_pool`` takes it);
    padding diagonal entries get 1.0."""
    bs = plan.bs
    bb = bs * bs
    nnz = len(a_data)
    idx = np.asarray(plan.init_idx)
    gslot = idx // bb
    rem = idx % bb
    dev = np.asarray(dplan.owner_dev)[gslot]
    off = np.asarray(dplan.local_slot)[gslot] * bb + rem
    vals = np.concatenate([np.asarray(a_data, dtype=dtype),
                           np.ones(len(idx) - nnz, dtype=dtype)]) \
        if len(idx) > nnz else np.asarray(a_data, dtype=dtype)

    # group entries by owner rank
    order = np.argsort(dev, kind="stable")
    dev_s, off_s, val_s = dev[order], off[order], vals[order]
    ndev = dplan.pr * dplan.pc
    dptr = np.searchsorted(dev_s, np.arange(ndev + 1))
    pools = []
    for d in range(ndev):
        flat = np.zeros(dplan.n_local * bb, dtype=dtype)
        lo, hi = dptr[d], dptr[d + 1]
        np.add.at(flat, off_s[lo:hi], val_s[lo:hi])
        pools.append(torch.from_numpy(
            flat.reshape(dplan.n_local, bs, bs)).to(device))
    return pools


# ---------------------------------------------------------------------------
# distributed SpMV (pdgsmv analog, reference: SRC/double/pdgsmv.c:1-383)
# ---------------------------------------------------------------------------


def _coo_bucket(nnz: int) -> int:
    """The JAX package's ``spmv._coo_bucket``: the smallest value ≥ nnz of
    the form 2^k·{1, 1.25, 1.5, 1.75} (at least 8)."""
    x = max(int(nnz), 8)
    k = max(0, int(np.floor(np.log2(x))))
    for base in (1.0, 1.25, 1.5, 1.75, 2.0):
        cand = int(np.ceil((2 ** k) * base))
        if cand >= x:
            return cand
    return 2 ** (k + 1)


def _pad_coo_streams(coo, n, ndev, value_streams):
    """Bucket the per-rank stream length, pad with trash-row entries
    (row ``n``, value 0) and reshape to (ndev, m), as the JAX package
    does."""
    nnz = coo.nnz
    m = _coo_bucket(-(-max(nnz, 1) // ndev))
    rows = np.full(ndev * m, n, dtype=np.int32)
    cols = np.zeros(ndev * m, dtype=np.int32)
    rows[:nnz] = coo.row
    cols[:nnz] = coo.col
    outs = [rows.reshape(ndev, m), cols.reshape(ndev, m)]
    for data, dtype in value_streams:
        v = np.zeros(ndev * m, dtype=dtype)
        v[:nnz] = data.astype(dtype)
        outs.append(v.reshape(ndev, m))
    return tuple(outs)


def make_coo_shards(A, ndev: int, dtype):
    """Partition the COO of ``A`` into ``ndev`` equal entry chunks
    (pdgsmv_init analog). Returns (rows, cols, vals) of shape (ndev, m);
    padding entries target the trash row ``n`` with value 0."""
    coo = sp.coo_matrix(A)
    return _pad_coo_streams(coo, A.shape[0], ndev, [(coo.data, dtype)])


def coo_shards(A, ndev: int, dtype, device) -> list:
    """The ranks' entries of :func:`make_coo_shards` on ``device``, one
    :class:`ops.spmv.Coo` per rank whose output rows end with the trash
    row ``n``; each rank's rows are summed in a fixed order."""
    n = A.shape[0]
    return [_spmv.Coo.from_arrays(r, c, v, (n + 1, A.shape[1]), device)
            for r, c, v in zip(*make_coo_shards(A, ndev, dtype))]


def dist_spmv(shards, x, n: int, absolute: bool = False):
    """A·x (|A|·x with ``absolute``) from the ranks' shards of
    :func:`coo_shards`: each rank's partial product, then their sum over
    the ranks in rank order (the JAX package's psum over the mesh). ``x``
    is (n, k) and replicated."""
    fn = _spmv.abs_spmv if absolute else _spmv.spmv
    out = None
    for A in shards:
        part = fn(A, x)
        out = part if out is None else out + part
    return out[:n]
