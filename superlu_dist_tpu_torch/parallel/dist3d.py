"""The 3D communication-avoiding factorization (pdgstrf3d analog) on one
device: every rank of a Pz × Pr × Pc grid in one process, or split over
several (below).

Counterpart of the JAX package's ``parallel/dist3d.py``. The elimination
forest is split into Pz groups of independent subtrees and a shared
ancestor "top" (:func:`partition_forest`, the SUPERLU_LBS greedy binning
of supernodalForest.c); layer z factors its subtrees on its own Pr × Pc
grid with the ancestor blocks replicated at the same local slots
([2, 2 + max_anc) of every rank's pool) on every layer; the layers'
partial Schur updates of the ancestors are summed over z (the
``dreduceAllAncestors3d`` analog, pd3dcomm.c); then every layer factors
the top on its replicas (``anc25d="replicated"``), or each layer computes
its round-robin share of a top level's Schur products into a delta that
is summed over z and added on every layer (``"zsplit"``, the anc25d.hpp
analog).

The host side (:func:`partition_forest`, :class:`DistPlan3D` and
:func:`partition_plan3d` in both modes, :class:`DistTransPlan3D`) is a
copy of the JAX package's numpy code, array for array. The JAX package
runs the factor and the sweeps as ``shard_map`` programs of einsums and
psums (no Pallas kernel); here they run on the 2D grid's hand-written
kernels (``csrc/rdma.cu``, ``parallel/dist2d_rdma.py``) over tapes of
``ndev`` = Pz·Pr·Pc ranks, rank (z·Pr + r)·Pc + c:

- :func:`build_factor_tapes3d`: level l of the combined schedule is layer
  z's compacted subtree level l for l < ``max_p1`` (empty where the layer
  has fewer levels, and then no launch covers it), then the shared top
  levels; one launch per phase per level covers every rank of every
  layer, and each layer's puts stay inside it;
- :func:`ancestor_reduce` between the phases: for each (r, c), the
  ancestor slots summed over the layers in layer order z = 0, 1, …, and
  the sum written back to every layer (torch ops: the JAX package's psum
  over 'z' is XLA, not a TPU kernel);
- zsplit: each rank's pool carries ``max_tact`` delta rows after its
  ``n_local`` slots; a top level's Schur products of this layer's share
  target them (``rdma_schur`` unchanged), and :func:`apply_delta` sums the
  rows over the layers in layer order and adds the sum to every layer's
  touched ancestor slots in ``t2loc`` order;
- :func:`build_sweep_tapes3d`: the L, U, Uᵀ and Lᵀ sweeps with the
  products of a layer slot on its own layer and those of an ancestor slot
  on layer 0, a row solved by its diagonal block's rank (layer 0 for an
  ancestor row), every rank's X replicated, a row's partials gathered
  from every layer in (z, c) order (``rdma_solve_sum``'s ``npeer`` =
  Pz·Pc, Pz·Pr transposed).

The inverse tables stay with the ranks that computed them: a subtree
step's on its owner, a top step's on its owner in every layer; the solve
reads a row's from the rank that solves it.

With the ranks split over processes (``parallel/multihost.py``; a share
of whole layers each when Pz is a multiple of the processes), the kernels
run as on the 2D grid (``dist2d_rdma``), and the reductions over the
layers run on the process that owns the layer-0 rank of each (r, c): it
sums the layers' rows through the window (``parallel/window.py``) in
layer order and writes the sum to every layer's copy, between two
fences. Sharded NRLoc input maps its entries with
:func:`nrloc_entry_offsets3d` and stores them into their owners' pools
(:func:`init_local_pools3d_nrloc`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.blocklu import trans_schedule
from ..ops.host.symbolic import SymbolicPlan
from . import dist2d as _dist2d
from . import dist2d_rdma as _rdma

_ZERO = 0
_TRASH = 1
_RESERVED = 2

#: the top-level strategies of ``Options.anc25d``
ANC25D = ("replicated", "zsplit")


# ---------------------------------------------------------------------------
# the forest partition and the 3D plan (copies of the JAX package's code)
# ---------------------------------------------------------------------------


def step_costs(plan: SymbolicPlan) -> np.ndarray:
    """Block-op cost model per elimination step (for load balancing)."""
    cost = np.ones(plan.nb, dtype=np.float64)
    cost += np.diff(plan.l_ptr) + np.diff(plan.u_ptr)
    cost += 2.0 * np.diff(plan.g_ptr)
    return cost


def partition_forest(plan: SymbolicPlan, pz: int):
    """Assign elimination steps to z-layers.

    Returns ``step_layer`` (nb,) with -1 for the shared ancestor top.
    The top is ancestor-closed; subtree independence is validated against
    the gemm tape and violators promoted into the top.
    """
    nb = plan.nb
    parent = plan.block_parent
    cost = step_costs(plan)
    total = float(cost.sum())

    # children have smaller index than parents in an etree (parent > k), so
    # ascending order accumulates subtree costs correctly
    sub = cost.copy()
    for k in range(nb):
        p = parent[k]
        if p >= 0:
            sub[p] += sub[k]

    if pz <= 1:
        return np.zeros(nb, dtype=np.int64)

    in_top = sub > (total / pz)
    # ancestor closure (monotone by construction; enforce anyway)
    for k in range(nb - 1, -1, -1):
        p = parent[k]
        if p >= 0 and in_top[k]:
            in_top[p] = True

    def promote(k):
        while k >= 0 and not in_top[k]:
            in_top[k] = True
            k = parent[k]

    # children lists (for peeling large subtrees)
    children = [[] for _ in range(nb)]
    for k in range(nb):
        if parent[k] >= 0:
            children[parent[k]].append(k)

    # maximal subtrees below the top → greedy balance into pz bins
    step_layer = np.full(nb, -1, dtype=np.int64)
    for _ in range(nb):  # fixpoint loop (promotions shrink subtrees)
        roots = [k for k in range(nb)
                 if not in_top[k] and (parent[k] < 0 or in_top[parent[k]])]
        # peel the heaviest subtree until enough independent roots exist
        # (the getForests level-descent: more levels → more, smaller trees)
        guard = 0
        while len(roots) < pz and roots and guard < nb:
            guard += 1
            r = max(roots, key=lambda q: sub[q])
            kids = [c for c in children[r] if not in_top[c]]
            if not kids and len(roots) == 1:
                break
            in_top[r] = True
            roots.remove(r)
            roots.extend(kids)
            if not kids and not roots:
                break
        # subtree membership: parents have larger indices, so a single
        # descending pass propagates each root's id down its subtree
        comp = np.full(nb, -1, dtype=np.int64)
        for r in roots:
            comp[r] = r
        for k in range(nb - 1, -1, -1):
            if in_top[k] or comp[k] >= 0:
                continue
            p = parent[k]
            if p >= 0 and comp[p] >= 0:
                comp[k] = comp[p]

        bin_cost = np.zeros(pz)
        bin_of = {}
        for r in sorted(roots, key=lambda r: -sub[r]):
            b = int(np.argmin(bin_cost))
            bin_of[r] = b
            bin_cost[b] += sub[r]
        step_layer[:] = -1
        for k in range(nb):
            if not in_top[k] and comp[k] >= 0:
                step_layer[k] = bin_of[comp[k]]

        # validate subtree independence against the gemm tape: any update
        # crossing layers (or from the top into a layer) promotes its target
        slot_step = plan.slot_step
        bad = []
        for k in range(nb):
            for t in range(plan.g_ptr[k], plan.g_ptr[k + 1]):
                a = int(slot_step[plan.g_t[t]])
                if step_layer[a] >= 0 and step_layer[a] != step_layer[k]:
                    bad.append(a)
        if not bad:
            break
        for a in bad:
            promote(a)
    return step_layer


@dataclasses.dataclass
class DistPlan3D:
    """The JAX package's 3D partition, field for field: placement of the
    global slots, the factor's per-rank tapes over the combined schedule
    (levels = phase 1 ++ top) and the solve's, stacked (pz, pr, pc,
    ...)."""

    pz: int
    pr: int
    pc: int
    nb: int
    bs: int
    n_local: int
    max_anc: int          # ancestor slots per device: locals [2, 2+max_anc)
    max_p1: int           # phase-1 level count (padded across layers)
    ntop: int             # phase-2 (top) level count
    max_lbuf: int
    max_ubuf: int
    step_layer: np.ndarray

    # placement (for init + gather): global slot -> (2D device, local, anc?)
    slot_rc: np.ndarray
    slot_local: np.ndarray
    slot_is_anc: np.ndarray

    # factor tapes (pz, pr, pc, ...), levels = phase1 ++ top
    dptr: np.ndarray
    dstep: np.ndarray
    dloc: np.ndarray
    dpil: np.ndarray        # position of the step within its level
    max_dlvl: int           # compact inverse-broadcast buffer rows
    lptr: np.ndarray
    lloc: np.ndarray
    lpos: np.ndarray
    lstep: np.ndarray
    lpil: np.ndarray
    uptr: np.ndarray
    uloc: np.ndarray
    upos: np.ndarray
    ustep: np.ndarray
    upil: np.ndarray
    gptr: np.ndarray
    glpos: np.ndarray
    gupos: np.ndarray
    gtloc: np.ndarray

    # solve tapes (pz, pr, pc, ...)
    lsol_gptr: np.ndarray
    lsol_gloc: np.ndarray
    lsol_gsrc: np.ndarray
    lsol_gdst: np.ndarray
    usol_gptr: np.ndarray
    usol_gloc: np.ndarray
    usol_gsrc: np.ndarray
    usol_gdst: np.ndarray

    # anc25d analog (reference: CplusplusFactor/anc25d.hpp, env ANC25D):
    # "zsplit" divides the top (ancestor) levels' Schur gemms across the
    # z layers instead of computing them redundantly on every layer —
    # gemm flops/layer drop ~pz-fold at the cost of one z-psum of the
    # level's touched ancestor blocks. Tapes present only in that mode.
    anc25d: str = "replicated"
    t2ptr: np.ndarray = None      # (pz, pr, pc, nlvl+1) scatter ranges
    t2loc: np.ndarray = None      # local slots in compact-position order
    max_tact: int = 0             # max touched ancestor blocks per level

    @property
    def nlvl(self) -> int:
        """Levels of the combined schedule."""
        return self.max_p1 + self.ntop

    # ---- comm accounting (bytes per psum; the SCT comm-volume role) ----
    def comm_volume(self, itemsize: int, nrhs: int = 1) -> dict:
        """Collective payload of the JAX package's 3D program, as its
        ``Stats`` counters record it: per-level inverse/panel psums over
        r,c; the one ancestor z-reduction (dreduceAllAncestors3d analog);
        optional anc25d z-psums; solve X-sized psums over all axes per
        level. The puts of ``rdma.cu`` move the blocks that these psums
        replicate."""
        bsb = self.bs * self.bs * itemsize
        nlvl = self.max_p1 + self.ntop
        fac = nlvl * (2 * (self.max_dlvl + 1)
                      + (self.max_lbuf + 2) + (self.max_ubuf + 2)) * bsb
        anc = self.max_anc * bsb            # the z ancestor reduction
        if self.anc25d == "zsplit":
            anc += self.ntop * (self.max_tact + 1) * bsb
        xrow = self.bs * nrhs * itemsize
        snlvl = (self.lsol_gptr.shape[-1] - 1
                 + self.usol_gptr.shape[-1] - 1)
        sol = snlvl * (self.nb + 1) * xrow      # full-X psum per level
        return {"factor_psum_bytes": int(fac),
                "anc_reduce_bytes": int(anc),
                "solve_psum_bytes": int(sol)}


def _compact_levels(steps, global_level):
    """Group ``steps`` by their global level, compacted to consecutive."""
    if len(steps) == 0:
        return []
    lvls = sorted(set(int(global_level[k]) for k in steps))
    remap = {lv: i for i, lv in enumerate(lvls)}
    out = [[] for _ in lvls]
    for k in sorted(steps):
        out[remap[int(global_level[k])]].append(int(k))
    return out


def _solve_pack3d(nb, pz, pr, pc, slot_is_anc, slot_layer, slot_rc,
                  slot_local, gptr_g, gslot_g, gsrc_g, gdst_g, snlvl):
    """Group one sweep's gemms by (layer, 2D device, level). Ancestor
    slots are worked on layer 0 only (their replicas are identical after
    the z reduction — counting them once keeps the psum exact)."""
    ndev2 = pr * pc
    lists = [[[[] for _ in range(snlvl)] for _ in range(ndev2)]
             for _ in range(pz)]
    for l in range(snlvl):
        for t in range(gptr_g[l], gptr_g[l + 1]):
            s = gslot_g[t]
            z = 0 if slot_is_anc[s] else int(slot_layer[s])
            lists[z][slot_rc[s]][l].append(
                (int(slot_local[s]), int(gsrc_g[t]), int(gdst_g[t])))
    ptrs = np.zeros((pz, ndev2, snlvl + 1), dtype=np.int64)
    maxlen = 1
    for z in range(pz):
        for d in range(ndev2):
            for l in range(snlvl):
                ptrs[z, d, l + 1] = ptrs[z, d, l] + len(lists[z][d][l])
        maxlen = max(maxlen, int(ptrs[z, :, -1].max()))
    loc = np.full((pz, ndev2, maxlen), _ZERO, dtype=np.int32)
    src = np.zeros((pz, ndev2, maxlen), dtype=np.int32)
    dst = np.full((pz, ndev2, maxlen), nb, dtype=np.int32)
    for z in range(pz):
        for d in range(ndev2):
            pos = 0
            for l in range(snlvl):
                for (a, b, c) in lists[z][d][l]:
                    loc[z, d, pos] = a
                    src[z, d, pos] = b
                    dst[z, d, pos] = c
                    pos += 1
    return (ptrs.reshape(pz, pr, pc, snlvl + 1).astype(np.int32),
            loc.reshape(pz, pr, pc, maxlen),
            src.reshape(pz, pr, pc, maxlen),
            dst.reshape(pz, pr, pc, maxlen))


def partition_plan3d(plan: SymbolicPlan, pz: int, pr: int, pc: int,
                     anc25d: str = "replicated") -> DistPlan3D:
    """Distribute the plan over a Pz × Pr × Pc grid (the JAX package's
    ``partition_plan3d``): local numbering with the ancestors first
    (identical on every layer), then each layer's slots; the factor's
    tapes over the combined schedule; the zsplit scatter tapes."""
    nb = plan.nb
    zsplit = anc25d == "zsplit"
    srow, scol = plan.slot_row, plan.slot_col
    step_layer = partition_forest(plan, pz)
    slot_step = plan.slot_step
    slot_layer = step_layer[slot_step]            # -1 = ancestor slot
    slot_is_anc = slot_layer < 0
    slot_rc = (srow % pr) * pc + (scol % pc)
    ndev2 = pr * pc

    # local numbering: ancestors first (identical across z), then layer slots
    slot_local = np.zeros(plan.nslots, dtype=np.int64)
    anc_count = np.zeros(ndev2, dtype=np.int64)
    for s in np.flatnonzero(slot_is_anc):
        d = slot_rc[s]
        slot_local[s] = _RESERVED + anc_count[d]
        anc_count[d] += 1
    max_anc = int(anc_count.max()) if ndev2 else 0
    lay_count = np.zeros((pz, ndev2), dtype=np.int64)
    for s in np.flatnonzero(~slot_is_anc):
        d = slot_rc[s]
        z = slot_layer[s]
        slot_local[s] = _RESERVED + max_anc + lay_count[z, d]
        lay_count[z, d] += 1
    n_local = _RESERVED + max_anc + (int(lay_count.max()) if lay_count.size
                                     else 0)

    # schedules
    layer_scheds, top_sched = _schedules(plan, step_layer, pz)
    max_p1 = max((len(s) for s in layer_scheds), default=0)
    ntop = len(top_sched)
    nlvl = max_p1 + ntop

    # ---- per-z tape building over the combined schedule ----
    tape_lists = []   # per z: dict of lists
    max_lbuf = 1
    max_ubuf = 1
    # zsplit bookkeeping: compact positions of touched ancestor targets
    # per (device, top level) — rebuilt identically on every z pass
    # (same deterministic iteration), kept from the last pass for the
    # scatter tapes
    tpos_of: dict = {}
    for z in range(pz):
        sched = (layer_scheds[z] + [[] for _ in
                                    range(max_p1 - len(layer_scheds[z]))]
                 + top_sched)
        d_l = [[[] for _ in range(nlvl)] for _ in range(ndev2)]
        l_l = [[[] for _ in range(nlvl)] for _ in range(ndev2)]
        u_l = [[[] for _ in range(nlvl)] for _ in range(ndev2)]
        g_l = [[[] for _ in range(nlvl)] for _ in range(ndev2)]
        for l, steps in enumerate(sched):
            lrow_count = np.zeros(pr, dtype=np.int64)
            ucol_count = np.zeros(pc, dtype=np.int64)
            lpos_of = {}
            upos_of = {}
            pil_of = {int(k): i for i, k in enumerate(steps)}
            for k in steps:
                ds = plan.diag_slot[k]
                d_l[slot_rc[ds]][l].append((int(k), int(slot_local[ds]),
                                            pil_of[int(k)]))
                for s in plan.l_slots[plan.l_ptr[k]:plan.l_ptr[k + 1]]:
                    r = int(srow[s] % pr)
                    pos = int(lrow_count[r])
                    lrow_count[r] += 1
                    lpos_of[int(s)] = pos
                    l_l[slot_rc[s]][l].append(
                        (int(slot_local[s]), pos, int(k),
                         pil_of[int(k)]))
                for s in plan.u_slots[plan.u_ptr[k]:plan.u_ptr[k + 1]]:
                    c = int(scol[s] % pc)
                    pos = int(ucol_count[c])
                    ucol_count[c] += 1
                    upos_of[int(s)] = pos
                    u_l[slot_rc[s]][l].append(
                        (int(slot_local[s]), pos, int(k),
                         pil_of[int(k)]))
            max_lbuf = max(max_lbuf, int(lrow_count.max(initial=0)))
            max_ubuf = max(max_ubuf, int(ucol_count.max(initial=0)))
            if zsplit and l >= max_p1:
                # anc25d zsplit: round-robin the level's gemms over z,
                # destinations remapped to compact per-level positions
                # (the delta buffer the z-psum reduces)
                if z == 0:
                    for d in range(ndev2):
                        tpos_of[(d, l)] = {}
                zcnt = np.zeros(ndev2, dtype=np.int64)
                for k in steps:
                    for t in range(plan.g_ptr[k], plan.g_ptr[k + 1]):
                        tgt = int(plan.g_t[t])
                        d = int(slot_rc[tgt])
                        pos_map = tpos_of[(d, l)]
                        p = pos_map.setdefault(tgt, len(pos_map))
                        if zcnt[d] % pz == z:
                            g_l[d][l].append(
                                (lpos_of[int(plan.g_l[t])],
                                 upos_of[int(plan.g_u[t])], p))
                        zcnt[d] += 1
            else:
                for k in steps:
                    for t in range(plan.g_ptr[k], plan.g_ptr[k + 1]):
                        tgt = plan.g_t[t]
                        g_l[slot_rc[tgt]][l].append(
                            (lpos_of[int(plan.g_l[t])],
                             upos_of[int(plan.g_u[t])],
                             int(slot_local[tgt])))
        tape_lists.append((d_l, l_l, u_l, g_l))

    def pack(z_lists, idx, nfields, fills):
        maxlen = 1
        ptrs = np.zeros((pz, ndev2, nlvl + 1), dtype=np.int64)
        for z in range(pz):
            lists = z_lists[z][idx]
            for d in range(ndev2):
                for l in range(nlvl):
                    ptrs[z, d, l + 1] = ptrs[z, d, l] + len(lists[d][l])
            maxlen = max(maxlen, int(ptrs[z, :, -1].max()))
        out = [np.full((pz, ndev2, maxlen), fills[f], dtype=np.int32)
               for f in range(nfields)]
        for z in range(pz):
            lists = z_lists[z][idx]
            for d in range(ndev2):
                pos = 0
                for l in range(nlvl):
                    for item in lists[d][l]:
                        for f in range(nfields):
                            out[f][z, d, pos] = item[f]
                        pos += 1
        ptrs = ptrs.reshape(pz, pr, pc, nlvl + 1).astype(np.int32)
        return ptrs, [o.reshape(pz, pr, pc, maxlen) for o in out]

    # compact inverse-broadcast positions (position-in-level): comm per
    # level is proportional to the level's steps, not nb
    max_dlvl = max(1, max((len(steps) for z in range(pz)
                           for steps in (layer_scheds[z] + top_sched)),
                          default=1))
    max_tact = max((len(v) for v in tpos_of.values()), default=0) \
        if zsplit else 0
    dptr, (dstep, dloc, dpil) = pack(tape_lists, 0, 3,
                                     [nb, _TRASH, max_dlvl])
    lptr, (lloc, lpos, lstep, lpil) = pack(tape_lists, 1, 4,
                                           [_TRASH, 0, nb, max_dlvl])
    uptr, (uloc, upos, ustep, upil) = pack(tape_lists, 2, 4,
                                           [_TRASH, 0, nb, max_dlvl])
    gptr, (glpos, gupos, gtloc) = pack(
        tape_lists, 3, 3, [0, 0, max_tact if zsplit else _TRASH])

    # ---- zsplit scatter tapes: per (device, top level) the touched
    # ancestor slots in compact-position order (replicated across z —
    # every layer applies the SAME summed delta, keeping replicas
    # synchronized for the next level's panels) ----
    t2ptr = t2loc = None
    if zsplit:
        ptr1 = np.zeros((ndev2, nlvl + 1), dtype=np.int64)
        for d in range(ndev2):
            for l in range(nlvl):
                ptr1[d, l + 1] = ptr1[d, l] + len(tpos_of.get((d, l), {}))
        t2len = max(1, int(ptr1[:, -1].max()))
        loc1 = np.full((ndev2, t2len), _TRASH, dtype=np.int32)
        for d in range(ndev2):
            p0 = 0
            for l in range(nlvl):
                for tgt in tpos_of.get((d, l), {}):
                    loc1[d, p0] = slot_local[tgt]
                    p0 += 1
        t2ptr = np.broadcast_to(
            ptr1.reshape(1, pr, pc, nlvl + 1),
            (pz, pr, pc, nlvl + 1)).astype(np.int32).copy()
        t2loc = np.broadcast_to(
            loc1.reshape(1, pr, pc, t2len),
            (pz, pr, pc, t2len)).astype(np.int32).copy()

    # ---- solve tapes: layer-slot work on its layer, ancestor work on z=0 --
    lsg = _solve_pack3d(nb, pz, pr, pc, slot_is_anc, slot_layer, slot_rc,
                        slot_local, plan.lsol_gptr, plan.lsol_gslot,
                        plan.lsol_gsrc, plan.lsol_gdst, plan.lsol_nlvl)
    usg = _solve_pack3d(nb, pz, pr, pc, slot_is_anc, slot_layer, slot_rc,
                        slot_local, plan.usol_gptr, plan.usol_gslot,
                        plan.usol_gsrc, plan.usol_gdst, plan.usol_nlvl)

    return DistPlan3D(
        pz=pz, pr=pr, pc=pc, nb=nb, bs=plan.bs, n_local=n_local,
        max_anc=max_anc, max_p1=max_p1, ntop=ntop,
        max_lbuf=max_lbuf, max_ubuf=max_ubuf, step_layer=step_layer,
        slot_rc=slot_rc, slot_local=slot_local, slot_is_anc=slot_is_anc,
        dptr=dptr, dstep=dstep, dloc=dloc, dpil=dpil, max_dlvl=max_dlvl,
        lptr=lptr, lloc=lloc, lpos=lpos, lstep=lstep, lpil=lpil,
        uptr=uptr, uloc=uloc, upos=upos, ustep=ustep, upil=upil,
        gptr=gptr, glpos=glpos, gupos=gupos, gtloc=gtloc,
        lsol_gptr=lsg[0], lsol_gloc=lsg[1], lsol_gsrc=lsg[2],
        lsol_gdst=lsg[3],
        usol_gptr=usg[0], usol_gloc=usg[1], usol_gsrc=usg[2],
        usol_gdst=usg[3],
        anc25d=anc25d, t2ptr=t2ptr, t2loc=t2loc, max_tact=max_tact,
    )


def _schedules(plan: SymbolicPlan, step_layer, pz: int):
    """Each layer's subtree steps by compacted level, and the top's."""
    layers = [_compact_levels(np.flatnonzero(step_layer == z),
                              plan.step_level) for z in range(pz)]
    return layers, _compact_levels(np.flatnonzero(step_layer < 0),
                                   plan.step_level)


@dataclasses.dataclass
class DistTransPlan3D:
    """Tapes for the Aᵀ solve on the 3D grid: Uᵀ forward then Lᵀ backward
    level sweeps, work split like the forward solve (ancestor slots on
    layer 0)."""

    nlvl_u: int
    nlvl_l: int
    ut_gptr: np.ndarray
    ut_gloc: np.ndarray
    ut_gsrc: np.ndarray
    ut_gdst: np.ndarray
    lt_gptr: np.ndarray
    lt_gloc: np.ndarray
    lt_gsrc: np.ndarray
    lt_gdst: np.ndarray
    # replicated diag apply schedules
    ut_dptr: np.ndarray
    ut_diag: np.ndarray
    lt_dptr: np.ndarray
    lt_diag: np.ndarray


def trans_partition_plan3d(plan: SymbolicPlan,
                           dplan: DistPlan3D) -> DistTransPlan3D:
    """The JAX package's ``trans_partition_plan3d``: the transposed
    sweeps' products grouped by (layer, rank, level), on the placement of
    the forward solve (:func:`build_sweep_tapes3d` with "UT" and "LT"
    derives the kernels' job lists from the same placement)."""
    pz, pr, pc = dplan.pz, dplan.pr, dplan.pc
    slot_layer = dplan.step_layer[plan.slot_step]
    gpu, gsu, gru, gdu, dpu, dgu, nlu = trans_schedule(plan, "U")
    gpl, gsl, grl, gdl, dpl, dgl, nll = trans_schedule(plan, "L")
    usg = _solve_pack3d(plan.nb, pz, pr, pc, dplan.slot_is_anc, slot_layer,
                        dplan.slot_rc, dplan.slot_local,
                        gpu, gsu, gru, gdu, nlu)
    lsg = _solve_pack3d(plan.nb, pz, pr, pc, dplan.slot_is_anc, slot_layer,
                        dplan.slot_rc, dplan.slot_local,
                        gpl, gsl, grl, gdl, nll)
    return DistTransPlan3D(
        nlvl_u=nlu, nlvl_l=nll,
        ut_gptr=usg[0], ut_gloc=usg[1], ut_gsrc=usg[2], ut_gdst=usg[3],
        lt_gptr=lsg[0], lt_gloc=lsg[1], lt_gsrc=lsg[2], lt_gdst=lsg[3],
        ut_dptr=dpu, ut_diag=dgu, lt_dptr=dpl, lt_diag=dgl,
    )


# ---------------------------------------------------------------------------
# placement on the ranks, and the pools
# ---------------------------------------------------------------------------


def slot_ranks(plan: SymbolicPlan, dplan: DistPlan3D) -> np.ndarray:
    """The rank that holds each global slot's values: its layer's (layer
    0 for an ancestor slot), at (slot row mod Pr, slot column mod Pc)."""
    z = np.where(np.asarray(dplan.slot_is_anc), 0,
                 np.asarray(dplan.step_layer)[np.asarray(plan.slot_step)])
    return (z * (dplan.pr * dplan.pc)
            + np.asarray(dplan.slot_rc)).astype(np.int64)


def row_layers(dplan: DistPlan3D) -> np.ndarray:
    """The layer that solves each block row: its step's, 0 for the
    top."""
    return np.maximum(np.asarray(dplan.step_layer), 0)


def inverse_rows(plan: SymbolicPlan, dplan: DistPlan3D) -> np.ndarray:
    """Each step's row in its solving rank's inverse tables: its position
    in that rank's d tape (a top step is on every layer's; the solve
    reads layer 0's)."""
    nb, lay = plan.nb, dplan.pr * dplan.pc
    dstep = np.asarray(dplan.dstep).reshape(dplan.pz * lay, -1)
    k = np.arange(nb)
    owner = row_layers(dplan) * lay + (k % dplan.pr) * dplan.pc \
        + k % dplan.pc
    idx = np.full(nb, -1, dtype=np.int64)
    for d in range(dstep.shape[0]):
        i = np.flatnonzero(dstep[d] < nb)
        mine = owner[dstep[d, i]] == d
        idx[dstep[d, i[mine]]] = i[mine]
    if (idx < 0).any():
        raise AssertionError("a step without its inverse on its rank")
    return idx


def init_local_pools3d(plan: SymbolicPlan, dplan: DistPlan3D, a_data,
                       dtype, device, extra: int = 0, win=None) -> list:
    """One ``(n_local + extra, bs, bs)`` pool per rank, rank (z·Pr + r)·Pc
    + c at that index, scattered on the host rank by rank (the
    ``init_local_pools3d`` of the JAX package): an ancestor replica gets
    A's values on layer 0 only, so the reduction over the layers counts
    each value once. ``a_data`` is in the CSC data order of the matrix the
    plan was built from; padding diagonal entries get 1.0; the ``extra``
    rows (zsplit's delta rows) start at zero. With a window the pools are
    its tensors and this process fills its own ranks' only."""
    dev, off, vals = _dist2d.init_entries(
        plan, slot_ranks(plan, dplan), np.asarray(dplan.slot_local), a_data,
        dtype)
    return _dist2d.fill_pools(dev, off, vals,
                              dplan.pz * dplan.pr * dplan.pc,
                              dplan.n_local + extra, plan.bs, dtype, device,
                              win)


def nrloc_entry_offsets3d(plan: SymbolicPlan, dplan: DistPlan3D, chunks,
                          row_scale, col_scale, rowperm, colperm,
                          expand, n_e, n, *, embed=False,
                          with_identity=False):
    """3D-grid owner mapping over dist2d.nrloc_slot_entries: ancestor
    slots land on their layer-0 replica (init convention of
    init_local_pools3d — the z reduction then counts each value once)."""
    bs = plan.bs
    bb = bs * bs
    slot, ri, ci, v = _dist2d.nrloc_slot_entries(
        plan, chunks, row_scale, col_scale, rowperm, colperm,
        expand, n_e, n, embed=embed, with_identity=with_identity)
    dev = slot_ranks(plan, dplan)[slot].astype(np.int32)
    off = (np.asarray(dplan.slot_local)[slot] * bb
           + ri.astype(np.int64) * bs + ci)
    return dev, off.astype(np.int64), v


def init_local_pools3d_nrloc(plan: SymbolicPlan, dplan: DistPlan3D, win,
                             dev, off, vals, dtype, extra: int = 0) -> list:
    """3D analog of dist2d.init_local_pools_nrloc: the window's ``(n_local
    + extra, bs, bs)`` pools from every process's entry streams."""
    return _dist2d.scatter_pools(dev, off, np.asarray(vals, dtype),
                                 dplan.n_local + extra, plan.bs, dtype, win)


# ---------------------------------------------------------------------------
# the kernels' tapes on the 3D grid
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FactorTapes3D(_rdma.FactorTapes):
    """:class:`dist2d_rdma.FactorTapes` over Pz layers, with the phases'
    boundary (``max_p1`` subtree levels, then ``ntop`` top levels), the
    ancestor slots' count, and in zsplit mode (``zsplit``) the delta rows
    (``ndelta`` = max_tact, after each pool's ``n_local`` slots) and each
    top level's scatter lists ``t2[level]``: (rank in the layer, the
    touched local slots as a device tensor, their count)."""

    max_p1: int = 0
    ntop: int = 0
    max_anc: int = 0
    zsplit: bool = False
    ndelta: int = 0
    t2: dict = dataclasses.field(default_factory=dict, repr=False)


def recv_tapes3d(plan: SymbolicPlan, dplan: DistPlan3D) -> dict:
    """The factor's receive counts per (layer, grid row, grid column,
    level) on the combined schedule: each layer counts its own subtree
    levels and the top levels, as a 2D grid that eliminates them
    would."""
    layers, top = _schedules(plan, dplan.step_layer, dplan.pz)
    per = []
    for sched in layers:
        pad = [[] for _ in range(dplan.max_p1 - len(sched))]
        per.append(_rdma.factor_recv_counts(plan, dplan.pr, dplan.pc,
                                            sched + pad + top))
    return {k: np.stack([p[k] for p in per]) for k in per[0]}


def build_factor_tapes3d(plan: SymbolicPlan, dplan: DistPlan3D,
                         device) -> FactorTapes3D:
    """The job lists of the 3D factor: the 2D grid's three phases per
    level of the combined schedule over every rank of every layer; in
    zsplit mode the top levels' Schur targets are the delta rows
    ``n_local + position``."""
    nlvl, ndev = dplan.nlvl, dplan.pz * dplan.pr * dplan.pc
    zsplit = dplan.anc25d == "zsplit" and dplan.ntop > 0
    gtloc = np.asarray(dplan.gtloc).reshape(ndev, -1).astype(np.int64)
    t2 = {}
    if zsplit:
        gptr = np.asarray(dplan.gptr).reshape(ndev, -1)
        for d in range(ndev):
            gtloc[d, gptr[d, dplan.max_p1]:gptr[d, nlvl]] += dplan.n_local
        lay = dplan.pr * dplan.pc
        ptr1 = np.asarray(dplan.t2ptr).reshape(dplan.pz, lay, -1)[0]
        loc1 = np.asarray(dplan.t2loc).reshape(dplan.pz, lay, -1)[0]
        for l in range(dplan.max_p1, nlvl):
            t2[l] = [(d, torch.as_tensor(
                loc1[d, ptr1[d, l]:ptr1[d, l + 1]].astype(np.int64),
                device=device), int(ptr1[d, l + 1] - ptr1[d, l]))
                for d in range(lay) if ptr1[d, l + 1] > ptr1[d, l]]
    ft = _rdma.factor_tapes(dplan, dplan.dpil, gtloc, nlvl, device,
                            recv_tapes3d(plan, dplan), pz=dplan.pz)
    return FactorTapes3D(
        **{f.name: getattr(ft, f.name)
           for f in dataclasses.fields(_rdma.FactorTapes)},
        max_p1=dplan.max_p1, ntop=dplan.ntop, max_anc=dplan.max_anc,
        zsplit=zsplit, ndelta=dplan.max_tact if zsplit else 0, t2=t2)


def build_sweep_tapes3d(plan: SymbolicPlan, dplan: DistPlan3D, which: str,
                        device, chunk: int | None = None
                        ) -> _rdma.SweepTapes:
    """The job lists of one sweep ("L", "U", or the transposed "UT",
    "LT") on the 3D grid: each product on the rank that holds its slot
    (layer 0 for an ancestor slot), each row solved by its diagonal
    block's rank with that rank's inverses, its partials from the ranks
    of its grid row (column) on every layer."""
    t, c = _rdma.solve_tapes(
        plan, which, dplan.pz, dplan.pr, dplan.pc, slot_ranks(plan, dplan),
        np.asarray(dplan.slot_local), row_layers(dplan),
        inverse_rows(plan, dplan), (dplan.pz, dplan.pr, dplan.pc))
    return _rdma.sweep_tapes(t, c, which, dplan.pz, dplan.pr, dplan.pc,
                             device, chunk)


# ---------------------------------------------------------------------------
# the factor: kernel 11's entries per level, the reductions between them
# ---------------------------------------------------------------------------


def _layers(ft: FactorTapes3D, d2: int) -> list:
    """The ranks (z, r, c) of every layer z, for rank d2 = r·Pc + c of a
    layer, in layer order."""
    lay = ft.pr * ft.pc
    return [z * lay + d2 for z in range(ft.pz)]


def _reduced_here(st: _rdma.FactorState, d2s):
    """The ranks d2 of a layer among ``d2s`` whose reduction over the
    layers this process runs (it owns their layer-0 rank), between two
    fences of the window."""
    st.win.fence()
    yield from (d2 for d2 in d2s if st.win.lo <= d2 < st.win.hi)
    st.win.fence()


def ancestor_reduce(st: _rdma.FactorState, ft: FactorTapes3D) -> None:
    """The ``dreduceAllAncestors3d`` analog between the phases: for each
    (r, c), the ancestor slots [2, 2 + max_anc) summed over the layers in
    layer order (z = 0, 1, …), the sum written back to every layer."""
    if ft.pz == 1 or ft.max_anc == 0:
        return
    anc = slice(_RESERVED, _RESERVED + ft.max_anc)
    for d2 in _reduced_here(st, range(ft.pr * ft.pc)):
        ranks = _layers(ft, d2)
        acc = st.pool[ranks[0]][anc].clone()
        for e in ranks[1:]:
            acc += st.pool[e][anc]
        for e in ranks:
            st.pool[e][anc] = acc


def apply_delta(st: _rdma.FactorState, ft: FactorTapes3D,
                level: int) -> None:
    """zsplit after a top level's Schur products: each (r, c)'s delta
    rows summed over the layers in layer order, the sum added to every
    layer's touched ancestor slots (``t2loc`` order), the rows zeroed for
    the next level."""
    n0 = ft.n_local
    t2 = {d2: (slots, m) for d2, slots, m in ft.t2.get(level, ())}
    for d2 in _reduced_here(st, sorted(t2)):
        slots, m = t2[d2]
        ranks = _layers(ft, d2)
        acc = st.pool[ranks[0]][n0:n0 + m].clone()
        for e in ranks[1:]:
            acc += st.pool[e][n0:n0 + m]
        for e in ranks:
            p = st.pool[e]
            p[slots] = p[slots] + acc
            p[n0:n0 + m] = 0


def before_level(st: _rdma.FactorState, ft: FactorTapes3D,
                 level: int) -> None:
    """What runs between the levels before ``level``'s three phases: the
    ancestor reduction at the first top level."""
    if level == ft.max_p1:
        ancestor_reduce(st, ft)


def after_level(st: _rdma.FactorState, ft: FactorTapes3D,
                level: int) -> None:
    """What runs after ``level``'s three phases: zsplit's delta over the
    layers at a top level."""
    if ft.zsplit and level >= ft.max_p1:
        apply_delta(st, ft, level)


def factor_level3d(st: _rdma.FactorState, thresh: float, ft: FactorTapes3D,
                   level: int, plain: bool = False) -> None:
    """One level of the combined schedule on every layer:
    :func:`before_level`, ``rdma_diag``, ``rdma_panel``, ``rdma_schur``
    (their plain versions with ``plain``), :func:`after_level`."""
    before_level(st, ft, level)
    _rdma.rdma_factor_level(st, thresh, ft, level, plain)
    after_level(st, ft, level)


def _tiny(st: _rdma.FactorState) -> torch.Tensor:
    return torch.stack(st.tiny).sum()


def rdma_factor3d(pools, thresh: float, ft: FactorTapes3D,
                  plain: bool = False, win=None):
    """Factor the per-rank ``pools`` (with ``ft.ndelta`` delta rows each)
    in place: the subtree levels, the ancestor reduction, the top levels.
    Returns the factor's buffers and the tiny-pivot count as a device
    scalar: the subtree steps' replacements plus the top's divided by Pz
    (every layer factors each top tile, as the JAX package counts). With
    the ranks split over processes the pools are tensors of ``win``, and
    the factor ends with a fence."""
    st = _rdma.new_factor_state(pools, ft, win)
    tiny1 = None
    for level in range(ft.nlvl):
        if level == ft.max_p1:
            tiny1 = _tiny(st)
        factor_level3d(st, thresh, ft, level, plain)
    st.win.fence()
    total = _tiny(st)
    if tiny1 is None:
        return st, total
    return st, tiny1 + torch.div(total - tiny1, ft.pz, rounding_mode="floor")
