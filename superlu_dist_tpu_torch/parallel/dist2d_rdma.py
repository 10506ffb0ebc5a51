"""Kernels 11–12: the 2D block-cyclic factor and triangular sweeps with
puts into the peer ranks' buffers.

Counterpart of the JAX package's ``parallel/dist2d_rdma.py``. There one
Pallas kernel per rank (``_rdma_kernel``: the whole factor;
``_rdma_solve_kernel``: one L or U sweep) walks the elimination levels as
its sequential grid, broadcasts blocks by remote DMA into the peers'
buffers and fences each level by counted receive waits and a barrier.
Here the ranks of the grid live in one process (or split over several,
below), and each phase of each level is one launch that covers the jobs
of all the process's ranks (``csrc/rdma.cu``):

- :func:`rdma_factor`: per level ``rdma_diag`` (owned diagonal tiles, linv
  put along the grid row into ``lC``, uinv down the column into ``uC``),
  ``rdma_panel`` (owned L and U panels times the received inverses, put
  into ``lB`` / ``uB``) and ``rdma_schur`` (owned Schur products from the
  broadcast buffers, grouped by target);
- :func:`rdma_solve`: the L sweep, then the U sweep, each per level
  ``rdma_solve_chunks`` (each rank's chain into a row position cut into
  chunks in tape order, one CTA per chunk into the rank's chunk scratch),
  ``rdma_solve_sum`` (a rank's partial of the position, its chunks summed
  in chunk order, put by non-owners into the diagonal owner's slots;
  with the chunks, :func:`rdma_solve_gemm`) and ``rdma_solve_diag`` (the
  owner's diagonal apply, x put into every rank's replicated X).

A put is a store by the producing kernel into the peer's buffer, reached
through a device table of every rank's buffer pointers, and adds one to
the receiver's counter for (level, kind); the counters are held against
the TPU's receive tapes (:func:`build_rdma_recv_tapes`, the solve tapes'
``rcv_part`` / ``rcv_x``). Every phase has a plain PyTorch version beside
it (``*_plain``): level by level, rank by rank over the same job lists,
with the puts as indexed copies into the peers' tensors and each receive
tallied. On a CPU tensor the wrappers run the plain versions; on a CUDA
tensor they launch the kernel or raise.

Every entry serves float32, float64, complex64 and complex128 (the C
entries ``_f32``, ``_f64``, ``_c64``, ``_c128``; the TPU kernels are
float32 only, and the JAX package runs its XLA grid executor in the
other types). A transposed solve (:func:`rdma_solve` on the transposed
tapes, ``build_sweep_tapes(..., "LT" | "UT", ...)``, whose entries then
launch with ``transpose=1``) runs a forward Uᵀ sweep with ``uinv`` and a
backward Lᵀ sweep with ``linv`` over the schedules of
``dist2d.sweep_schedule``: each product
and each diagonal inverse is applied transposed, and since the block
(I, J) that updates row J lies in grid column J mod Pc, a row's partials
travel down the grid column to the diagonal owner instead of along the
grid row. The flag never conjugates: the driver solves Aᴴx = b as
x = conj(A⁻ᵀ conj(b)).

The ranks may be split over several processes on the one card
(``parallel/multihost.py``): each process owns a contiguous share of the
ranks, allocates their buffers in a :class:`window.Window` that maps the
other processes' buffers into its pointer tables, and launches each phase
over its own ranks' jobs only, ``[ptr[level, d0], ptr[level, d1])`` of a
job list (contiguous, as the lists are level-major and rank-major); its
puts then store into the other processes' buffers unchanged. A fence
(the stream synchronized, then a barrier) follows every phase whose puts
cross processes: ``rdma_diag`` and ``rdma_panel`` of the factor,
``rdma_solve_sum`` and ``rdma_solve_diag`` of a sweep. ``rdma_schur`` and
``rdma_solve_chunks`` write their own rank's buffers only, and the
fence of the next phase that puts covers them. The plain versions loop
over the own ranks in the window's turns (:meth:`window.Window.turns`).
Each job reads the same inputs and sums in the same order as in one
process, so the factors and x are bit-equal to a single process's.

The tapes and buffers cover the ranks of ``pz`` layers of a Pr × Pc grid
(``FactorTapes.pz``, ``SweepTapes.pz``; 1 for the 2D grid): rank
(z·Pr + r)·Pc + c. A factor's puts stay inside the producing rank's
layer; a sweep gathers a row's partials from every layer, ``npeer`` =
Pz·Pc of them (Pz·Pr transposed), in (z, c) order. ``parallel/dist3d.py``
builds such tapes for the 3D grid.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..ops.host.symbolic import SymbolicPlan
from ..ops.kernels._build import CudaKernel, ptr, stream_ptr
from ..ops.kernels.diag_lu import (CUDA_BLOCK_SIZES, CUDA_DTYPES,
                                   DTYPE_NAMES, entry, lu_inv_plain)
from ..ops.kernels.sweep import chunk_chains
from .dist2d import _ZERO, DistPlan2D, sweep_schedule
from .window import Window

_V = ctypes.c_void_p
_I = ctypes.c_int
#: the threshold's C type of each entry (the real type of the element)
_THRESH = {"f32": ctypes.c_float, "f64": ctypes.c_double,
           "c64": ctypes.c_float, "c128": ctypes.c_double}
RDMA_FACTOR = CudaKernel("rdma_factor", "rdma.cu", {
    f"slu_rdma_{name}_{sfx}": args for sfx, th in _THRESH.items()
    for name, args in (
        ("diag", [_V, _I, _I, _I] + [_V] * 4 + [_I, _I, th, _I, _V]),
        ("panel", [_V, _I, _I, _I] + [_V] * 5 + [_I] * 4 + [_V]),
        ("schur", [_V, _I] + [_V] * 5 + [_I] * 3 + [_V]))})
RDMA_SOLVE = CudaKernel("rdma_solve", "rdma.cu", {
    f"slu_rdma_solve_{name}_{sfx}": args for sfx in _THRESH
    for name, args in (
        ("chunks", [_V, _I] + [_V] * 5 + [_I] * 4 + [_V]),
        ("sum", [_V, _I, _I, _I] + [_V] * 6 + [_I] * 5 + [_V]),
        ("diag", [_V, _I, _I, _I] + [_V] * 4 + [_I] * 5 + [_V]))})

#: receive kinds of the factor's counters (rank, level, kind), the TPU's
#: rcv_li, rcv_ui, rcv_l, rcv_u; of a sweep's, rcv_part and rcv_x
FACTOR_RECV = ("rcv_li", "rcv_ui", "rcv_l", "rcv_u")
SOLVE_RECV = ("rcv_part", "rcv_x")
_LI, _UI, _L, _U = range(4)
_PART, _X = range(2)


# ---------------------------------------------------------------------------
# the TPU kernels' tapes (copies of the JAX package's host code)
# ---------------------------------------------------------------------------


def build_rdma_recv_tapes(plan: SymbolicPlan, dplan: DistPlan2D) -> dict:
    """Per-(rank, level) receive counts of the factor's counted waits, as
    (pr, pc, nlvl) int32 arrays:

    - rcv_ui: uinv blocks arriving from column-peer step owners
    - rcv_li: linv blocks arriving from row-peer step owners
    - rcv_l / rcv_u: panel blocks arriving from row / column peers
    """
    step_level = np.asarray(plan.step_level)
    return factor_recv_counts(plan, dplan.pr, dplan.pc, [
        np.flatnonzero(step_level == l) for l in range(dplan.nlvl)])


def factor_recv_counts(plan: SymbolicPlan, pr: int, pc: int,
                       steps_of_level) -> dict:
    """The receive counts of :func:`build_rdma_recv_tapes` for a Pr × Pc
    grid that eliminates the steps ``steps_of_level[l]`` at level l (the
    plan's levels on the 2D grid, one layer's combined schedule on the 3D
    grid)."""
    nlvl = len(steps_of_level)
    scol = np.asarray(plan.slot_col)
    srow = np.asarray(plan.slot_row)
    step_level = np.full(plan.nb, -1, np.int64)
    for l, ks in enumerate(steps_of_level):
        step_level[np.asarray(ks, np.int64)] = l
    steps = np.flatnonzero(step_level >= 0)

    rcv_ui = np.zeros((pr, pc, nlvl), np.int64)
    rcv_li = np.zeros((pr, pc, nlvl), np.int64)
    rcv_l = np.zeros((pr, pc, nlvl), np.int64)
    rcv_u = np.zeros((pr, pc, nlvl), np.int64)

    for k in steps:
        l = step_level[k]
        rk, ck = k % pr, k % pc
        # uinv(k) -> (r, ck) for all r != rk ; linv(k) -> (rk, c) != ck
        for r in range(pr):
            if r != rk:
                rcv_ui[r, ck, l] += 1
        for c in range(pc):
            if c != ck:
                rcv_li[rk, c, l] += 1

    # L blocks (i, k): owner (i%pr, k%pc) puts to (i%pr, c!=k%pc)
    # U blocks (k, j): owner (k%pr, j%pc) puts to (r!=k%pr, j%pc)
    for k in steps:
        l = step_level[k]
        lo, hi = plan.l_ptr[k], plan.l_ptr[k + 1]
        for s in np.asarray(plan.l_slots[lo:hi]):
            i = srow[s]
            orow, ocol = i % pr, k % pc
            for c in range(pc):
                if c != ocol:
                    rcv_l[orow, c, l] += 1
        lo, hi = plan.u_ptr[k], plan.u_ptr[k + 1]
        for s in np.asarray(plan.u_slots[lo:hi]):
            j = scol[s]
            orow, ocol = k % pr, j % pc
            for r in range(pr):
                if r != orow:
                    rcv_u[r, ocol, l] += 1

    return dict(rcv_ui=rcv_ui.astype(np.int32), rcv_li=rcv_li.astype(np.int32),
                rcv_l=rcv_l.astype(np.int32), rcv_u=rcv_u.astype(np.int32))


def build_rdma_solve_tapes(plan: SymbolicPlan, dplan: DistPlan2D,
                           which: str):
    """Per-rank tapes of one RDMA solve sweep, the JAX package's layout
    and pads: ``which`` is "L" or "U" (the TPU's two sweeps), or "UT" /
    "LT", the transposed solve's sweeps (``dist2d.sweep_schedule``), whose
    partials of a row gather down its grid column instead of along its
    grid row (the products into row J are blocks of block column J).

    Returns (tapes, consts): tapes is a dict of (pr, pc, ...) int32
    arrays (``sdstc`` holds the owner's grid column, or in a transposed
    sweep its grid row); consts has nlvl and MAXR (max rows per level,
    the height of the receive slots and of the partial buffer).
    """
    return solve_tapes(plan, which, 1, dplan.pr, dplan.pc,
                       np.asarray(dplan.owner_dev),
                       np.asarray(dplan.local_slot),
                       np.zeros(plan.nb, np.int64),
                       np.asarray(dplan.dinv_idx), (dplan.pr, dplan.pc))


def solve_tapes(plan: SymbolicPlan, which: str, pz: int, pr: int, pc: int,
                slot_rank, slot_local, row_layer, dinv_idx, lead):
    """The tapes of :func:`build_rdma_solve_tapes` on ``pz`` layers of a
    Pr × Pc grid: slot s's products run on rank ``slot_rank[s]`` at local
    slot ``slot_local[s]``; block row I is solved by rank (row_layer[I],
    I mod Pr, I mod Pc) with its inverses at row ``dinv_idx[I]`` of that
    rank's tables. Every rank of the row's grid row (grid column when
    transposed) on every layer holds a partial of it, the owner's index
    among them (``sdstc``) z·Pc + its grid column (z·Pr + its grid row).
    The arrays' leading dimensions are ``lead`` (the ranks' grid
    shape)."""
    nb = plan.nb
    ndev, lay = pz * pr * pc, pr * pc
    gptr_g, gslot_g, gsrc_g, gdst_g, dptr_g, diag_g, nlvl = \
        sweep_schedule(plan, which)
    trans = which.endswith("T")

    pos_of_row = np.zeros(nb, dtype=np.int64)
    maxr = 1
    for l in range(nlvl):
        rows = np.asarray(diag_g[dptr_g[l]:dptr_g[l + 1]], np.int64)
        pos_of_row[rows] = np.arange(len(rows))
        maxr = max(maxr, len(rows))

    g_lists = [[[] for _ in range(nlvl)] for _ in range(ndev)]
    s_lists = [[[] for _ in range(nlvl)] for _ in range(ndev)]
    d_lists = [[[] for _ in range(nlvl)] for _ in range(ndev)]
    rcv_part = np.zeros((ndev, nlvl), np.int64)
    rcv_x = np.zeros((ndev, nlvl), np.int64)

    for l in range(nlvl):
        for t in range(gptr_g[l], gptr_g[l + 1]):
            s = int(gslot_g[t])
            g_lists[slot_rank[s]][l].append(
                (int(slot_local[s]), int(gsrc_g[t]),
                 int(pos_of_row[gdst_g[t]])))
        rows = np.asarray(diag_g[dptr_g[l]:dptr_g[l + 1]], np.int64)
        for I in rows:
            r_own, c_own = int(I % pr), int(I % pc)
            z_own = int(row_layer[I])
            # every rank in grid row I%pr (grid column I%pc when
            # transposed) of every layer holds a (possibly zero) partial
            # for row I: zero it, and non-owners put it
            for z in range(pz):
                if trans:
                    for r in range(pr):
                        s_lists[z * lay + r * pc + c_own][l].append(
                            (int(pos_of_row[I]), z_own * pr + r_own,
                             1 if (z, r) != (z_own, r_own) else 0))
                else:
                    for c in range(pc):
                        s_lists[z * lay + r_own * pc + c][l].append(
                            (int(pos_of_row[I]), z_own * pc + c_own,
                             1 if (z, c) != (z_own, c_own) else 0))
            d_own = z_own * lay + r_own * pc + c_own
            d_lists[d_own][l].append(
                (int(I), int(pos_of_row[I]), int(dinv_idx[I])))
            rcv_part[d_own, l] += pz * (pr if trans else pc) - 1
            for d in range(ndev):
                if d != d_own:
                    rcv_x[d, l] += 1

    def pack(lists, nfields, fills):
        ptr_ = np.zeros((ndev, nlvl + 1), dtype=np.int64)
        for d in range(ndev):
            for l in range(nlvl):
                ptr_[d, l + 1] = ptr_[d, l] + len(lists[d][l])
        maxlen = max(1, int(ptr_[:, -1].max()))
        out = [np.full((ndev, maxlen), fills[f], dtype=np.int32)
               for f in range(nfields)]
        for d in range(ndev):
            p0 = 0
            for l in range(nlvl):
                for item in lists[d][l]:
                    for f in range(nfields):
                        out[f][d, p0] = item[f]
                    p0 += 1
        return (ptr_.reshape(*lead, nlvl + 1).astype(np.int32),
                [o.reshape(*lead, maxlen) for o in out])

    gp, (gloc, gsrc, gdpos) = pack(g_lists, 3, [_ZERO, nb, maxr])
    sp_, (spos, sdstc, ssend) = pack(s_lists, 3, [maxr, 0, 0])
    dp, (drow, dpos_a, dinv) = pack(d_lists, 3, [nb, maxr, 0])

    tapes = dict(gp=gp, gloc=gloc, gsrc=gsrc, gdpos=gdpos,
                 sp=sp_, spos=spos, sdstc=sdstc, ssend=ssend,
                 dp=dp, drow=drow, dpos=dpos_a, dinv=dinv,
                 rcv_part=rcv_part.reshape(*lead, nlvl).astype(np.int32),
                 rcv_x=rcv_x.reshape(*lead, nlvl).astype(np.int32))
    return tapes, dict(nlvl=nlvl, maxr=maxr)


# ---------------------------------------------------------------------------
# the kernels' own job lists: per level the jobs of every rank, rank-major
# ---------------------------------------------------------------------------


def _dev(a, device):
    return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32),
                           device=device)


def _jobs(ndev, nlvl, lists, nfields):
    """Flatten per-(rank, level) job lists into level-major, rank-major
    arrays; returns (ptr (nlvl, ndev+1) int64, [field arrays], rank)."""
    ptr_ = np.zeros((nlvl, ndev + 1), dtype=np.int64)
    cols = [[] for _ in range(nfields)]
    rank = []
    n = 0
    for l in range(nlvl):
        for d in range(ndev):
            ptr_[l, d] = n
            for item in lists[d][l]:
                for f in range(nfields):
                    cols[f].append(item[f])
                rank.append(d)
                n += 1
        ptr_[l, ndev] = n
    return (ptr_, [np.asarray(c, dtype=np.int64) for c in cols],
            np.asarray(rank, dtype=np.int64))


@dataclasses.dataclass
class FactorTapes:
    """The RDMA factor's jobs, unpadded. Level l's jobs of rank d are
    ``[xptr[l, d], xptr[l, d + 1])`` of phase x's lists (A: ``a_*``,
    B: ``b_*``, C: the targets ``s_*`` with their products ``c_l``/``c_u``
    over ``cptr``); ``dev`` holds int32 device copies of every list,
    ``host`` the numpy ones; ``recv`` the TPU's receive tapes."""

    pr: int
    pc: int
    nlvl: int
    bs: int
    n_local: int
    dlen: int
    max_dlvl: int
    max_lbuf: int
    max_ubuf: int
    aptr: np.ndarray
    bptr: np.ndarray
    sptr: np.ndarray
    host: dict
    dev: dict
    recv: dict
    #: layers of the Pr × Pc grid (the 3D grid's Pz; 1 in 2D)
    pz: int = 1

    @property
    def ndev(self) -> int:
        return self.pz * self.pr * self.pc


def build_factor_tapes(plan: SymbolicPlan, dplan: DistPlan2D,
                       device) -> FactorTapes:
    """The job lists of :func:`rdma_factor` from the partition: phase A
    (rank, local slot, level position, inverse row), phase B (rank, local
    slot, buffer position, position of the step, side 0 = L / 1 = U), and
    phase C's products grouped by target (stable: tape order within a
    target)."""
    return factor_tapes(dplan, dplan.dpos, dplan.gtloc, dplan.nlvl, device,
                        build_rdma_recv_tapes(plan, dplan))


def factor_tapes(dplan, dpos, gtloc, nlvl: int, device, recv,
                 pz: int = 1) -> FactorTapes:
    """The job lists of :func:`build_factor_tapes` from a partition's
    per-rank tapes over ``pz`` layers (``dplan``'s ``dptr``, ``dloc``,
    ``lptr`` ... ``gupos``, stacked over the ranks), with the steps'
    positions in their level ``dpos`` and the Schur targets' local slots
    ``gtloc`` given apart."""
    pr, pc = dplan.pr, dplan.pc
    ndev = pz * pr * pc

    def flat(a):
        return np.asarray(a).reshape(ndev, -1).astype(np.int64)

    dptr, lptr, uptr, gptr = (flat(getattr(dplan, n)) for n in
                              ("dptr", "lptr", "uptr", "gptr"))
    dloc, dpos = flat(dplan.dloc), flat(dpos)
    lloc, lpos, lpil = flat(dplan.lloc), flat(dplan.lpos), flat(dplan.lpil)
    uloc, upos, upil = flat(dplan.uloc), flat(dplan.upos), flat(dplan.upil)
    glpos, gupos, gtloc = (flat(dplan.glpos), flat(dplan.gupos),
                           flat(gtloc))
    a_l = [[[] for _ in range(nlvl)] for _ in range(ndev)]
    b_l = [[[] for _ in range(nlvl)] for _ in range(ndev)]
    s_l = [[[] for _ in range(nlvl)] for _ in range(ndev)]
    prods = [[None] * nlvl for _ in range(ndev)]
    for d in range(ndev):
        for l in range(nlvl):
            a_l[d][l] = [(int(dloc[d, t]), int(dpos[d, t]), t)
                         for t in range(dptr[d, l], dptr[d, l + 1])]
            b_l[d][l] = [(int(lloc[d, t]), int(lpos[d, t]), int(lpil[d, t]),
                          0) for t in range(lptr[d, l], lptr[d, l + 1])] + \
                [(int(uloc[d, t]), int(upos[d, t]), int(upil[d, t]), 1)
                 for t in range(uptr[d, l], uptr[d, l + 1])]
            g = slice(gptr[d, l], gptr[d, l + 1])
            tl = gtloc[d, g]
            o = np.argsort(tl, kind="stable")
            tgts, cnt = np.unique(tl[o], return_counts=True)
            s_l[d][l] = [(int(t), int(c)) for t, c in zip(tgts, cnt)]
            prods[d][l] = (glpos[d, g][o], gupos[d, g][o])
    aptr, (a_loc, a_pos, a_inv), a_rank = _jobs(ndev, nlvl, a_l, 3)
    bptr, (b_loc, b_pos, b_pil, b_side), b_rank = _jobs(ndev, nlvl, b_l, 4)
    sptr, (s_tloc, s_cnt), s_rank = _jobs(ndev, nlvl, s_l, 2)
    cl = [prods[d][l][0] for l in range(nlvl) for d in range(ndev)]
    cu = [prods[d][l][1] for l in range(nlvl) for d in range(ndev)]
    host = dict(a_rank=a_rank, a_loc=a_loc, a_pos=a_pos, a_inv=a_inv,
                b_rank=b_rank, b_loc=b_loc, b_pos=b_pos, b_pil=b_pil,
                b_side=b_side, s_rank=s_rank, s_tloc=s_tloc,
                cptr=np.r_[0, np.cumsum(s_cnt)].astype(np.int64),
                c_l=np.concatenate(cl).astype(np.int64) if cl else
                np.zeros(0, np.int64),
                c_u=np.concatenate(cu).astype(np.int64) if cu else
                np.zeros(0, np.int64))
    return FactorTapes(
        pr=pr, pc=pc, nlvl=nlvl, bs=dplan.bs, n_local=dplan.n_local,
        dlen=int(np.asarray(dplan.dstep).shape[-1]), max_dlvl=dplan.max_dlvl,
        max_lbuf=dplan.max_lbuf, max_ubuf=dplan.max_ubuf, aptr=aptr,
        bptr=bptr, sptr=sptr, host=host,
        dev={k: _dev(v, device) for k, v in host.items()}, recv=recv,
        pz=pz)


@dataclasses.dataclass
class SweepTapes:
    """One RDMA sweep's jobs, unpadded. Level l's partial jobs of rank d
    are ``[pptr[l, d], pptr[l, d + 1])`` of ``p_*`` (position, send flag,
    the owner's index among the row's partials: z·Pc + its grid column, z
    its layer), with their products ``c_loc``/``c_src`` over
    ``cptr``; its diagonal jobs ``[dptr[l, d], dptr[l, d + 1])`` of ``d_*``
    (block row, position, inverse row). Each partial job's chain is cut
    into chunks in tape order (``sweep.chunk_chains``): job j's chunks are
    ``chunkptr[j]:chunkptr[j+1]``, chunk q's products ``q_cptr[q]:
    q_cptr[q+1]``, on rank ``q_rank[q]`` at row ``q_row[q]`` of its chunk
    scratch (a job's chunks take consecutive rows); level l's chunks are
    ``qptr[l]:qptr[l+1]`` and ``maxq`` rows hold any level's chunks of
    one rank. ``recv`` holds the receive counts ``rcv_part`` and
    ``rcv_x`` (the TPU's tapes for "L" and "U"). In a transposed sweep
    (``which`` "UT" or "LT", ``transpose`` true) ``p_dstc`` is z·Pr + the
    owner's grid row and a row's ``npeer`` = Pz·Pr partials gather down
    the grid column of every layer; otherwise z·Pc + its grid column and
    Pz·Pc partials gather along the grid row of every layer."""

    which: str
    pr: int
    pc: int
    nlvl: int
    maxr: int
    pptr: np.ndarray
    dptr: np.ndarray
    qptr: np.ndarray
    maxq: int
    host: dict
    dev: dict
    recv: dict
    #: layers of the Pr × Pc grid (the 3D grid's Pz; 1 in 2D)
    pz: int = 1

    @property
    def ndev(self) -> int:
        return self.pz * self.pr * self.pc

    @property
    def transpose(self) -> bool:
        return self.which.endswith("T")

    @property
    def npeer(self) -> int:
        """The ranks that hold partials of one row: Pz·Pc, or Pz·Pr when
        transposed."""
        return self.pz * (self.pr if self.transpose else self.pc)


def build_sweep_tapes(plan: SymbolicPlan, dplan: DistPlan2D, which: str,
                      device, chunk: int | None = None) -> SweepTapes:
    """The job lists of one sweep of :func:`rdma_solve` ("L", "U", or
    the transposed "UT", "LT") from :func:`build_rdma_solve_tapes`: one
    partial job per entry of a rank's
    zero/send list, holding that rank's products into the position in
    tape order, cut into chunks of at most ``chunk`` products (when None,
    the level's products over ``sweep.CHUNK_CTAS``); one diagonal job per
    solved row on its owner."""
    t, c = build_rdma_solve_tapes(plan, dplan, which)
    return sweep_tapes(t, c, which, 1, dplan.pr, dplan.pc, device, chunk)


def sweep_tapes(t, c, which: str, pz: int, pr: int, pc: int, device,
                chunk: int | None = None) -> SweepTapes:
    """The job lists of :func:`build_sweep_tapes` from the tapes ``t``
    and constants ``c`` of :func:`solve_tapes` on ``pz`` layers."""
    ndev, nlvl = pz * pr * pc, c["nlvl"]

    def flat(a):
        return np.asarray(a).reshape(ndev, -1).astype(np.int64)

    gp, sp_, dp = flat(t["gp"]), flat(t["sp"]), flat(t["dp"])
    gloc, gsrc, gdpos = flat(t["gloc"]), flat(t["gsrc"]), flat(t["gdpos"])
    spos, sdstc, ssend = flat(t["spos"]), flat(t["sdstc"]), flat(t["ssend"])
    drow, dpos, dinv = flat(t["drow"]), flat(t["dpos"]), flat(t["dinv"])
    p_l = [[[] for _ in range(nlvl)] for _ in range(ndev)]
    d_l = [[[] for _ in range(nlvl)] for _ in range(ndev)]
    cl, cs = [], []
    for l in range(nlvl):
        for d in range(ndev):
            g = slice(gp[d, l], gp[d, l + 1])
            gpos = gdpos[d, g]
            o = np.argsort(gpos, kind="stable")
            gpos = gpos[o]
            s = slice(sp_[d, l], sp_[d, l + 1])
            if not np.isin(gpos, spos[d, s]).all():
                raise AssertionError("a partial product without its "
                                     "position on the rank")
            for p, dc, snd in zip(spos[d, s], sdstc[d, s], ssend[d, s]):
                lo, hi = np.searchsorted(gpos, [p, p + 1])
                cl.append(gloc[d, g][o][lo:hi])
                cs.append(gsrc[d, g][o][lo:hi])
                p_l[d][l].append((int(p), int(snd), int(dc), hi - lo))
            d_l[d][l] = [(int(drow[d, i]), int(dpos[d, i]), int(dinv[d, i]))
                         for i in range(dp[d, l], dp[d, l + 1])]
    pptr, (p_pos, p_send, p_dstc, p_cnt), p_rank = _jobs(ndev, nlvl, p_l, 4)
    dptr_, (d_row, d_pos, d_inv), d_rank = _jobs(ndev, nlvl, d_l, 3)
    cptr = np.r_[0, np.cumsum(p_cnt)].astype(np.int64)
    chunkptr, q_cptr, qptr = chunk_chains(
        cptr, np.r_[pptr[:, 0], pptr[-1, -1]], chunk)
    q_job = np.repeat(np.arange(len(p_rank)), np.diff(chunkptr))
    # a chunk's row in its rank's scratch: its place among the chunks of
    # its (level, rank), which are consecutive
    key = np.searchsorted(qptr, np.arange(len(q_job)), side="right") \
        * ndev + p_rank[q_job]
    q_row = np.arange(len(q_job)) - np.searchsorted(key, key)
    host = dict(p_rank=p_rank, p_pos=p_pos, p_send=p_send, p_dstc=p_dstc,
                cptr=cptr, chunkptr=chunkptr, q_cptr=q_cptr,
                q_rank=p_rank[q_job], q_row=q_row,
                c_loc=np.concatenate(cl).astype(np.int64) if cl else
                np.zeros(0, np.int64),
                c_src=np.concatenate(cs).astype(np.int64) if cs else
                np.zeros(0, np.int64),
                d_rank=d_rank, d_row=d_row, d_pos=d_pos, d_inv=d_inv)
    return SweepTapes(which=which, pr=pr, pc=pc, nlvl=nlvl, maxr=c["maxr"],
                      pptr=pptr, dptr=dptr_, qptr=qptr,
                      maxq=int(q_row.max(initial=-1)) + 1, host=host,
                      dev={k: _dev(v, device) for k, v in host.items()},
                      recv={k: t[k] for k in SOLVE_RECV}, pz=pz)


# ---------------------------------------------------------------------------
# per-rank buffers and the device table of their pointers
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FactorState:
    """Every rank's buffers of the factor, one list per kind (index r·Pc +
    c): ``pool`` (n_local, bs, bs), ``linv``/``uinv`` (dlen+1, bs, bs) by
    d-tape position, the broadcast buffers ``lC``/``uC`` (max_dlvl, bs,
    bs) and ``lB`` (max_lbuf, ...), ``uB`` (max_ubuf, ...), the receive
    counters ``recv`` (nlvl, 4) int32 and ``tiny`` (1,) int32; ``tables``
    keeps the device tables of their pointers, ``win`` the window that
    holds them."""

    pool: list
    linv: list
    uinv: list
    lC: list
    uC: list
    lB: list
    uB: list
    recv: list
    tiny: list
    tables: dict = dataclasses.field(default_factory=dict, repr=False)
    win: Window = dataclasses.field(default=None, repr=False)

    KINDS = ("pool", "linv", "uinv", "lC", "uC", "lB", "uB", "recv", "tiny")

    def __post_init__(self):
        # buffers given without their window are one process's
        if self.win is None:
            self.win = Window(len(self.pool), self.pool[0].device)

    def tensors(self) -> list:
        return [t for k in self.KINDS for t in getattr(self, k)]

    @classmethod
    def of(cls, tensors, ndev: int) -> "FactorState":
        """The inverse of :meth:`tensors`."""
        return cls(*(list(tensors[i * ndev:(i + 1) * ndev])
                     for i in range(len(cls.KINDS))))

    def table(self) -> torch.Tensor:
        """The device table of these buffers' pointers (kinds in the
        order of ``KINDS``, rank-major within a kind), made and checked
        once per set of buffers."""
        return _table(self.tables, [getattr(self, k) for k in self.KINDS],
                      lambda: _check_cuda(
                          "rdma_factor", [t for k in self.KINDS[:7]
                                          for t in getattr(self, k)],
                          self.recv + self.tiny))


def new_factor_state(pools, ft: FactorTapes, win: Window = None
                     ) -> FactorState:
    """Zeroed buffers beside the given per-rank pools (the inverse tables
    are zero where no step writes: the solve reads them as the JAX
    package's do), allocated in ``win``, whose tensors the pools must be
    when the ranks are split over processes (a window of its own under
    one process)."""
    bs, dev, dt = ft.bs, pools[0].device, pools[0].dtype
    win = win or Window(ft.ndev, dev)

    def z(rows, shape=None, dtype=dt):
        return win.alloc(shape or (rows, bs, bs), dtype)

    return FactorState(pool=list(pools), linv=z(ft.dlen + 1),
                       uinv=z(ft.dlen + 1), lC=z(ft.max_dlvl),
                       uC=z(ft.max_dlvl), lB=z(ft.max_lbuf),
                       uB=z(ft.max_ubuf),
                       recv=z(0, (ft.nlvl, 4), torch.int32),
                       tiny=z(0, (1,), torch.int32), win=win)


@dataclasses.dataclass
class SweepState:
    """Every rank's buffers of one sweep: the replicated ``X`` (nb, bs,
    nrhs), the partials ``P`` (maxr, bs, nrhs), the receive ``slots``
    (maxr·npeer, bs, nrhs), the counters ``recv`` (nlvl, 2) int32 and the
    chunk scratch ``C`` (max(1, maxq), bs, nrhs); ``tables`` keeps the
    device tables of their pointers, ``win`` the window that holds
    them."""

    X: list
    P: list
    slots: list
    recv: list
    C: list
    tables: dict = dataclasses.field(default_factory=dict, repr=False)
    win: Window = dataclasses.field(default=None, repr=False)

    KINDS = ("X", "P", "slots", "recv", "C")

    def __post_init__(self):
        # buffers given without their window are one process's
        if self.win is None:
            self.win = Window(len(self.X), self.X[0].device)

    def tensors(self) -> list:
        return [t for k in self.KINDS for t in getattr(self, k)]

    @classmethod
    def of(cls, tensors, ndev: int) -> "SweepState":
        """The inverse of :meth:`tensors`."""
        return cls(*(list(tensors[i * ndev:(i + 1) * ndev])
                     for i in range(len(cls.KINDS))))

    def table(self, blocks) -> torch.Tensor:
        """The device table of the sweep's pointers, with ``blocks`` (the
        per-rank pools, or the inverse tables) in the first two kinds,
        made and checked once per set of buffers."""
        return _table(self.tables, [blocks, blocks, self.X, self.P,
                                    self.slots, self.recv, self.C],
                      lambda: _check_cuda(
                          "rdma_solve", list(blocks) + self.X + self.P
                          + self.slots + self.C, self.recv))


def new_sweep_state(X, tp: SweepTapes, win: Window = None) -> SweepState:
    """Zeroed buffers of one sweep beside the per-rank ``X``, allocated in
    ``win`` (whose tensors X must be when the ranks are split over
    processes)."""
    _, bs, k = X[0].shape
    dev, dt = X[0].device, X[0].dtype
    win = win or Window(tp.ndev, dev)
    return SweepState(
        X=list(X), P=win.alloc((tp.maxr, bs, k), dt),
        slots=win.alloc((tp.maxr * tp.npeer, bs, k), dt),
        recv=win.alloc((tp.nlvl, 2), torch.int32),
        C=win.alloc((max(1, tp.maxq), bs, k), dt), win=win)


def _table(cache: dict, lists, check) -> torch.Tensor:
    """The device table of buffer pointers, ``tab[kind * ndev + rank]``,
    made once per set of pointers and kept in ``cache``; ``check`` raises
    on buffers the kernels do not take, before the first table of a set
    is made."""
    key = tuple(t.data_ptr() for ts in lists for t in ts)
    tab = cache.get(key)
    if tab is None:
        check()
        tab = cache[key] = torch.tensor(key, dtype=torch.int64,
                                        device=lists[0][0].device)
    return tab


def _at(t: torch.Tensor, i: int) -> ctypes.c_void_p:
    """Pointer to element ``i`` of a contiguous int32 job list."""
    return ctypes.c_void_p(t.data_ptr() + 4 * i)


def _check_cuda(what, blocks, others=()):
    """Every block buffer contiguous, on one CUDA device and of one dtype
    that the kernels take (counters int32); a block size the kernels
    take."""
    dev, dt = blocks[0].device, blocks[0].dtype
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    for t in blocks:
        if t.dtype not in CUDA_DTYPES or t.dtype != dt \
                or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{what}: every buffer must be a contiguous "
                             f"tensor of one dtype ({DTYPE_NAMES}) on one "
                             "device")
    for t in others:
        if t.dtype != torch.int32 or not t.is_contiguous() \
                or t.device != dev:
            raise ValueError(f"{what}: counters must be contiguous int32 "
                             "tensors on the device")
    bs = blocks[0].shape[1]
    if bs not in CUDA_BLOCK_SIZES:
        raise ValueError(f"{what}: block size {bs} not in "
                         f"{CUDA_BLOCK_SIZES}")


def _place(d: int, pr: int, pc: int):
    """Rank ``d``'s layer's first rank, its grid row and its grid
    column."""
    base = d - d % (pr * pc)
    myr, myc = divmod(d - base, pc)
    return base, myr, myc


def _span(ptr_, level, win: Window):
    """Level ``level``'s jobs of this process's ranks in a job list with
    pointers ``ptr_`` (nlvl, ndev + 1)."""
    return int(ptr_[level, win.lo]), int(ptr_[level, win.hi])


def _idx(a, device):
    return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)


# ---------------------------------------------------------------------------
# kernel 11: the factor
# ---------------------------------------------------------------------------


def rdma_diag_plain(st: FactorState, thresh: float, ft: FactorTapes,
                    level: int) -> None:
    """Plain version of :func:`rdma_diag` (a complex tiny pivot keeps its
    phase; ``thresh`` is real)."""
    h, pc, pr, dev = ft.host, ft.pc, ft.pr, st.win.device
    for d in st.win.turns():
        lo, hi = int(ft.aptr[level, d]), int(ft.aptr[level, d + 1])
        if hi == lo:
            continue
        loc, pos, inv = (_idx(h[k][lo:hi], dev) for k in
                         ("a_loc", "a_pos", "a_inv"))
        LU, li, ui, nt = lu_inv_plain(st.pool[d][loc], thresh)
        st.pool[d][loc] = LU
        st.linv[d][inv] = li
        st.uinv[d][inv] = ui
        st.tiny[d] += nt.to(torch.int32)
        base, myr, myc = _place(d, pr, pc)
        for c in range(pc):            # linv along the grid row
            st.lC[base + myr * pc + c][pos] = li
            if c != myc:
                st.recv[base + myr * pc + c][level, _LI] += hi - lo
        for r in range(pr):            # uinv down the grid column
            st.uC[base + r * pc + myc][pos] = ui
            if r != myr:
                st.recv[base + r * pc + myc][level, _UI] += hi - lo


def rdma_diag(st: FactorState, thresh: float, ft: FactorTapes,
              level: int) -> None:
    """Phase A of ``level``: tile LU and inverses of every rank's owned
    diagonal steps, the inverses put into the peers' ``lC``/``uC``."""
    if st.win.device.type == "cpu":
        return rdma_diag_plain(st, thresh, ft, level)
    tab = st.table()
    lo, hi = _span(ft.aptr, level, st.win)
    if hi > lo:
        dv, fn = ft.dev, entry("rdma_diag", st.pool[0])
        RDMA_FACTOR.count(fn)
        RDMA_FACTOR.call(
            fn, ptr(tab), ft.ndev, ft.pr, ft.pc, _at(dv["a_rank"], lo),
            _at(dv["a_loc"], lo), _at(dv["a_pos"], lo), _at(dv["a_inv"], lo),
            hi - lo, ft.bs, float(thresh), level, stream_ptr(st.win.device))
    st.win.fence()


def rdma_panel_plain(st: FactorState, ft: FactorTapes, level: int) -> None:
    """Plain version of :func:`rdma_panel`."""
    h, pc, pr, dev = ft.host, ft.pc, ft.pr, st.win.device
    for d in st.win.turns():
        lo, hi = int(ft.bptr[level, d]), int(ft.bptr[level, d + 1])
        base, myr, myc = _place(d, pr, pc)
        side = h["b_side"][lo:hi]
        for s, inv, buf, peers, kind in (
                (0, st.uC[d], st.lB,
                 [base + myr * pc + c for c in range(pc)], _L),
                (1, st.lC[d], st.uB,
                 [base + r * pc + myc for r in range(pr)], _U)):
            sel = np.flatnonzero(side == s) + lo
            if not len(sel):
                continue
            loc, pos, pil = (_idx(h[k][sel], dev) for k in
                             ("b_loc", "b_pos", "b_pil"))
            Y = st.pool[d][loc] @ inv[pil] if s == 0 else \
                inv[pil] @ st.pool[d][loc]
            st.pool[d][loc] = Y
            for e in peers:
                buf[e][pos] = Y
                if e != d:
                    st.recv[e][level, kind] += len(sel)


def rdma_panel(st: FactorState, ft: FactorTapes, level: int,
               wide: int = -1) -> None:
    """Phase B of ``level``: every rank's owned L panels times the
    received U⁻¹ (put into the row peers' ``lB``) and U panels times the
    received L⁻¹ (put into the column peers' ``uB``), one CTA per
    (panel, band). ``wide`` < 0 lets the kernel choose its bands
    (``csrc/chain.cuh``), 0 / 1 force bands of 16 / 64 (complex128
    always takes bands of 16)."""
    if st.win.device.type == "cpu":
        return rdma_panel_plain(st, ft, level)
    tab = st.table()
    lo, hi = _span(ft.bptr, level, st.win)
    if hi > lo:
        dv, fn = ft.dev, entry("rdma_panel", st.pool[0])
        RDMA_FACTOR.count(fn)
        RDMA_FACTOR.call(
            fn, ptr(tab), ft.ndev, ft.pr, ft.pc, _at(dv["b_rank"], lo),
            _at(dv["b_loc"], lo), _at(dv["b_pos"], lo), _at(dv["b_pil"], lo),
            _at(dv["b_side"], lo), hi - lo, ft.bs, level, wide,
            stream_ptr(st.win.device))
    st.win.fence()


#: Schur products per gathered batch in :func:`rdma_schur_plain`
SCHUR_CHUNK = 256


def rdma_schur_plain(st: FactorState, ft: FactorTapes, level: int) -> None:
    """Plain version of :func:`rdma_schur`."""
    h, dev = ft.host, st.win.device
    for d in st.win.turns():
        lo, hi = int(ft.sptr[level, d]), int(ft.sptr[level, d + 1])
        c0, c1 = int(h["cptr"][lo]), int(h["cptr"][hi])
        dst = np.repeat(h["s_tloc"][lo:hi], np.diff(h["cptr"][lo:hi + 1]))
        for c in range(c0, c1, SCHUR_CHUNK):
            e = min(c + SCHUR_CHUNK, c1)
            st.pool[d].index_add_(
                0, _idx(dst[c - c0:e - c0], dev),
                st.lB[d][_idx(h["c_l"][c:e], dev)]
                @ st.uB[d][_idx(h["c_u"][c:e], dev)], alpha=-1)


def rdma_schur(st: FactorState, ft: FactorTapes, level: int,
               wide: int = -1) -> None:
    """Phase C of ``level``: T −= Σ lB[lpos]·uB[upos] into every rank's
    owned targets, one CTA per (target, band); ``wide`` as in
    :func:`rdma_panel`."""
    if st.win.device.type == "cpu":
        return rdma_schur_plain(st, ft, level)
    tab = st.table()
    lo, hi = _span(ft.sptr, level, st.win)
    if hi == lo:
        return
    dv, fn = ft.dev, entry("rdma_schur", st.pool[0])
    RDMA_FACTOR.count(fn)
    RDMA_FACTOR.call(
        fn, ptr(tab), ft.ndev, _at(dv["s_rank"], lo),
        _at(dv["s_tloc"], lo), _at(dv["cptr"], lo), ptr(dv["c_l"]),
        ptr(dv["c_u"]), hi - lo, ft.bs, wide, stream_ptr(st.win.device))


def rdma_factor_level(st: FactorState, thresh: float, ft: FactorTapes,
                      level: int, plain: bool = False) -> None:
    """The three phases of one elimination level."""
    if plain:
        rdma_diag_plain(st, thresh, ft, level)
        rdma_panel_plain(st, ft, level)
        rdma_schur_plain(st, ft, level)
    else:
        rdma_diag(st, thresh, ft, level)
        rdma_panel(st, ft, level)
        rdma_schur(st, ft, level)


def rdma_factor(pools, thresh: float, ft: FactorTapes,
                plain: bool = False, win: Window = None) -> FactorState:
    """Factor the per-rank ``pools`` in place, the three phases level by
    level; returns the factor's buffers (the pools, the owner-local
    inverse tables, the receive counters and the tiny-pivot counts). With
    the ranks split over processes the pools are tensors of ``win``, and
    the factor ends with a fence, after which every rank's buffers are
    final."""
    st = new_factor_state(pools, ft, win)
    for level in range(ft.nlvl):
        rdma_factor_level(st, thresh, ft, level, plain)
    st.win.fence()
    return st


def rdma_factor_plain(pools, thresh: float, ft: FactorTapes) -> FactorState:
    """Plain version of :func:`rdma_factor` on any device."""
    return rdma_factor(pools, thresh, ft, plain=True)


# ---------------------------------------------------------------------------
# kernel 12: the sweeps
# ---------------------------------------------------------------------------


def _op(M: torch.Tensor, tp: SweepTapes) -> torch.Tensor:
    """op(M) of the sweep: the blocks ``M``, transposed (never
    conjugated) in a transposed sweep."""
    return M.mT if tp.transpose else M


def rdma_solve_chunks_plain(pools, ss: SweepState, tp: SweepTapes,
                            level: int) -> None:
    """Plain version of :func:`rdma_solve_chunks`: each chunk's products
    summed in tape order into its scratch row."""
    h, dev = tp.host, ss.win.device
    q0, q1 = int(tp.qptr[level]), int(tp.qptr[level + 1])
    for d in ss.win.turns():
        qs = q0 + np.flatnonzero(h["q_rank"][q0:q1] == d)
        if not len(qs):
            continue
        cnt = h["q_cptr"][qs + 1] - h["q_cptr"][qs]
        prods = np.concatenate([np.arange(h["q_cptr"][q], h["q_cptr"][q + 1])
                                for q in qs])
        rows = _idx(h["q_row"][qs], dev)
        ss.C[d][rows] = 0
        ss.C[d].index_add_(
            0, _idx(np.repeat(h["q_row"][qs], cnt), dev),
            _op(pools[d][_idx(h["c_loc"][prods], dev)], tp)
            @ ss.X[d][_idx(h["c_src"][prods], dev)])


def rdma_solve_chunks(pools, ss: SweepState, tp: SweepTapes,
                      level: int) -> None:
    """Pass 1 of ``level``: every chunk of every rank's chains summed into
    the rank's chunk scratch, one CTA per (chunk, tile of right-hand
    sides); each product op(pool block)·X[src]."""
    if ss.win.device.type == "cpu":
        return rdma_solve_chunks_plain(pools, ss, tp, level)
    tab = ss.table(pools)
    q0, q1 = (int(tp.host["chunkptr"][j])
              for j in _span(tp.pptr, level, ss.win))
    if q1 == q0:
        return
    dv, fn = tp.dev, entry("rdma_solve_chunks", ss.X[0])
    RDMA_SOLVE.count(fn)
    RDMA_SOLVE.call(
        fn, ptr(tab), tp.ndev, _at(dv["q_rank"], q0),
        _at(dv["q_row"], q0), _at(dv["q_cptr"], q0), ptr(dv["c_loc"]),
        ptr(dv["c_src"]), q1 - q0, ss.X[0].shape[1], ss.X[0].shape[2],
        int(tp.transpose), stream_ptr(ss.X[0].device))


def _owner_slot(tp: SweepTapes, d: int, own):
    """For rank ``d``'s partials whose owner has index ``own`` among a
    row's ``npeer`` partial slots (z·Pc + its grid column, or z·Pr + its
    grid row in a transposed sweep): the owners' ranks, and the index of
    ``d`` among those slots."""
    pr, pc = tp.pr, tp.pc
    base, myr, myc = _place(d, pr, pc)
    z = base // (pr * pc)
    if tp.transpose:
        return (own // pr) * pr * pc + (own % pr) * pc + myc, z * pr + myr
    return (own // pc) * pr * pc + myr * pc + own % pc, z * pc + myc


def rdma_solve_sum_plain(pools, ss: SweepState, tp: SweepTapes,
                         level: int) -> None:
    """Plain version of :func:`rdma_solve_sum`."""
    h, dev, npeer = tp.host, ss.win.device, tp.npeer
    for d in ss.win.turns():
        lo, hi = int(tp.pptr[level, d]), int(tp.pptr[level, d + 1])
        if hi == lo:
            continue
        pos = h["p_pos"][lo:hi]
        ss.P[d][_idx(pos, dev)] = 0
        k0, k1 = int(h["chunkptr"][lo]), int(h["chunkptr"][hi])
        if k1 > k0:
            dst = np.repeat(pos, np.diff(h["chunkptr"][lo:hi + 1]))
            ss.P[d].index_add_(0, _idx(dst, dev),
                               ss.C[d][_idx(h["q_row"][k0:k1], dev)],
                               alpha=-1)
        send = h["p_send"][lo:hi] == 1
        owner, me = _owner_slot(tp, d, h["p_dstc"][lo:hi])
        for e in np.unique(owner[send]):
            p = pos[send & (owner == e)]
            ss.slots[e][_idx(p * npeer + me, dev)] = ss.P[d][_idx(p, dev)]
            ss.recv[e][level, _PART] += len(p)


def rdma_solve_sum(pools, ss: SweepState, tp: SweepTapes,
                   level: int) -> None:
    """Pass 2 of ``level``: every rank's P[pos] = −(its chunks' sums, in
    chunk order) for each row position it holds products into, put by
    non-owners into the diagonal owner's slots[pos·npeer + own index]
    (its grid column, or its grid row in a transposed sweep)."""
    if ss.win.device.type == "cpu":
        return rdma_solve_sum_plain(pools, ss, tp, level)
    tab = ss.table(pools)
    lo, hi = _span(tp.pptr, level, ss.win)
    if hi > lo:
        dv, fn = tp.dev, entry("rdma_solve_sum", ss.X[0])
        RDMA_SOLVE.count(fn)
        RDMA_SOLVE.call(
            fn, ptr(tab), tp.ndev, tp.pr, tp.pc,
            _at(dv["p_rank"], lo), _at(dv["p_pos"], lo),
            _at(dv["p_send"], lo), _at(dv["p_dstc"], lo),
            _at(dv["chunkptr"], lo), ptr(dv["q_row"]), hi - lo,
            ss.X[0].shape[1], ss.X[0].shape[2], level, int(tp.transpose),
            stream_ptr(ss.win.device))
    ss.win.fence()


def rdma_solve_gemm_plain(pools, ss: SweepState, tp: SweepTapes,
                          level: int) -> None:
    """Plain version of :func:`rdma_solve_gemm`."""
    rdma_solve_chunks_plain(pools, ss, tp, level)
    rdma_solve_sum_plain(pools, ss, tp, level)


def rdma_solve_gemm(pools, ss: SweepState, tp: SweepTapes,
                    level: int) -> None:
    """Level ``level``'s partials: every rank's P[pos] = −Σ op(pool[loc])·
    X[src] over its products into the row at pos (passes 1 and 2), put
    by non-owners into the diagonal owner's slots."""
    rdma_solve_chunks(pools, ss, tp, level)
    rdma_solve_sum(pools, ss, tp, level)


def rdma_solve_diag_plain(dinvs, ss: SweepState, tp: SweepTapes,
                          level: int) -> None:
    """Plain version of :func:`rdma_solve_diag`."""
    h, dev, npeer = tp.host, ss.win.device, tp.npeer
    for d in ss.win.turns():
        lo, hi = int(tp.dptr[level, d]), int(tp.dptr[level, d + 1])
        if hi == lo:
            continue
        rows, pos, inv = (_idx(h[k][lo:hi], dev) for k in
                          ("d_row", "d_pos", "d_inv"))
        t = ss.X[d][rows] + ss.P[d][pos]
        me = _owner_slot(tp, d, 0)[1]
        for q in range(npeer):         # the peers' partials, (z, c) order
            if q != me:
                t = t + ss.slots[d][pos * npeer + q]
        x = _op(dinvs[d][inv], tp) @ t
        for e in range(tp.ndev):       # x into every rank's X
            ss.X[e][rows] = x
            if e != d:
                ss.recv[e][level, _X] += hi - lo


def rdma_solve_diag(dinvs, ss: SweepState, tp: SweepTapes,
                    level: int) -> None:
    """Level ``level``'s solved rows: the owner's x_I = op(dinv)·(X[I] +
    P + the peers' slots in grid order), put into every rank's X[I]."""
    if ss.win.device.type == "cpu":
        return rdma_solve_diag_plain(dinvs, ss, tp, level)
    tab = ss.table(dinvs)
    lo, hi = _span(tp.dptr, level, ss.win)
    if hi > lo:
        dv, fn = tp.dev, entry("rdma_solve_diag", ss.X[0])
        RDMA_SOLVE.count(fn)
        RDMA_SOLVE.call(
            fn, ptr(tab), tp.ndev, tp.pr, tp.pc, _at(dv["d_rank"], lo),
            _at(dv["d_row"], lo), _at(dv["d_pos"], lo),
            _at(dv["d_inv"], lo), hi - lo, ss.X[0].shape[1],
            ss.X[0].shape[2], level, int(tp.transpose),
            stream_ptr(ss.win.device))
    ss.win.fence()


def rdma_sweep(pools, dinvs, X, tp: SweepTapes, plain: bool = False,
               win: Window = None):
    """One sweep over the per-rank replicated ``X`` (each (nb, bs, nrhs),
    updated in place; tensors of ``win`` when the ranks are split over
    processes); returns the sweep's state (X and the counters)."""
    ss = new_sweep_state(X, tp, win)
    gemm = rdma_solve_gemm_plain if plain else rdma_solve_gemm
    diag = rdma_solve_diag_plain if plain else rdma_solve_diag
    for level in range(tp.nlvl):
        gemm(pools, ss, tp, level)
        diag(dinvs, ss, tp, level)
    return ss


def rdma_solve(pools, linvs, uinvs, lt: SweepTapes, ut: SweepTapes, B,
               plain: bool = False, win: Window = None):
    """L·U·x = b for the (nb, bs, nrhs) right-hand side ``B``: every rank
    starts from a copy of B, then the L sweep and the U sweep; or, with
    the transposed tapes ("LT" and "UT"), Uᵀ·Lᵀ·x = b: the Uᵀ sweep with
    ``uinvs``, then the Lᵀ sweep with ``linvs``. Returns (x of shape (nb,
    bs, nrhs), the receive counters of the ``lt`` sweep and of the ``ut``
    sweep, one (nlvl, 2) tensor per rank each). The buffers of both
    sweeps are allocated in ``win`` (a window of their own when None),
    every process copies B into its own ranks' X, and a fence precedes the
    first level."""
    if lt.transpose != ut.transpose:
        raise ValueError("rdma_solve: the L and U tapes must both be "
                         "transposed or neither")
    win = win or Window(lt.ndev, B.device)
    X = win.alloc(B.shape, B.dtype)
    for d in win.ranks:
        X[d].copy_(B)
    win.fence()
    if lt.transpose:
        su = rdma_sweep(pools, uinvs, X, ut, plain, win)
        sl = rdma_sweep(pools, linvs, X, lt, plain, win)
    else:
        sl = rdma_sweep(pools, linvs, X, lt, plain, win)
        su = rdma_sweep(pools, uinvs, X, ut, plain, win)
    return X[win.lo], sl.recv, su.recv


def rdma_solve_plain(pools, linvs, uinvs, lt, ut, B):
    """Plain version of :func:`rdma_solve` on any device."""
    return rdma_solve(pools, linvs, uinvs, lt, ut, B, plain=True)


def stacked_recv(recv: list, pr: int, pc: int, names, pz: int = 1) -> dict:
    """Per-rank (nlvl, kinds) counters as the TPU tapes' (pr, pc, nlvl)
    arrays (on ``pz`` > 1 layers (pz, pr, pc, nlvl)), by kind name."""
    a = torch.stack([r.cpu() for r in recv]).numpy()
    lead = (pz, pr, pc) if pz > 1 else (pr, pc)
    return {n: a[:, :, i].reshape(*lead, -1) for i, n in enumerate(names)}
