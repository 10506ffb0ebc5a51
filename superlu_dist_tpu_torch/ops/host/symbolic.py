"""Block symbolic factorization → static device schedule ("the plan").

TPU-native replacement for the reference's symbolic machinery
(reference: SRC/prec-independent/symbfact.c:83-917 serial column-DFS symbolic,
SRC/double/dstatic_schedule.c static elimination schedule,
supernodal_etree.c topological levels). Rather than variable-width supernodes
+ dynamic message-driven scheduling, the TPU design quantizes the matrix into
fixed B×B blocks (B = MXU-aligned supernode width) and *compiles* the entire
numeric factorization into flat instruction tapes:

- per elimination step k: the diagonal slot, the L-column/U-row panel slots
  (batched TRSM via precomputed diagonal-block inverses → pure GEMMs), and
  the Schur-update triples (L-slot, U-slot, target-slot) — the analog of the
  look-ahead + dSchCompUdt GEMM/scatter phase (dSchCompUdt-2Ddynamic.c), with
  the scatter reduced to a single indexed add per B×B block;
- level-set schedules for the L- and U-triangular solves (the static analog
  of the fmod/bmod message-driven sweeps, pdgstrs_lsum.c).

Everything the device executes is a gather → batched-GEMM → scatter-add over
one flat (nslots, B, B) block pool, driven by these integer tapes inside a
single compiled ``lax.fori_loop``.

Block fill is computed by right-looking simulation on the block pattern —
exactly the pattern the numeric block GE produces, so numeric and symbolic
can never disagree.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

__all__ = ["SymbolicPlan", "block_symbolic", "block_symbolic_from_keys"]


@dataclasses.dataclass
class SymbolicPlan:
    """Static factorization + solve schedule for one sparsity pattern."""

    n: int                 # original dimension
    n_pad: int             # padded to nb * bs
    bs: int                # block size
    nb: int                # number of block rows/cols
    nslots: int            # number of stored B×B blocks (excl. zero/trash)
    zero_slot: int         # index of the all-zero padding block
    trash_slot: int        # scratch block absorbing masked-lane writes

    # --- value initialization: pool.flat[init_idx] += a_data ---
    init_idx: np.ndarray   # (nnz + n_pad - n,) flat indices into pool
    init_ones: int         # how many trailing entries are padding-diagonal 1s

    # --- factorization tape (per elimination step k = block column) ---
    diag_slot: np.ndarray  # (nb,)
    l_ptr: np.ndarray      # (nb+1,) → l_slots
    l_slots: np.ndarray    # L-panel blocks (I,k), I>k
    u_ptr: np.ndarray      # (nb+1,) → u_slots
    u_slots: np.ndarray    # U-panel blocks (k,J), J>k
    g_ptr: np.ndarray      # (nb+1,) → gemm triples
    g_l: np.ndarray        # slot of L(I,k)
    g_u: np.ndarray        # slot of U(k,J)
    g_t: np.ndarray        # slot of target (I,J)

    # --- L-solve level schedule ---
    lsol_nlvl: int
    lsol_gptr: np.ndarray  # (nlvl+1,) gemm range per level
    lsol_gslot: np.ndarray  # slot of L(I,J)
    lsol_gsrc: np.ndarray   # J (block row of x already computed)
    lsol_gdst: np.ndarray   # I (block row being accumulated)
    lsol_dptr: np.ndarray  # (nlvl+1,) diag range per level
    lsol_diag: np.ndarray   # block rows finalized at this level

    # --- U-solve level schedule ---
    usol_nlvl: int
    usol_gptr: np.ndarray
    usol_gslot: np.ndarray
    usol_gsrc: np.ndarray
    usol_gdst: np.ndarray
    usol_dptr: np.ndarray
    usol_diag: np.ndarray

    # --- elimination level schedule (supersteps of independent steps) ---
    # level[k] = 1 + max level over earlier steps adjacent to k in the filled
    # block pattern; steps at one level factor as one batch (the static
    # analog of look-ahead pipelining + the supernodal-etree topological
    # levels, reference: supernodal_etree.c:59, dstatic_schedule.c).
    step_level: np.ndarray    # (nb,)
    n_flevels: int

    # --- structure metadata ---
    slot_row: np.ndarray      # (nslots,) block-row I of each slot
    slot_col: np.ndarray      # (nslots,) block-col J of each slot
    slot_step: np.ndarray     # (nslots,) elimination step that owns the slot
    block_parent: np.ndarray  # (nb,) supernodal/block etree (3D forests, reuse)
    factor_flops: float       # useful flops (dense-block model)
    fill_blocks: int          # stored blocks incl. fill
    a_blocks: int             # blocks present in A

    @property
    def pool_shape(self):
        return (self.nslots + 2, self.bs, self.bs)

    def pool_bytes(self, dtype=np.float32) -> int:
        return int(np.prod(self.pool_shape)) * np.dtype(dtype).itemsize


def _renumber_column_major(plan: SymbolicPlan) -> SymbolicPlan:
    """Permute pool slot ids to column-major order: column k occupies a
    CONTIGUOUS slot range [U(i,k) ascending i, diag(k,k), L(i,k) ascending
    i]. Slots are abstract indices to every executor, so this is purely a
    relabeling — but it makes each block column a single range DMA for the
    column-resident kernels (the supernode-panel storage of the reference,
    pddistribute.c LUstruct, recast as pool layout)."""
    order = np.lexsort((plan.slot_row, plan.slot_col))  # old ids, new order
    perm = np.empty(plan.nslots + 2, dtype=np.int64)
    perm[order] = np.arange(plan.nslots)
    perm[plan.nslots:] = (plan.zero_slot, plan.trash_slot)

    def m(a):
        return perm[np.asarray(a, dtype=np.int64)].astype(a.dtype)

    bb = plan.bs * plan.bs
    init_idx = perm[plan.init_idx // bb] * bb + plan.init_idx % bb
    return dataclasses.replace(
        plan,
        init_idx=init_idx,
        diag_slot=m(plan.diag_slot),
        l_slots=m(plan.l_slots), u_slots=m(plan.u_slots),
        g_l=m(plan.g_l), g_u=m(plan.g_u), g_t=m(plan.g_t),
        lsol_gslot=m(plan.lsol_gslot), usol_gslot=m(plan.usol_gslot),
        slot_row=plan.slot_row[order], slot_col=plan.slot_col[order],
        slot_step=plan.slot_step[order],
    )


def block_symbolic(A: sp.spmatrix, bs: int,
                   ilu_level: int | None = None) -> SymbolicPlan:
    """Build the full static plan for the (already permuted/scaled) matrix A.

    ``ilu_level``: if set, perform level-based incomplete (ILU(k)) symbolic
    factorization at block granularity — fill blocks whose level exceeds
    ``ilu_level`` are dropped, along with the updates into them (analog of
    ``ilu_level_symbfact``, reference: SRC/prec-independent/
    ilu_level_symbfact.c:54-247). The resulting factorization is a
    preconditioner, not an exact solver.
    """
    A = sp.csc_matrix(A)
    n = A.shape[0]
    nb = max(1, -(-n // bs))
    n_pad = nb * bs

    # ---- block pattern of A ----
    coo = A.tocoo()
    bi = coo.row // bs
    bj = coo.col // bs
    a_keys = np.unique(bi.astype(np.int64) * nb + bj.astype(np.int64))
    # ensure all diagonal blocks exist (padding identity + GESP diagonal)
    diag_keys = np.arange(nb, dtype=np.int64) * nb + np.arange(nb)
    a_keys = np.unique(np.concatenate([a_keys, diag_keys]))

    # ---- native (C++) fast path for the fill simulation + tapes ----
    if ilu_level is None:
        from .native import native_block_symbolic
        nat = native_block_symbolic(nb, a_keys // nb, a_keys % nb)
        if nat is not None:
            return _renumber_column_major(
                _assemble_from_native(nat, A, coo, bi, bj, n, n_pad, bs,
                                      nb, len(a_keys)))

    # fill levels: A blocks at level 0; fill from (I,k)@lev_a, (k,J)@lev_b
    # gets level lev_a + lev_b + 1 (dropped above ilu_level)
    Ls = [dict() for _ in range(nb)]  # block col k -> {row block I>k: level}
    Us = [dict() for _ in range(nb)]  # block row k -> {col block J>k: level}
    for key in a_keys:
        I, J = int(key // nb), int(key % nb)
        if I > J:
            Ls[J][I] = 0
        elif I < J:
            Us[I][J] = 0

    # ---- pass 1: right-looking block fill simulation (with ILU levels) ----
    step_rows: list[np.ndarray] = []
    step_cols: list[np.ndarray] = []
    for k in range(nb):
        rows_d, cols_d = Ls[k], Us[k]
        rows = np.array(sorted(rows_d), dtype=np.int64)
        cols = np.array(sorted(cols_d), dtype=np.int64)
        step_rows.append(rows)
        step_cols.append(cols)
        for J in cols:
            J = int(J)
            lvJ = cols_d[J]
            tgt = Ls[J]
            for I in rows[rows > J]:
                I = int(I)
                lv = rows_d[I] + lvJ + 1
                if ilu_level is not None and lv > ilu_level:
                    continue
                if I not in tgt or tgt[I] > lv:
                    tgt[I] = lv
        for I in rows:
            I = int(I)
            lvI = rows_d[I]
            tgt = Us[I]
            for J in cols[cols > I]:
                J = int(J)
                lv = lvI + cols_d[J] + 1
                if ilu_level is not None and lv > ilu_level:
                    continue
                if J not in tgt or tgt[J] > lv:
                    tgt[J] = lv

    # ---- pass 2: gemm tape (updates into retained targets only) ----
    g_ti: list[np.ndarray] = []
    g_tj: list[np.ndarray] = []
    g_counts = np.zeros(nb, dtype=np.int64)
    for k in range(nb):
        rows, cols = step_rows[k], step_cols[k]
        II, JJ = [], []
        for I in rows:
            I = int(I)
            for J in cols:
                J = int(J)
                if I == J or (I > J and I in Ls[J]) or (I < J and J in Us[I]):
                    II.append(I)
                    JJ.append(J)
        g_ti.append(np.asarray(II, dtype=np.int64))
        g_tj.append(np.asarray(JJ, dtype=np.int64))
        g_counts[k] = len(II)

    # ---- slot assignment (diag first, then L/U panels in step order) ----
    slot_of: dict[int, int] = {}
    srow: list[int] = []
    scol: list[int] = []
    sstep: list[int] = []
    next_slot = 0
    diag_slot = np.empty(nb, dtype=np.int32)
    for k in range(nb):
        slot_of[k * nb + k] = next_slot
        diag_slot[k] = next_slot
        srow.append(k)
        scol.append(k)
        sstep.append(k)
        next_slot += 1
    l_ptr = np.zeros(nb + 1, dtype=np.int64)
    u_ptr = np.zeros(nb + 1, dtype=np.int64)
    l_slots_list = []
    u_slots_list = []
    for k in range(nb):
        rows, cols = step_rows[k], step_cols[k]
        ls = np.empty(len(rows), dtype=np.int32)
        for t, I in enumerate(rows):
            slot_of[int(I) * nb + k] = next_slot
            ls[t] = next_slot
            srow.append(int(I))
            scol.append(k)
            sstep.append(k)
            next_slot += 1
        us = np.empty(len(cols), dtype=np.int32)
        for t, J in enumerate(cols):
            slot_of[k * nb + int(J)] = next_slot
            us[t] = next_slot
            srow.append(k)
            scol.append(int(J))
            sstep.append(k)
            next_slot += 1
        l_slots_list.append(ls)
        u_slots_list.append(us)
        l_ptr[k + 1] = l_ptr[k] + len(rows)
        u_ptr[k + 1] = u_ptr[k] + len(cols)
    nslots = next_slot
    zero_slot = nslots
    trash_slot = nslots + 1

    l_slots = (np.concatenate(l_slots_list) if nb else np.empty(0)).astype(np.int32)
    u_slots = (np.concatenate(u_slots_list) if nb else np.empty(0)).astype(np.int32)

    # ---- resolve gemm triples to slots ----
    g_ptr = np.zeros(nb + 1, dtype=np.int64)
    g_ptr[1:] = np.cumsum(g_counts)
    total_g = int(g_ptr[-1])
    g_l = np.empty(total_g, dtype=np.int32)
    g_u = np.empty(total_g, dtype=np.int32)
    g_t = np.empty(total_g, dtype=np.int32)
    for k in range(nb):
        lo = int(g_ptr[k])
        II, JJ = g_ti[k], g_tj[k]
        if not len(II):
            continue
        rows, cols = step_rows[k], step_cols[k]
        lmap = {int(I): int(s) for I, s in zip(rows, l_slots_list[k])}
        umap = {int(J): int(s) for J, s in zip(cols, u_slots_list[k])}
        for t in range(len(II)):
            I, J = int(II[t]), int(JJ[t])
            g_l[lo + t] = lmap[I]
            g_u[lo + t] = umap[J]
            g_t[lo + t] = slot_of[I * nb + J]

    # ---- value initialization plan ----
    blk = slot_map_vectorized(slot_of, bi, bj, nb)
    init_idx = (blk.astype(np.int64) * bs * bs
                + (coo.row % bs).astype(np.int64) * bs
                + (coo.col % bs).astype(np.int64))
    n_ones = n_pad - n
    if n_ones:
        pad = np.arange(n, n_pad)
        pad_blk = np.array([slot_of[int(i // bs) * nb + int(i // bs)]
                            for i in pad], dtype=np.int64)
        pad_idx = pad_blk * bs * bs + (pad % bs) * bs + (pad % bs)
        init_idx = np.concatenate([init_idx, pad_idx])

    # ---- solve level schedules ----
    # final L pattern per block column k: step_rows (includes fill as produced)
    # regroup to block-row adjacency: L blocks (I,J): J in cols_of_row[I]
    lrow_src: list[list[tuple[int, int]]] = [[] for _ in range(nb)]  # I -> [(J, slot)]
    for k in range(nb):
        for I, s in zip(step_rows[k], l_slots_list[k]):
            lrow_src[int(I)].append((k, int(s)))
    lsol = _level_schedule(lrow_src, nb, forward=True)

    urow_src: list[list[tuple[int, int]]] = [[] for _ in range(nb)]  # I -> [(J, slot)]
    for k in range(nb):
        for J, s in zip(step_cols[k], u_slots_list[k]):
            urow_src[k].append((int(J), int(s)))
    usol = _level_schedule(urow_src, nb, forward=False)

    # ---- elimination levels over the filled block pattern ----
    step_level = np.zeros(nb, dtype=np.int64)
    for j in range(nb):
        lv = step_level[j] + 1
        for I in step_rows[j]:
            if step_level[I] < lv:
                step_level[I] = lv
        for J in step_cols[j]:
            if step_level[J] < lv:
                step_level[J] = lv
    n_flevels = int(step_level.max()) + 1 if nb else 1

    # ---- block etree: parent = min block > k adjacent in L col or U row ----
    block_parent = np.full(nb, -1, dtype=np.int64)
    for k in range(nb):
        cand = []
        if len(step_rows[k]):
            cand.append(step_rows[k][0])
        if len(step_cols[k]):
            cand.append(step_cols[k][0])
        if cand:
            block_parent[k] = min(cand)

    # ---- flops (dense-block model) ----
    b3 = float(bs) ** 3
    flops = (2.0 / 3.0) * b3 * nb \
        + b3 * (len(l_slots) + len(u_slots)) \
        + 2.0 * b3 * total_g

    return _renumber_column_major(SymbolicPlan(
        n=n, n_pad=n_pad, bs=bs, nb=nb, nslots=nslots,
        zero_slot=zero_slot, trash_slot=trash_slot,
        init_idx=init_idx, init_ones=n_ones,
        diag_slot=diag_slot, l_ptr=l_ptr, l_slots=l_slots,
        u_ptr=u_ptr, u_slots=u_slots,
        g_ptr=g_ptr, g_l=g_l, g_u=g_u, g_t=g_t,
        lsol_nlvl=lsol[0], lsol_gptr=lsol[1], lsol_gslot=lsol[2],
        lsol_gsrc=lsol[3], lsol_gdst=lsol[4], lsol_dptr=lsol[5],
        lsol_diag=lsol[6],
        usol_nlvl=usol[0], usol_gptr=usol[1], usol_gslot=usol[2],
        usol_gsrc=usol[3], usol_gdst=usol[4], usol_dptr=usol[5],
        usol_diag=usol[6],
        step_level=step_level, n_flevels=n_flevels,
        slot_row=np.asarray(srow, dtype=np.int64),
        slot_col=np.asarray(scol, dtype=np.int64),
        slot_step=np.asarray(sstep, dtype=np.int64),
        block_parent=block_parent, factor_flops=flops,
        fill_blocks=nslots, a_blocks=len(a_keys),
    ))


def block_symbolic_from_keys(n: int, bs: int,
                             a_keys: np.ndarray) -> SymbolicPlan:
    """Plan from the BLOCK pattern alone — the distributed-planning entry
    (psymbfact role, reference: SRC/prec-independent/psymbfact.c:26-5380):
    no process supplies the scalar pattern or values, so ``init_idx`` is
    empty; value placement happens per owner process via
    ``nrloc_entry_offsets``. ``a_keys`` are ``I*nb + J`` block keys of the
    (permuted) matrix; diagonal keys are added automatically. Plans are
    bit-identical to :func:`block_symbolic` on any matrix with this block
    pattern (same fill engine, same assembly)."""
    nb = max(1, -(-n // bs))
    n_pad = nb * bs
    diag_keys = np.arange(nb, dtype=np.int64) * nb + np.arange(nb)
    a_keys = np.unique(np.concatenate(
        [np.asarray(a_keys, dtype=np.int64), diag_keys]))
    from .native import native_block_symbolic
    nat = native_block_symbolic(nb, a_keys // nb, a_keys % nb)
    if nat is None:
        # fallback: a one-entry-per-block surrogate matrix reproduces the
        # identical block pattern through the python fill engine
        I = (a_keys // nb) * bs
        J = (a_keys % nb) * bs
        I = np.minimum(I, n - 1)
        J = np.minimum(J, n - 1)
        S = sp.csc_matrix((np.ones(len(a_keys)), (I, J)), shape=(n, n))
        plan = block_symbolic(S, bs)
        return dataclasses.replace(
            plan, init_idx=np.empty(0, dtype=np.int64))
    return _renumber_column_major(
        _assemble_from_native(nat, None, None, None, None, n, n_pad, bs,
                              nb, len(a_keys)))


def _assemble_from_native(nat, A, coo, bi, bj, n, n_pad, bs, nb,
                          a_blocks) -> SymbolicPlan:
    """Build the SymbolicPlan from the C++ engine's arrays (value-placement
    indices, flop model, and dtype coercions happen here). ``coo=None``
    (distributed planning) leaves ``init_idx`` empty — value placement is
    per-process there."""
    nslots = len(nat["slot_row"])
    if coo is None:
        init_idx = np.empty(0, dtype=np.int64)
        n_ones = n_pad - n
    else:
        slot_of = {int(r) * nb + int(c): s
                   for s, (r, c) in enumerate(zip(nat["slot_row"],
                                                  nat["slot_col"]))}
        blk = slot_map_vectorized(slot_of, bi, bj, nb)
        init_idx = (blk.astype(np.int64) * bs * bs
                    + (coo.row % bs).astype(np.int64) * bs
                    + (coo.col % bs).astype(np.int64))
        n_ones = n_pad - n
        if n_ones:
            pad = np.arange(n, n_pad)
            pad_blk = np.array([slot_of[int(i // bs) * nb + int(i // bs)]
                                for i in pad], dtype=np.int64)
            init_idx = np.concatenate(
                [init_idx, pad_blk * bs * bs + (pad % bs) * bs
                 + (pad % bs)])

    b3 = float(bs) ** 3
    flops = (2.0 / 3.0) * b3 * nb \
        + b3 * (len(nat["l_slots"]) + len(nat["u_slots"])) \
        + 2.0 * b3 * len(nat["g_l"])
    n_flevels = int(nat["step_level"].max()) + 1 if nb else 1

    def i32(x):
        return np.asarray(x, dtype=np.int32)

    return SymbolicPlan(
        n=n, n_pad=n_pad, bs=bs, nb=nb, nslots=nslots,
        zero_slot=nslots, trash_slot=nslots + 1,
        init_idx=init_idx, init_ones=n_ones,
        diag_slot=i32(nat["diag_slot"]),
        l_ptr=nat["l_ptr"], l_slots=i32(nat["l_slots"]),
        u_ptr=nat["u_ptr"], u_slots=i32(nat["u_slots"]),
        g_ptr=nat["g_ptr"], g_l=i32(nat["g_l"]), g_u=i32(nat["g_u"]),
        g_t=i32(nat["g_t"]),
        lsol_nlvl=len(nat["lsol_dptr"]) - 1,
        lsol_gptr=nat["lsol_gptr"], lsol_gslot=i32(nat["lsol_gslot"]),
        lsol_gsrc=i32(nat["lsol_gsrc"]), lsol_gdst=i32(nat["lsol_gdst"]),
        lsol_dptr=nat["lsol_dptr"], lsol_diag=i32(nat["lsol_diag"]),
        usol_nlvl=len(nat["usol_dptr"]) - 1,
        usol_gptr=nat["usol_gptr"], usol_gslot=i32(nat["usol_gslot"]),
        usol_gsrc=i32(nat["usol_gsrc"]), usol_gdst=i32(nat["usol_gdst"]),
        usol_dptr=nat["usol_dptr"], usol_diag=i32(nat["usol_diag"]),
        step_level=nat["step_level"], n_flevels=n_flevels,
        slot_row=nat["slot_row"], slot_col=nat["slot_col"],
        slot_step=nat["slot_step"],
        block_parent=nat["block_parent"], factor_flops=flops,
        fill_blocks=nslots, a_blocks=a_blocks,
    )


def slot_map_vectorized(slot_of: dict, bi, bj, nb) -> np.ndarray:
    keys = bi.astype(np.int64) * nb + bj.astype(np.int64)
    uk, inv = np.unique(keys, return_inverse=True)
    us = np.array([slot_of[int(k)] for k in uk], dtype=np.int64)
    return us[inv]


def _level_schedule(row_src, nb, forward: bool):
    """Level-set schedule for a triangular solve.

    ``row_src[I]`` lists (J, slot) dependencies: x_I needs x_J through block
    ``slot``. Forward solve: J < I, levels ascending; backward: J > I.
    Returns (nlvl, gptr, gslot, gsrc, gdst, dptr, diag).
    """
    level = np.zeros(nb, dtype=np.int64)
    order = range(nb) if forward else range(nb - 1, -1, -1)
    for I in order:
        deps = row_src[I]
        if deps:
            level[I] = max(level[J] for J, _ in deps) + 1
    nlvl = int(level.max()) + 1 if nb else 1

    # group diag applications by level
    dptr = np.zeros(nlvl + 1, dtype=np.int64)
    counts = np.bincount(level, minlength=nlvl)
    dptr[1:] = np.cumsum(counts)
    diag = np.argsort(level, kind="stable").astype(np.int32)

    # group gemms by level of their destination
    gs, gr, gd, glev = [], [], [], []
    for I in range(nb):
        for J, s in row_src[I]:
            gs.append(s)
            gr.append(J)
            gd.append(I)
            glev.append(level[I])
    gs = np.asarray(gs, dtype=np.int32)
    gr = np.asarray(gr, dtype=np.int32)
    gd = np.asarray(gd, dtype=np.int32)
    glev = np.asarray(glev, dtype=np.int64)
    o = np.argsort(glev, kind="stable")
    gs, gr, gd, glev = gs[o], gr[o], gd[o], glev[o]
    gptr = np.zeros(nlvl + 1, dtype=np.int64)
    gcnt = np.bincount(glev, minlength=nlvl) if len(glev) else np.zeros(nlvl, np.int64)
    gptr[1:] = np.cumsum(gcnt)
    return nlvl, gptr, gs, gr, gd, dptr, diag
