"""Kernel 5: the tiled column factor (tck), level by level.

Counterpart of the JAX package's ``ops/kernels/tck.py``: clk's
left-looking column factor, with a tile of ``w`` block rows sliding down
each block column. Per elimination level, on one stream:

1. ``tck_update`` (``csrc/tck.cu``): every stored (i,k) of the level's
   columns becomes (i,k) − Σ L(i,j)·U(j,k), and every U block is then
   finalized as linv(j)·U(j,k) (the TPU kernel's LOAD / GEMM / FINU /
   STORE stream), in two phases:

   - phase A, ``tck_waves``: the U part of every column, in clk's
     source-ready waves (``clk._waves`` fed only the products whose target
     lies above the diagonal; one launch per wave of the wave kernel that
     ``clk_update`` runs). A U block therefore sums by source wave, then
     ascending j, exactly as clk's U blocks do;
   - phase B: the diagonal and L positions. In the FP32 pass
     (``tck_tiles``) one launch: a column's positions are cut into tiles
     of up to ``w`` consecutive rows; one CTA per (tile, strip) holds the
     tile in shared memory, loaded once and stored once, and subtracts
     every product into it in ascending source j, then L block (tck's
     and the JAX kernel's order). Every source U(j,k) is final after
     phase A and comes from the pool. A tile's products run in one
     chain, so each level takes the tallest tile whose longest chain
     stays within the level's floor: the longest chain of one position,
     or the level's products times strips over ``sweep.CHUNK_CTAS`` (two
     CTAs per SM), its share of a full card. In the bf16 pass
     (``tck_chains``) each position's chain (the same products in the
     same order) is cut into chunks of at most ``flk.CHUNK_MAX`` products
     by flk's rule and runs on flk's two passes (``csrc/passes.cuh``, on
     the bf16 chain product that flk's bf16 pass runs):
     pass 1 finishes a position of one chunk and writes each chunk of the
     others to a float32 scratch row, pass 2 adds a position's rows in
     chunk order. No position waits on a chain longer than a chunk;
2. ``diag_lu`` on the level's diagonal blocks (its DIAG jobs);
3. ``clk_trsm``: L(i,k) ← L(i,k)·uinv(k) (its TRSM jobs).

``precision`` is the pass precision of the update's and the TRSM's
products, as for clk (``clk.py`` says what each pass rounds):
``"highest"`` runs them in IEEE FP32 (``slu_tck_waves_f32``,
``slu_tck_tiles_f32``, ``slu_clk_trsm_f32``); ``"default"`` in one bf16
pass with float32 accumulation, as the TPU kernel's ``dot`` at precision
``"default"`` (tck.py:226-228 there: the U finalize, the update products
and the L-part TRSM), on the tensor cores (``slu_tck_waves_bf16``,
``slu_tck_chunks_bf16``, ``slu_tck_sum_bf16``, counted on
``UPDATE_BF16``; the TRSM on ``clk.TRSM_BF16``). ``diag_lu`` is always
full precision.

Columns of one level depend only on columns of lower levels, which
replaces the TPU kernel's sequential grid. Without that grid the TPU's
segments, bucket padding, NOP pads and pool-end shift have no counterpart,
and the DIAG and TRSM jobs are the launches that clk runs (the TPU kernel
fused them only because its tile sat whole in VMEM). ``host["counts"]``
keeps the job counts of the TPU kernel's stream at tile rows ``w``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..blocklu import level_order
from ..host.symbolic import SymbolicPlan
from ._build import CudaKernel, ptr, stream_ptr
from .clk import _waves, clk_trsm, clk_update_waves_plain, launch_waves
from .diag_lu import CUDA_BLOCK_SIZES, diag_lu
from .flk import _chunk_tapes, passes_plain
from .schur import check_precision, matmul_at
from .sweep import CHUNK_CTAS

_V = ctypes.c_void_p
_I = ctypes.c_int
UPDATE = CudaKernel("tck_update", "tck.cu", {
    "slu_tck_waves_f32": [_V] * 9 + [_I, _I, _V],
    "slu_tck_tiles_f32": [_V] * 5 + [_I] * 4 + [_V]})
#: the same kernels' bf16 pass (precision "default"), counted apart
UPDATE_BF16 = CudaKernel("tck_update_bf16", "tck.cu", {
    "slu_tck_waves_bf16": [_V] * 10 + [_I, _I, ctypes.c_int64,
                                       ctypes.c_int64, _V],
    "slu_tck_chunks_bf16": [_V] * 8 + [_I, _I, _I, _V],
    "slu_tck_sum_bf16": [_V] * 6 + [_I, _I, _I, _V]})
#: the kernel and the phase-A entry of each pass
_PASS = {"highest": (UPDATE, "slu_tck_waves_f32"),
         "default": (UPDATE_BF16, "slu_tck_waves_bf16")}

MC = 8            # L blocks per GEMM chunk in the job count (the TPU's MC)
TC = 8            # L blocks per TRSM job in the job count (its TC)
TN = 16           # scalar columns per CTA strip (csrc/tck.cu)
KC, STAGES = 32, 3   # waves.cuh's staged chunk width and ring depth
#: the shared memory of one H100 SM, and what the card reserves per CTA
SM_SMEM, CTA_RESERVED = 228 * 1024, 1024
#: the shared memory of a phase-B CTA: two of them share an SM
TILE_SMEM = SM_SMEM // 2 - CTA_RESERVED
#: the most that one CTA may take (csrc/tck.cu kMaxSmem)
CTA_SMEM_MAX = 227 * 1024
#: products per batched product in the plain version of phase B
PLAIN_BATCH = 256


def ring_bytes(bs: int) -> int:
    """Shared memory of the FP32 phase B's cp.async ring at block size
    ``bs``: STAGES chunks of a bs x KC L chunk (rows padded by 4) and KC x
    TN of the U strip."""
    return STAGES * (bs * (KC + 4) + KC * TN) * 4


def tile_rows(bs: int) -> int:
    """The tallest tile (block rows) of the FP32 phase B at block size
    ``bs``: the rows of ``bs x TN`` floats that fit in ``TILE_SMEM``
    beside the ring, so that two CTAs share an SM (46 at bs 32, 20 at 64,
    6 at 128; taller tiles, up to the 227 KiB of one CTA, were no faster
    on an H100: ``tools/tck_ab.py``)."""
    return max(1, (TILE_SMEM - ring_bytes(bs)) // (bs * TN * 4))


@dataclasses.dataclass
class ChainTapes:
    """Phase B of the bf16 pass: one chain per diagonal or L position
    that has products, cut into chunks, in the fields of
    :class:`flk.FlkTapes` (targets without finalize). ``tptr``, ``qptr``,
    ``nrow`` and ``mptr`` are per level, host int64 arrays; the rest are
    int32 device tensors.

    - level l's positions are ``tptr[l]:tptr[l+1]``, in the tiles' order
      (a tile's positions top down); position t is the block at pool slot
      ``tslot[t]`` and sums ``pool[cl[p]]·pool[cu[p]]`` for p over
      ``cptr[t]:cptr[t+1]`` in the tiles' order (ascending source j);
    - chunks and pass 2 as in ``FlkTapes``: level l's chunks
      ``qptr[l]:qptr[l+1]`` (``qtgt``, ``qrow``, ``qcptr``) over ``nrow[l]``
      scratch rows, its positions of several chunks ``mptr[l]:mptr[l+1]``
      (``mtgt``, ``mrow``, ``mcnt``).
    """

    tptr: np.ndarray
    qptr: np.ndarray
    nrow: np.ndarray
    mptr: np.ndarray
    tslot: torch.Tensor
    cl: torch.Tensor
    cu: torch.Tensor
    qtgt: torch.Tensor
    qrow: torch.Tensor
    qcptr: torch.Tensor
    mtgt: torch.Tensor
    mrow: torch.Tensor
    mcnt: torch.Tensor
    host: dict


@dataclasses.dataclass
class TckTapes:
    """Per-level schedule of the tck factor. ``lwave``, ``wptr``,
    ``tptr``, ``hmax``, ``dptr`` and ``lptr`` are host int64 arrays;
    every other field is an int32 tensor on the device.

    - phase A, clk's wave tapes (:class:`clk.ClkTapes`, field for field)
      over the U targets: level l's waves ``lwave[l]:lwave[l+1]``, wave
      w's targets ``wptr[w]:wptr[w+1]`` (``tslot``, ``tstep``, ``tfin``),
      target t's products ``pptr[t]:pptr[t+1]`` of ``cl``/``cu``;
    - phase B: level l's tiles ``tptr[l]:tptr[l+1]`` of ``tiles``, each a
      row (first slot, rows, q0, q1), longest product list first; product
      q is L = ``bl[q]``, U = ``bu[q]`` into the tile's position ``bd[q]``,
      a tile's products in ascending source j, then L block. ``hmax[l]``
      is the tallest tile of level l (it sizes the launch's shared memory);
    - diag: ``dslot``/``dstep`` over ``dptr``;
    - trsm (``clk.clk_trsm``): ``lslot``/``lstep`` over ``lptr``.

    ``w`` is the tile rows at most; ``host`` holds numpy copies, the
    per-level tile rows ``trows`` and the TPU kernel's job counts
    (``counts``).
    """

    nlvl: int
    w: int
    lwave: np.ndarray
    wptr: np.ndarray
    tslot: torch.Tensor
    tstep: torch.Tensor
    tfin: torch.Tensor
    pptr: torch.Tensor
    cl: torch.Tensor
    cu: torch.Tensor
    tptr: np.ndarray
    hmax: np.ndarray
    tiles: torch.Tensor
    bl: torch.Tensor
    bu: torch.Tensor
    bd: torch.Tensor
    dptr: np.ndarray
    dslot: torch.Tensor
    dstep: torch.Tensor
    lptr: np.ndarray
    lslot: torch.Tensor
    lstep: torch.Tensor
    chains: ChainTapes
    host: dict


def build_tck_tapes(plan: SymbolicPlan, device, w: int | None = None,
                    mc: int = MC, chunk: int | None = None) -> TckTapes:
    """Host tapes from the column-major slot order. With ``w`` None, each
    level's tiles are the tallest of up to ``tile_rows(plan.bs)`` rows
    that keep its longest chain within its floor; a given ``w`` cuts
    tiles of ``w`` rows on every level. ``mc`` is the TPU's GEMM chunk in
    the job counts (taken at the tile rows ``tp.w``). ``chunk`` forces
    that chunk length on the bf16 phase B's chains (None:
    ``flk.group_chunk`` per level). Raises ValueError if the exact-LU
    fill closure does not hold (an ILU plan)."""
    nb = plan.nb
    fixed = w is not None
    w = int(w) if fixed else tile_rows(plan.bs)
    if w < 1 or mc < 1:
        raise ValueError("tck: tile rows and chunk size must be positive")
    scol = np.asarray(plan.slot_col, dtype=np.int64)
    srow = np.asarray(plan.slot_row, dtype=np.int64)
    if np.any(np.diff(scol) < 0):
        raise ValueError("tck requires column-major slots")
    colptr = np.searchsorted(scol, np.arange(nb + 1))
    ncol = np.diff(colptr)
    diag_slot = np.asarray(plan.diag_slot, dtype=np.int64)
    dpos = diag_slot - colptr[:nb]             # U blocks above the diagonal
    la0 = diag_slot + 1                        # first L slot of each column
    lm = colptr[1:] - la0                      # L blocks of each column

    # one pair per U block (j, k) at position t of column k, in (k, t)
    # order (clk's jobs); one entry per L block m of column j, i.e. per
    # product L(i, j)·U(j, k) into position pos of column k
    pair0 = np.concatenate([[0], np.cumsum(dpos)])   # first pair of each k
    npair = int(pair0[-1])
    p_col = np.repeat(np.arange(nb), dpos)
    p_t = np.arange(npair) - pair0[p_col]
    p_src = srow[colptr[p_col] + p_t]
    p_lm = lm[p_src]
    nd = int(p_lm.sum())
    d_pair = np.repeat(np.arange(npair), p_lm)
    d_m = np.arange(nd) - np.repeat(np.cumsum(p_lm) - p_lm, p_lm)
    d_col, d_t, d_src = p_col[d_pair], p_t[d_pair], p_src[d_pair]
    d_row = srow[la0[d_src] + d_m]
    key = scol * nb + srow
    tkey = d_col * nb + d_row
    at = np.searchsorted(key, tkey)
    if nd and not np.all((at < len(key))
                         & (key[np.minimum(at, len(key) - 1)] == tkey)):
        raise ValueError("fill closure violated — tck needs exact-LU "
                         "symbolic")
    d_pos = at - colptr[d_col]
    d_l = la0[d_src] + d_m                     # the product's L slot
    lev = np.asarray(plan.step_level)
    nlvl = plan.n_flevels

    # phase A: clk's waves over the products into U blocks
    u = d_pos < dpos[d_col]
    host = dict(job_slot=colptr[p_col] + p_t, job_src=p_src,
                col_base=colptr[:nb], col_dpos=dpos, col_job0=pair0[:nb])
    lwave, wptr = _waves(host, nlvl, lev, p_col, d_pair[u], d_l[u], at[u],
                         len(scol))

    # phase B: the products into diagonal and L positions, by tile
    b = ~u
    b_col, b_t, b_pos, b_l = d_col[b], d_t[b], d_pos[b], d_l[b]
    b_lev = lev[b_col]
    b_off = b_pos - dpos[b_col]                # position below the diagonal
    trows = np.full(nlvl, w, dtype=np.int64) if fixed else \
        _tile_rows_by_level(b_lev, b_col, b_off, nlvl, w,
                            max(1, plan.bs // TN) / CHUNK_CTAS)
    b_tile = b_off // trows[b_lev]
    o = np.lexsort((d_m[b], b_t, b_tile, b_col, b_lev))
    b_col, b_t, b_pos, b_l, b_lev, b_tile = (a[o] for a in (
        b_col, b_t, b_pos, b_l, b_lev, b_tile))
    nq = len(b_col)
    new = np.ones(nq, dtype=bool)
    new[1:] = (b_col[1:] != b_col[:-1]) | (b_tile[1:] != b_tile[:-1])
    q0 = np.flatnonzero(new)
    q1 = np.r_[q0[1:], nq]
    t_col, t_lev = b_col[q0], b_lev[q0]
    t_lo = np.minimum.reduceat(b_pos, q0) if nq else q0
    t_hi = np.maximum.reduceat(b_pos, q0) if nq else q0
    # per level the longest product lists first, so that they start first
    to = np.lexsort((np.arange(len(q0)), q0 - q1, t_lev))
    t_col, t_lev, t_lo, t_hi, q0, q1 = (a[to] for a in (
        t_col, t_lev, t_lo, t_hi, q0, q1))
    perm = np.concatenate([np.arange(a, c) for a, c in zip(q0, q1)]) \
        if nq else np.zeros(0, dtype=np.int64)
    cnt = q1 - q0
    q0 = np.cumsum(cnt) - cnt
    tiles = np.stack([colptr[t_col] + t_lo, t_hi - t_lo + 1, q0, q0 + cnt],
                     axis=1)
    bd = b_pos[perm] - np.repeat(t_lo, cnt)
    tptr = np.zeros(nlvl + 1, dtype=np.int64)
    tptr[1:] = np.cumsum(np.bincount(t_lev, minlength=nlvl))
    hmax = np.zeros(nlvl, dtype=np.int64)
    np.maximum.at(hmax, t_lev, t_hi - t_lo + 1)

    lvo = level_order(plan)
    dstep = lvo["dstep"]
    host.update(tiles=tiles, bl=b_l[perm], bu=colptr[b_col[perm]]
                + b_t[perm], bd=bd, trows=trows,
                dslot=diag_slot[dstep], dstep=dstep,
                lslot=lvo["l_slot"], lstep=lvo["l_step"],
                counts=_tpu_counts(ncol, dpos, d_col, d_t, d_m, d_pos, w,
                                   mc, nb))

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32),
                               device=device)

    return TckTapes(
        nlvl=nlvl, w=w, lwave=lwave, wptr=wptr, tptr=tptr, hmax=hmax,
        **{k: dev(host[k]) for k in ("tslot", "tstep", "tfin", "pptr", "cl",
                                     "cu", "tiles", "bl", "bu", "bd",
                                     "dslot", "dstep", "lslot", "lstep")},
        dptr=np.asarray(lvo["dptr"]), lptr=np.asarray(lvo["lptr"]),
        chains=_chain_tapes(tiles, host["bl"], host["bu"], bd, tptr,
                            plan.bs, chunk, dev),
        host=host)


def _chain_tapes(tiles, bl, bu, bd, tptr, bs, chunk, dev) -> ChainTapes:
    """Phase B's products (tile by tile, each tile's in ascending source
    j, then L block) regrouped by position, each position's keeping its
    order, and cut into chunks by ``flk._chunk_tapes``."""
    cnt = tiles[:, 3] - tiles[:, 2]
    qtile = np.repeat(np.arange(len(tiles)), cnt)
    o = np.lexsort((np.arange(len(qtile)), bd, qtile))
    qt, d = qtile[o], bd[o]
    new = np.ones(len(o), dtype=bool)
    new[1:] = (qt[1:] != qt[:-1]) | (d[1:] != d[:-1])
    start = np.flatnonzero(new)
    tlev = np.repeat(np.arange(len(tptr) - 1), np.diff(tptr))[qt[start]]
    host = dict(tslot=tiles[qt[start], 0] + d[start],
                cptr=np.r_[start, len(o)], cl=bl[o], cu=bu[o],
                tptr=np.searchsorted(tlev, np.arange(len(tptr))))
    host.update(_chunk_tapes(host["cptr"], host["tptr"], bs, chunk))
    ptrs = {k: host[k] for k in ("tptr", "qptr", "nrow", "mptr")}
    return ChainTapes(**ptrs, host=host, **{
        k: dev(host[k]) for k in ("tslot", "cl", "cu", "qtgt", "qrow",
                                  "qcptr", "mtgt", "mrow", "mcnt")})


def _tile_rows_by_level(lev, col, off, nlvl, w, share):
    """Per level, the tallest tile (at most ``w`` rows) whose longest
    product list stays within the level's floor: the longest list of one
    position, or its products times ``share`` (strips per position over
    the CTAs that fill the card). Product i of the level ``lev[i]`` goes
    into column ``col[i]``, ``off[i]`` rows below its diagonal."""
    rows = np.ones(nlvl, dtype=np.int64)
    order = np.argsort(lev, kind="stable")
    cuts = np.searchsorted(lev[order], np.arange(nlvl + 1))
    span = int(off.max(initial=0)) + 1
    for lvl in range(nlvl):
        sel = order[cuts[lvl]:cuts[lvl + 1]]
        if not len(sel):
            continue

        def longest(r):
            return np.unique(col[sel] * span + off[sel] // r,
                             return_counts=True)[1].max()

        floor = max(longest(1), len(sel) * share)
        rows[lvl] = max(r for r in range(1, w + 1) if longest(r) <= floor)
    return rows


def _tpu_counts(ncol, dpos, d_col, d_t, d_m, d_pos, w, mc, nb) -> dict:
    """The job counts by type of the TPU kernel's stream (no NOP pads) at
    tile rows ``w`` and GEMM chunks of ``mc``: tiles of ``w`` rows down
    each whole column; a GEMM job per chunk of a source's L blocks within
    a tile; a FINU job per U block that is no source inside its own tile;
    a TRSM job per ``TC`` L blocks of a tile."""
    d_tile = d_pos // w
    o = np.lexsort((d_m, d_t, d_tile, d_col))
    d_col, d_t, d_tile = d_col[o], d_t[o], d_tile[o]
    nd = len(d_col)
    new_run = np.ones(nd, dtype=bool)
    new_run[1:] = ((d_col[1:] != d_col[:-1]) | (d_tile[1:] != d_tile[:-1])
                   | (d_t[1:] != d_t[:-1]))
    run_start = np.flatnonzero(new_run)
    in_run = np.arange(nd) - np.repeat(run_start, np.diff(
        np.r_[run_start, nd]))
    gemm = int((in_run % mc == 0).sum())
    # U blocks that are a source inside their own tile
    in_tile = np.unique((d_col * nb + d_t)[(d_t // w == d_tile)])
    ntile = -(-ncol // w)
    all_i = np.arange(int(ntile.sum())) - np.repeat(
        np.concatenate([[0], np.cumsum(ntile)[:-1]]), ntile)
    all_col = np.repeat(np.arange(nb), ntile)
    lo = np.maximum(all_i * w, dpos[all_col] + 1)
    hi = np.minimum(all_i * w + w, ncol[all_col])
    return dict(gemm=gemm, finu=int(dpos.sum()) - len(in_tile), diag=nb,
                trsm=int((-(-np.maximum(hi - lo, 0) // TC)).sum()),
                tiles=int(ntile.sum()))


# ---------------------------------------------------------------------------
# phase 1: the update, phase A (U blocks in waves) then phase B (tiles)
# ---------------------------------------------------------------------------


def tck_waves_plain(pool, linv, tp: TckTapes, level: int,
                    precision: str = "highest") -> None:
    """Plain version of :func:`tck_waves`: clk's wave order on tck's
    phase-A tapes (``clk.clk_update_waves_plain``)."""
    clk_update_waves_plain(pool, linv, tp, level, precision)


def tck_tiles_plain(pool, tp: TckTapes, level: int,
                    precision: str = "highest") -> None:
    """Plain version of :func:`tck_tiles`: the level's products in tape
    order, each target summing its products in ascending source j, then L
    block (in batches of ``PLAIN_BATCH``), at ``precision``."""
    check_precision(precision)
    h = tp.host
    lo, hi = int(tp.tptr[level]), int(tp.tptr[level + 1])
    if hi == lo:
        return
    dev = pool.device
    t = h["tiles"][lo:hi]
    q0, q1 = int(t[0, 2]), int(t[-1, 3])
    dst = np.repeat(t[:, 0], t[:, 3] - t[:, 2]) + h["bd"][q0:q1]
    for a in range(q0, q1, PLAIN_BATCH):
        e = min(a + PLAIN_BATCH, q1)
        L = pool[torch.as_tensor(h["bl"][a:e], device=dev)]
        U = pool[torch.as_tensor(h["bu"][a:e], device=dev)]
        pool.index_add_(0, torch.as_tensor(dst[a - q0:e - q0], device=dev),
                        matmul_at(L, U, precision), alpha=-1)


def tck_chains_plain(pool, tp: TckTapes, level: int,
                     precision: str = "default") -> None:
    """Plain version of :func:`tck_chains`: flk's two passes over the
    level's chunks (``flk.passes_plain``; a position of one chunk sums
    into itself, the others' chunks into scratch rows that are then added
    in chunk order), the products at ``precision``."""
    c = tp.chains
    passes_plain(pool, c.host, int(c.qptr[level]), int(c.qptr[level + 1]),
                 int(c.mptr[level]), int(c.mptr[level + 1]),
                 int(c.nrow[level]), precision)


def tck_update_plain(pool, linv, tp: TckTapes, level: int,
                     precision: str = "highest") -> None:
    """Plain version of :func:`tck_update`: phase A, then phase B in the
    tiles' order (:func:`tck_tiles_plain`) at "highest" or the chunks'
    (:func:`tck_chains_plain`) at "default"."""
    tck_waves_plain(pool, linv, tp, level, precision)
    (tck_chains_plain if precision == "default" else tck_tiles_plain)(
        pool, tp, level, precision)


def tck_waves(pool, linv, tp: TckTapes, level: int,
              precision: str = "highest") -> None:
    """Phase A of ``level``: its U blocks in source-ready waves (in
    place), one launch per wave (``clk.launch_waves``), the products at
    ``precision``."""
    check_precision(precision)
    if pool.device.type == "cpu":
        return tck_waves_plain(pool, linv, tp, level, precision)
    _check_cuda(pool, linv, pool.shape[-1])
    kernel, fn = _PASS[precision]
    launch_waves(kernel, fn, pool, linv, tp, level)


def tck_tiles(pool, tp: TckTapes, level: int) -> None:
    """Phase B of ``level`` in the FP32 pass: its diagonal and L
    positions, tile by tile (in place), one launch."""
    if pool.device.type == "cpu":
        return tck_tiles_plain(pool, tp, level)
    _check_cuda(pool, pool, pool.shape[-1], tp.w)
    lo, hi = int(tp.tptr[level]), int(tp.tptr[level + 1])
    if hi == lo:
        return
    fn = "slu_tck_tiles_f32"
    UPDATE.count(fn)
    UPDATE.call(fn, ptr(pool), ptr(tp.tiles), ptr(tp.bl), ptr(tp.bu),
                ptr(tp.bd), lo, hi - lo, int(tp.hmax[level]),
                pool.shape[-1], stream_ptr(pool.device))


def tck_chains(pool, tp: TckTapes, level: int, wide: int = -1) -> None:
    """Phase B of ``level`` in the bf16 pass (in place): pass 1 over its
    chunks, then pass 2 over its positions of several chunks. ``wide``
    < 0 lets the kernel choose its bands (``csrc/chain.cuh``), 0 / 1
    force bands of 16 / 64."""
    if pool.device.type == "cpu":
        return tck_chains_plain(pool, tp, level)
    _check_cuda(pool, pool, pool.shape[-1])
    c = tp.chains
    q0, q1 = int(c.qptr[level]), int(c.qptr[level + 1])
    if q1 == q0:
        return
    bs, stream = pool.shape[-1], stream_ptr(pool.device)
    nrow = int(c.nrow[level])
    scratch = torch.empty((nrow, bs, bs), dtype=pool.dtype,
                          device=pool.device) if nrow else None
    sp = ptr(scratch) if nrow else None
    UPDATE_BF16.count("slu_tck_chunks_bf16")
    UPDATE_BF16.call("slu_tck_chunks_bf16", ptr(pool), sp, ptr(c.qtgt[q0:]),
                     ptr(c.qrow[q0:]), ptr(c.qcptr[q0:]), ptr(c.tslot),
                     ptr(c.cl), ptr(c.cu), q1 - q0, bs, wide, stream)
    m0, m1 = int(c.mptr[level]), int(c.mptr[level + 1])
    if m1 > m0:
        UPDATE_BF16.count("slu_tck_sum_bf16")
        UPDATE_BF16.call("slu_tck_sum_bf16", ptr(pool), sp, ptr(c.mtgt[m0:]),
                         ptr(c.mrow[m0:]), ptr(c.mcnt[m0:]), ptr(c.tslot),
                         m1 - m0, bs, wide, stream)


def tck_update(pool, linv, tp: TckTapes, level: int,
               precision: str = "highest") -> None:
    """Tiled left-looking update of the columns of ``level`` (in place):
    phase A, then phase B (:func:`tck_tiles` at "highest",
    :func:`tck_chains` at "default"), the products at ``precision``."""
    tck_waves(pool, linv, tp, level, precision)
    if precision == "default":
        tck_chains(pool, tp, level)
    else:
        tck_tiles(pool, tp, level)


def _check_cuda(pool, linv, bs, w=None):
    """Raise unless the wrappers' tensors suit the kernels; with ``w``,
    unless tiles of ``w`` rows fit a CTA of the FP32 phase B."""
    if pool.device.type != "cuda":
        raise ValueError(f"tck: unsupported device {pool.device}")
    for t in (pool, linv):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != pool.device or t.shape[-2:] != (bs, bs):
            raise ValueError("tck: pool and inverses must be contiguous "
                             "float32 (., bs, bs) tensors on one device")
    if bs not in CUDA_BLOCK_SIZES:
        raise ValueError(f"tck: block size {bs} not in {CUDA_BLOCK_SIZES}")
    if w is not None and ring_bytes(bs) + w * bs * TN * 4 > CTA_SMEM_MAX:
        raise ValueError(f"tck: tiles of {w} rows exceed a CTA's shared "
                         f"memory at block size {bs}")


# ---------------------------------------------------------------------------
# the whole factor
# ---------------------------------------------------------------------------


def factor_level(pool, linv, uinv, tiny, thresh, tp: TckTapes,
                 level: int, precision: str = "highest") -> None:
    """The three phases of one elimination level; the update's and the
    TRSM's products at ``precision``, diag_lu in full precision."""
    lo, hi = int(tp.dptr[level]), int(tp.dptr[level + 1])
    tck_update(pool, linv, tp, level, precision)
    diag_lu(pool, linv, uinv, tp.dslot[lo:hi], tp.dstep[lo:hi], thresh, tiny)
    clk_trsm(pool, uinv, tp, level, precision)


def factor(pool, thresh: float, tp: TckTapes, nb: int,
           precision: str = "highest"):
    """Factor ``pool`` in place, the products at ``precision`` (see the
    module docstring). Returns (pool, linv, uinv, tiny) with linv/uinv of
    shape (nb, bs, bs) and tiny an int32 tensor (1,)."""
    bs = pool.shape[-1]
    linv = torch.zeros((nb, bs, bs), dtype=pool.dtype, device=pool.device)
    uinv = torch.zeros_like(linv)
    tiny = torch.zeros(1, dtype=torch.int32, device=pool.device)
    for level in range(tp.nlvl):
        factor_level(pool, linv, uinv, tiny, thresh, tp, level, precision)
    return pool, linv, uinv, tiny
