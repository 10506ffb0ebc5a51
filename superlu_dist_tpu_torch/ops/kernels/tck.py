"""Kernel 5: the tiled column factor (tck), level by level.

Counterpart of the JAX package's ``ops/kernels/tck.py``: clk's
left-looking column factor, with a tile of ``w`` block rows sliding down
each block column. Per elimination level, on one stream:

1. ``tck_update`` (``csrc/tck.cu``): for each column k of the level, tile
   by tile, every U(j,k) is finalized as linv(j)·U(j,k) and every stored
   position p of column k receives −Σ L(i,j)·U(j,k) over its sources j in
   ascending order (the TPU kernel's LOAD / GEMM / FINU / STORE jobs);
2. ``diag_lu`` on the level's diagonal blocks (its DIAG jobs);
3. ``clk_trsm``: L(i,k) ← L(i,k)·uinv(k) (its TRSM jobs).

The schedule is the TPU kernel's (``build_tck_tapes`` there): a column's
positions are cut into tiles of ``w``; within a tile the GEMM chunks (up
to ``mc`` L blocks of one source column) run in ascending source order; a
U block that is a source inside its own tile is finalized in place on its
first use there, one that is not gets a FINU job at the end of its tile,
and a source from an earlier tile is read back from the pool, already
final. Columns of one level depend only on columns of lower levels, which
replaces the TPU kernel's sequential grid. Without that grid the TPU's
segments, bucket padding, NOP pads and pool-end shift have no counterpart,
and the DIAG and TRSM jobs are the launches that clk runs (the TPU kernel
fused them only because its tile sat whole in VMEM).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..blocklu import level_order
from ..host.symbolic import SymbolicPlan
from ._build import CudaKernel, ptr, stream_ptr
from .clk import clk_trsm
from .diag_lu import CUDA_BLOCK_SIZES, diag_lu

_V = ctypes.c_void_p
_I = ctypes.c_int
UPDATE = CudaKernel("tck_update", "tck.cu", {
    "slu_tck_update_f32": [_V] * 8 + [_I] * 4 + [_V]})

MC = 8            # L blocks per GEMM chunk (the TPU kernel's MC)
TC = 8            # L blocks per TRSM job in the job count (its TC)
TN = 16           # scalar columns per CTA strip (csrc/tck.cu)
#: shared memory a CTA gives its tile and its B strip (csrc/tck.cu)
TILE_SMEM = 200 * 1024

#: codes of a GEMM job's B position for a source outside the tile: load
#: its U block from the pool, or reuse the strip that the previous chunk
#: of the same source loaded
B_LOAD, B_REUSE = -1, -2


def tile_rows(bs: int) -> int:
    """The tile height (block rows) of the CUDA kernel at block size
    ``bs``: the tile and one B strip of ``bs x TN`` floats fill
    ``TILE_SMEM`` (24 at bs 128, 49 at 64, 99 at 32)."""
    return max(1, TILE_SMEM // (bs * TN * 4) - 1)


@dataclasses.dataclass
class TckTapes:
    """Per-level schedule of the tck factor. ``*ptr`` and ``hmax`` are
    host int64 arrays; every other field is an int32 tensor on the device.

    - update: level l's columns are ``cptr[l]:cptr[l+1]`` of ``cbase``
      (first slot of the column) and ``ctile`` (column c's tiles are
      ``ctile[c]:ctile[c+1]``); a tile row of ``tiles`` is (first position,
      rows, GEMM jobs g0, g1, FINU jobs f0, f1); a row of ``gjobs`` is
      (first L slot a0, L blocks m, B position in the tile or ``B_LOAD`` /
      ``B_REUSE``, B slot, source step j, finalize-in-place flag, offset of
      its m target positions in ``dst``); a row of ``fjobs`` is (position
      in the tile, source step j). ``hmax[l]`` is the tallest tile of
      level l, which sizes the launch's shared memory;
    - diag: ``dslot``/``dstep`` over ``dptr``;
    - trsm (``clk.clk_trsm``): ``lslot``/``lstep`` over ``lptr``.
    """

    nlvl: int
    w: int
    cptr: np.ndarray
    hmax: np.ndarray
    cbase: torch.Tensor
    ctile: torch.Tensor
    tiles: torch.Tensor
    gjobs: torch.Tensor
    dst: torch.Tensor
    fjobs: torch.Tensor
    dptr: np.ndarray
    dslot: torch.Tensor
    dstep: torch.Tensor
    lptr: np.ndarray
    lslot: torch.Tensor
    lstep: torch.Tensor
    # host copies for the plain version and for work counts, and the job
    # counts of the TPU kernel's stream ("counts")
    host: dict


def build_tck_tapes(plan: SymbolicPlan, device, w: int | None = None,
                    mc: int = MC) -> TckTapes:
    """Host tapes from the column-major slot order, with tiles of ``w``
    block rows (``tile_rows(plan.bs)`` when None) and GEMM chunks of up to
    ``mc`` L blocks; raises ValueError if the exact-LU fill closure does
    not hold (an ILU plan)."""
    nb = plan.nb
    w = tile_rows(plan.bs) if w is None else int(w)
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
    # order; one entry per L block m of column j, i.e. per product
    # L(i, j)·U(j, k) into position pos of column k
    pair0 = np.concatenate([[0], np.cumsum(dpos)])   # first pair of each k
    npair = int(pair0[-1])
    p_col = np.repeat(np.arange(nb), dpos)
    p_t = np.arange(npair) - pair0[p_col]
    p_src = srow[colptr[p_col] + p_t]
    p_lm = lm[p_src]
    nd = int(p_lm.sum())
    d_pair = np.repeat(np.arange(npair), p_lm)
    d_m = np.arange(nd) - np.repeat(np.concatenate(
        [[0], np.cumsum(p_lm)[:-1]]), p_lm)
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

    # GEMM jobs: products ordered by (column, tile of the target, source,
    # L block); a run of one source in one tile is cut into chunks of mc
    d_tile = d_pos // w
    o = np.lexsort((d_m, d_t, d_tile, d_col))
    d_col, d_t, d_src, d_m, d_pos, d_tile = (a[o] for a in (
        d_col, d_t, d_src, d_m, d_pos, d_tile))
    new_run = np.ones(nd, dtype=bool)
    if nd:
        new_run[1:] = ((d_col[1:] != d_col[:-1]) | (d_tile[1:] != d_tile[:-1])
                       | (d_t[1:] != d_t[:-1]))
    run_start = np.flatnonzero(new_run)
    in_run = np.arange(nd) - np.repeat(run_start, np.diff(
        np.r_[run_start, nd]))
    job_start = np.flatnonzero(in_run % mc == 0)
    g_m = np.diff(np.r_[job_start, nd])
    g_col, g_t, g_src, g_tile = (a[job_start] for a in (
        d_col, d_t, d_src, d_tile))
    g_first = in_run[job_start] == 0           # the run's first chunk
    g_in = g_t // w == g_tile                  # the source sits in the tile
    g_bpos = np.where(g_in, g_t - g_tile * w,
                      np.where(g_first, B_LOAD, B_REUSE))
    gjobs = np.stack([la0[g_src] + d_m[job_start], g_m, g_bpos,
                      colptr[g_col] + g_t, g_src, g_in & g_first, job_start],
                     axis=1)
    dst = d_pos - d_tile * w                   # position within the tile

    # FINU jobs: the U blocks that are not a source inside their own tile
    fin = np.zeros(npair, dtype=bool)
    first_in = job_start[g_in & g_first]
    fin[pair0[d_col[first_in]] + d_t[first_in]] = True
    f_col, f_t, f_src = p_col[~fin], p_t[~fin], p_src[~fin]
    f_tile = f_t // w                          # already in (k, t) order
    fjobs = np.stack([f_t - f_tile * w, f_src], axis=1)

    # tiles of the columns with U blocks, columns in level order
    lev = np.asarray(plan.step_level)
    ucols = np.argsort(lev * nb + np.arange(nb), kind="stable")
    ucols = ucols[dpos[ucols] > 0]
    ntile = -(-ncol // w)
    ctile = np.zeros(len(ucols) + 1, dtype=np.int64)
    ctile[1:] = np.cumsum(ntile[ucols])
    t_col = np.repeat(ucols, ntile[ucols])
    t_i = np.arange(int(ctile[-1])) - np.repeat(ctile[:-1], ntile[ucols])
    t_p0 = t_i * w
    t_len = np.minimum(w, ncol[t_col] - t_p0)
    gkey = g_col * nb + g_tile                 # jobs sorted by (col, tile)
    fkey = f_col * nb + f_tile
    tk = t_col * nb + t_i
    tiles = np.stack([t_p0, t_len, np.searchsorted(gkey, tk),
                      np.searchsorted(gkey, tk, side="right"),
                      np.searchsorted(fkey, tk),
                      np.searchsorted(fkey, tk, side="right")], axis=1)
    nlvl = plan.n_flevels
    cptr = np.zeros(nlvl + 1, dtype=np.int64)
    cptr[1:] = np.cumsum(np.bincount(lev[ucols], minlength=nlvl))
    hmax = np.zeros(nlvl, dtype=np.int64)
    np.maximum.at(hmax, lev[ucols], np.minimum(w, ncol[ucols]))

    # the TPU kernel's job stream, counted by type (no NOP pads)
    all_i = np.arange(int(ntile.sum())) - np.repeat(
        np.concatenate([[0], np.cumsum(ntile)[:-1]]), ntile)
    all_col = np.repeat(np.arange(nb), ntile)
    lo = np.maximum(all_i * w, dpos[all_col] + 1)
    hi = np.minimum(all_i * w + w, ncol[all_col])
    counts = dict(gemm=len(g_m), finu=int((~fin).sum()), diag=nb,
                  trsm=int((-(-np.maximum(hi - lo, 0) // TC)).sum()),
                  tiles=int(ntile.sum()))

    lvo = level_order(plan)
    dstep = lvo["dstep"]
    host = dict(cbase=colptr[ucols], ctile=ctile, tiles=tiles, gjobs=gjobs,
                dst=dst, fjobs=fjobs, dslot=diag_slot[dstep], dstep=dstep,
                lslot=lvo["l_slot"], lstep=lvo["l_step"], counts=counts)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32),
                               device=device)

    return TckTapes(
        nlvl=nlvl, w=w, cptr=cptr, hmax=hmax,
        **{k: dev(host[k]) for k in ("cbase", "ctile", "tiles", "gjobs",
                                     "dst", "fjobs", "dslot", "dstep",
                                     "lslot", "lstep")},
        dptr=np.asarray(lvo["dptr"]), lptr=np.asarray(lvo["lptr"]),
        host=host)


# ---------------------------------------------------------------------------
# phase 1: the tiled left-looking update
# ---------------------------------------------------------------------------


def tck_update_plain(pool, linv, tp: TckTapes, level: int) -> None:
    """Plain version of :func:`tck_update`: the same jobs in the same
    order, on the pool's blocks (the tile is the kernel's cache)."""
    h = tp.host
    dev = pool.device
    for c in range(int(tp.cptr[level]), int(tp.cptr[level + 1])):
        base = int(h["cbase"][c])
        for p0, _, g0, g1, f0, f1 in h["tiles"][h["ctile"][c]:
                                                h["ctile"][c + 1]]:
            t0 = base + int(p0)
            for a0, m, bpos, bslot, src, fin, d0 in h["gjobs"][g0:g1]:
                if bpos >= 0:
                    s = t0 + int(bpos)
                    if fin:
                        pool[s] = linv[int(src)] @ pool[s]
                else:
                    s = int(bslot)
                tgt = torch.as_tensor(t0 + h["dst"][d0:d0 + m], device=dev)
                pool.index_add_(0, tgt, pool[a0:a0 + m] @ pool[s], alpha=-1)
            for pos, src in h["fjobs"][f0:f1]:
                s = t0 + int(pos)
                pool[s] = linv[int(src)] @ pool[s]


def tck_update(pool, linv, tp: TckTapes, level: int) -> None:
    """Tiled left-looking update of the columns of ``level`` (in place)."""
    if pool.device.type == "cpu":
        return tck_update_plain(pool, linv, tp, level)
    _check_cuda(pool, linv, pool.shape[-1], tp.w)
    lo, hi = int(tp.cptr[level]), int(tp.cptr[level + 1])
    if hi == lo:
        return
    UPDATE.launches += 1
    UPDATE.call("slu_tck_update_f32", ptr(pool), ptr(linv), ptr(tp.cbase),
                ptr(tp.ctile), ptr(tp.tiles), ptr(tp.gjobs), ptr(tp.dst),
                ptr(tp.fjobs), lo, hi - lo, int(tp.hmax[level]),
                pool.shape[-1], stream_ptr(pool.device))


def _check_cuda(pool, linv, bs, w):
    if pool.device.type != "cuda":
        raise ValueError(f"tck: unsupported device {pool.device}")
    for t in (pool, linv):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != pool.device or t.shape[-2:] != (bs, bs):
            raise ValueError("tck: pool and inverses must be contiguous "
                             "float32 (., bs, bs) tensors on one device")
    if bs not in CUDA_BLOCK_SIZES:
        raise ValueError(f"tck: block size {bs} not in {CUDA_BLOCK_SIZES}")
    if w > tile_rows(bs):
        raise ValueError(f"tck: tiles of {w} rows exceed the kernel's "
                         f"{tile_rows(bs)} at block size {bs}")


# ---------------------------------------------------------------------------
# the whole factor
# ---------------------------------------------------------------------------


def factor_level(pool, linv, uinv, tiny, thresh, tp: TckTapes,
                 level: int) -> None:
    """The three phases of one elimination level."""
    lo, hi = int(tp.dptr[level]), int(tp.dptr[level + 1])
    tck_update(pool, linv, tp, level)
    diag_lu(pool, linv, uinv, tp.dslot[lo:hi], tp.dstep[lo:hi], thresh, tiny)
    clk_trsm(pool, uinv, tp, level)


def factor(pool, thresh: float, tp: TckTapes, nb: int):
    """Factor ``pool`` in place. Returns (pool, linv, uinv, tiny) with
    linv/uinv of shape (nb, bs, bs) and tiny an int32 tensor (1,)."""
    bs = pool.shape[-1]
    linv = torch.zeros((nb, bs, bs), dtype=pool.dtype, device=pool.device)
    uinv = torch.zeros_like(linv)
    tiny = torch.zeros(1, dtype=torch.int32, device=pool.device)
    for level in range(tp.nlvl):
        factor_level(pool, linv, uinv, tiny, thresh, tp, level)
    return pool, linv, uinv, tiny
