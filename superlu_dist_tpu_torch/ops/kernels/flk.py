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

On the card a group is one or two launches of ``csrc/chain.cuh``'s
staged chain product. Every chain is cut into chunks in plan order
(``sweep.chunk_chains``) of at most CHUNK_MAX products, fewer in a group
whose bands would not fill the card (:func:`group_chunk`); pass 1 (``slu_flk_chunks_f32``) runs one CTA per (chunk, band) and
finishes the targets of one chunk, pass 2 (``slu_flk_sum_f32``) adds the
chunks of the others in chunk order and finalizes them.

``precision`` is the pass precision of the chain's products and the
panel finalizes, as for clk (``clk.py``): ``"highest"`` runs them in IEEE
FP32 (``slu_flk_chunks_f32``, ``slu_flk_sum_f32``, counted on
``KERNEL``); ``"default"`` in one bf16 pass with float32 accumulation, as
the TPU kernel's ``dot`` at precision ``"default"`` (flk.py:439-441
there: the chain product and both panel finalizes), on the tensor cores
(``slu_flk_chunks_bf16``, ``slu_flk_sum_bf16``, counted on
``KERNEL_BF16``). Each product rounds both its blocks, and a finalize the
summed target and the inverse; pass 1's scratch rows and pass 2's sums
stay float32, and ``diag_lu`` is always full precision (flk.py:360-362
there). The plain versions round the same operands to bf16 and multiply
in float32, so they differ from the kernels only in the order of the
sums.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..blocklu import SCHUR_CHUNK, level_order, subtract_products
from ..host.symbolic import SymbolicPlan
from ._build import CudaKernel, ptr, stream_ptr
from .diag_lu import CUDA_BLOCK_SIZES, diag_lu
from .schur import check_precision, matmul_at
from .sweep import CHUNK_CTAS, chunk_chains

_V = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel("flk", "flk.cu", {
    "slu_flk_chunks_f32": [_V] * 12 + [_I, _I, _I, _V],
    "slu_flk_sum_f32": [_V] * 10 + [_I, _I, _I, _V]})
#: the same kernel's bf16 pass (precision "default"), counted apart
KERNEL_BF16 = CudaKernel("flk_bf16", "flk.cu", {
    "slu_flk_chunks_bf16": [_V] * 12 + [_I, _I, _I, _V],
    "slu_flk_sum_bf16": [_V] * 10 + [_I, _I, _I, _V]})
#: the kernel and the C entries (pass 1, pass 2) of each pass
_PASS = {"highest": (KERNEL, "slu_flk_chunks_f32", "slu_flk_sum_f32"),
         "default": (KERNEL_BF16, "slu_flk_chunks_bf16",
                     "slu_flk_sum_bf16")}

# finalize codes (the JAX package's values; FIN_DIAG is diag_lu)
FIN_NONE = 0
FIN_L = 2       # T ← T·uinv[step]
FIN_U = 3       # T ← linv[step]·T


@dataclasses.dataclass
class FlkTapes:
    """Per-level schedule of the flk factor. ``dptr``, ``tptr``,
    ``qptr``, ``mptr`` and ``nrow`` are host int64 arrays; every other
    field is an int32 tensor on the device.

    - diag_lu: ``dslot``/``dstep`` over ``dptr`` (every diagonal block);
    - flk_update: target group g = 2l is level l's diagonal targets that
      have contributions, g = 2l + 1 its L then U panels, over
      ``tptr[g]:tptr[g+1]`` of ``tslot``/``tstep``/``tfin``; target t
      sums ``pool[cl[p]]·pool[cu[p]]`` for p over ``cptr[t]:cptr[t+1]``
      (the plan's triples, stably sorted by target);
    - chunks: group g's are ``qptr[g]:qptr[g+1]``; chunk q of target
      ``qtgt[q]`` holds the products ``qcptr[q]:qcptr[q+1]`` (a target's
      chunks are consecutive and in plan order) and is summed into row
      ``qrow[q]`` of the group's scratch of ``nrow[g]`` rows, or, when
      its target has one chunk (``qrow[q]`` = -1), finishes the target;
      group g's targets of several chunks are ``mptr[g]:mptr[g+1]`` of
      ``mtgt``, each with its chunks in the ``mcnt`` scratch rows from
      ``mrow``.
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
    qptr: np.ndarray
    qtgt: torch.Tensor
    qrow: torch.Tensor
    qcptr: torch.Tensor
    nrow: np.ndarray
    mptr: np.ndarray
    mtgt: torch.Tensor
    mrow: torch.Tensor
    mcnt: torch.Tensor
    # host copies for the plain versions and for work counts
    host: dict


def band_ctas(bs: int) -> int:
    """CTAs per target in bands of 16, ``csrc/chain.cuh``'s geometry for a
    launch that would not fill the card (bs 32 takes the whole block)."""
    return bs // 16 if bs >= 64 else 1


def band_width(bs: int, count: int, sms: int) -> int:
    """The band width that ``csrc/chain.cuh`` takes for a launch over
    ``count`` targets (or chunks) on a card of ``sms`` SMs: bands of 64
    when they fill the SMs, else of 16; bs 32 the whole block (its rule,
    for reports)."""
    if bs < 64:
        return bs
    return 16 if count * (bs // 64) < sms else 64


#: the shared memory of each of two CTAs on one H100 SM
HALF_SM_SMEM = 113 * 1024


def chain_mma_bytes(bs: int, bm: int) -> int:
    """Shared memory of a CTA of ``csrc/passes.cuh``'s bf16 chain product
    (``ChainMma::kBytes``) in bands of ``bm`` at block size ``bs``: the
    FP32 chain's stages (3 in bands of 64, else 4), each the larger
    orientation's chunk (a bs x 32 or bm x 32 block of A in rows of 36
    floats, then 32 rows of B of bm or bs floats padded by 4), and the band
    as the finalize's operand, bm rows of bs + 4 floats."""
    stages = 3 if bm == 64 else 4
    stage = max(m * 36 + 32 * (n + 4) for m, n in ((bs, bm), (bm, bs)))
    return (stages * stage + bm * (bs + 4)) * 4


#: the longest chunk of the automatic cut: on an H100, chunks of 2 to 8
#: products on every group took 6.1–7.3 ms per lap3d32 factor and 38–42
#: on lap3d50, against 13.5–14.4 and 79–83 uncut (``tools/flk_ab.py``),
#: with no setting ahead in every run
CHUNK_MAX = 4


def group_chunk(ntgt: int, nprod: int, bs: int) -> int:
    """The chunk length of a group of ``ntgt`` targets and ``nprod``
    products: CHUNK_MAX, or, when the targets' bands of 16 would not fill
    CHUNK_CTAS (two CTAs per SM), the group's products in bands of 16
    over CHUNK_CTAS if that is shorter (at least 1)."""
    if ntgt * band_ctas(bs) >= CHUNK_CTAS:
        return CHUNK_MAX
    return min(CHUNK_MAX, max(1, nprod * band_ctas(bs) // CHUNK_CTAS))


def build_flk_tapes(plan: SymbolicPlan, device,
                    chunk: int | None = None) -> FlkTapes:
    """The flk schedule of ``plan``; ``chunk`` forces that chunk length on
    every group (None: :func:`group_chunk` per group)."""
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
    host.update(_chunk_tapes(cptr, tptr, plan.bs, chunk))
    hptr = {k: host.pop(k) for k in ("qptr", "nrow", "mptr")}

    def dev(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int32), device=device)

    return FlkTapes(nlvl=nlvl, dptr=np.asarray(lv["dptr"]),
                    tptr=tptr, host=host, **hptr,
                    **{k: dev(v) for k, v in host.items()
                       if k != "chunkptr"})


def _chunk_tapes(cptr, tptr, bs, chunk):
    """The chunk fields of :class:`FlkTapes`, and ``chunkptr`` (target
    t's chunks are ``chunkptr[t]:chunkptr[t+1]``)."""
    ngrp = len(tptr) - 1
    c = [chunk or group_chunk(hi - lo, cptr[hi] - cptr[lo], bs)
         for lo, hi in zip(tptr[:-1], tptr[1:])]
    chunkptr, qcptr, qptr = chunk_chains(cptr, tptr, c, empty=True)
    nk = np.diff(chunkptr)
    qtgt = np.repeat(np.arange(len(nk)), nk)
    # a chunk of a target of several takes its group's next scratch row
    split = (nk > 1)[qtgt]
    before = np.concatenate([[0], np.cumsum(split)])
    grp = np.repeat(np.arange(ngrp), np.diff(qptr))
    qrow = np.where(split, before[:-1] - before[qptr[grp]], -1)
    mtgt = np.flatnonzero(nk > 1)
    return dict(chunkptr=chunkptr, qptr=qptr, qtgt=qtgt, qrow=qrow,
                qcptr=qcptr, nrow=np.diff(before[qptr]),
                mptr=np.concatenate([[0], np.cumsum(nk > 1)])[tptr],
                mtgt=mtgt, mrow=qrow[chunkptr[mtgt]], mcnt=nk[mtgt])


def flk_update_plain(pool, linv, uinv, tp: FlkTapes, group: int,
                     precision: str = "highest") -> None:
    """Plain version of :func:`flk_update`."""
    check_precision(precision)
    h = tp.host
    lo, hi = int(tp.tptr[group]), int(tp.tptr[group + 1])
    if hi == lo:
        return
    c0, c1 = int(h["cptr"][lo]), int(h["cptr"][hi])
    tslot = h["tslot"][lo:hi]
    dst = np.repeat(tslot, np.diff(h["cptr"][lo:hi + 1]))
    subtract_products(pool, h["cl"][c0:c1], h["cu"][c0:c1], dst,
                      lambda a, b: matmul_at(a, b, precision))
    _finalize(pool, linv, uinv, h, np.arange(lo, hi), precision)


def flk_update_chunks_plain(pool, linv, uinv, tp: FlkTapes, group: int,
                            precision: str = "highest") -> None:
    """The two passes of :func:`flk_update` over the tapes' chunks in
    plain PyTorch (the CPU tests hold the chunk fields with it):
    :func:`passes_plain` with the group's finalizes; the products and
    finalizes at ``precision``."""
    h = tp.host
    passes_plain(pool, h, int(tp.qptr[group]), int(tp.qptr[group + 1]),
                 int(tp.mptr[group]), int(tp.mptr[group + 1]),
                 int(tp.nrow[group]), precision,
                 lambda tgt: _finalize(pool, linv, uinv, h, tgt, precision))


def passes_plain(pool, h, q0, q1, m0, m1, nrow, precision,
                 finalize=None) -> None:
    """The two passes over chunks ``q0:q1`` and pass-2 targets ``m0:m1``
    of the chunk fields in ``h`` (:class:`FlkTapes`' names) in plain
    PyTorch: pass 1 finishes the targets of one chunk and sums each chunk
    of the others, negated, into its row of ``nrow`` scratch rows; pass 2
    adds a target's rows in chunk order. ``finalize(targets)``, where
    given, finalizes each target when its sum is complete; the products
    at ``precision``."""
    check_precision(precision)
    if q1 == q0:
        return
    dev, bs = pool.device, pool.shape[-1]
    qs = np.arange(q0, q1)
    pq = np.repeat(qs, np.diff(h["qcptr"][q0:q1 + 1]))
    prods = np.arange(h["qcptr"][q0], h["qcptr"][q1])
    one = h["qrow"][pq] < 0
    subtract_products(pool, h["cl"][prods[one]], h["cu"][prods[one]],
                      h["tslot"][h["qtgt"][pq[one]]],
                      lambda a, b: matmul_at(a, b, precision))
    scratch = torch.zeros((nrow, bs, bs), dtype=pool.dtype, device=dev)
    for c in range(0, int((~one).sum()), SCHUR_CHUNK):
        p = prods[~one][c:c + SCHUR_CHUNK]
        scratch.index_add_(0, _idx(h["qrow"][pq[~one][c:c + SCHUR_CHUNK]],
                                   dev),
                           matmul_at(pool[_idx(h["cl"][p], dev)],
                                     pool[_idx(h["cu"][p], dev)], precision),
                           alpha=-1)
    if finalize is not None:
        finalize(h["qtgt"][qs[h["qrow"][qs] < 0]])
    if m1 == m0:
        return
    mt, cnt = h["mtgt"][m0:m1], h["mcnt"][m0:m1]
    for k in range(int(cnt.max())):   # chunk order
        has = cnt > k
        s = _idx(h["tslot"][mt[has]], dev)
        pool[s] += scratch[_idx(h["mrow"][m0:m1][has] + k, dev)]
    if finalize is not None:
        finalize(mt)


def _idx(a, device):
    return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)


def _finalize(pool, linv, uinv, h, tgt, precision="highest"):
    """T·uinv[step] (FIN_L) and linv[step]·T (FIN_U) for targets ``tgt``,
    at ``precision``."""
    for code in (FIN_L, FIN_U):
        t = tgt[h["tfin"][tgt] == code]
        if len(t):
            s = _idx(h["tslot"][t], pool.device)
            k = _idx(h["tstep"][t], pool.device)
            pool[s] = matmul_at(pool[s], uinv[k], precision) \
                if code == FIN_L else matmul_at(linv[k], pool[s], precision)


def flk_update(pool, linv, uinv, tp: FlkTapes, group: int,
               wide: int = -1, precision: str = "highest") -> None:
    """Accumulate and finalize the targets of ``group`` (in place), the
    products and finalizes at ``precision``. ``wide`` < 0 lets the kernel
    choose its bands (``csrc/chain.cuh``), 0 / 1 force bands of 16 / 64
    (``tools/flk_ab.py``)."""
    check_precision(precision)
    if pool.device.type == "cpu":
        return flk_update_plain(pool, linv, uinv, tp, group, precision)
    _check_cuda(pool, linv, uinv)
    q0, q1 = int(tp.qptr[group]), int(tp.qptr[group + 1])
    if q1 == q0:
        return
    bs, stream = pool.shape[-1], stream_ptr(pool.device)
    nrow = int(tp.nrow[group])
    scratch = torch.empty((nrow, bs, bs), dtype=pool.dtype,
                          device=pool.device) if nrow else None
    sp = ptr(scratch) if nrow else None
    kernel, chunks, sums = _PASS[precision]
    kernel.count(chunks)
    kernel.call(chunks, ptr(pool), ptr(linv), ptr(uinv), sp,
                ptr(tp.qtgt[q0:]), ptr(tp.qrow[q0:]), ptr(tp.qcptr[q0:]),
                ptr(tp.tslot), ptr(tp.tstep), ptr(tp.tfin), ptr(tp.cl),
                ptr(tp.cu), q1 - q0, bs, wide, stream)
    m0, m1 = int(tp.mptr[group]), int(tp.mptr[group + 1])
    if m1 > m0:
        kernel.count(sums)
        kernel.call(sums, ptr(pool), ptr(linv), ptr(uinv), sp,
                    ptr(tp.mtgt[m0:]), ptr(tp.mrow[m0:]), ptr(tp.mcnt[m0:]),
                    ptr(tp.tslot), ptr(tp.tstep), ptr(tp.tfin), m1 - m0, bs,
                    wide, stream)


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
                 level: int, precision: str = "highest") -> None:
    """The three phases of one elimination level; flk's products and
    finalizes at ``precision``, diag_lu in full precision."""
    lo, hi = int(tp.dptr[level]), int(tp.dptr[level + 1])
    flk_update(pool, linv, uinv, tp, 2 * level, precision=precision)
    diag_lu(pool, linv, uinv, tp.dslot[lo:hi], tp.dstep[lo:hi], thresh, tiny)
    flk_update(pool, linv, uinv, tp, 2 * level + 1, precision=precision)


def factor(pool, thresh: float, tp: FlkTapes, nb: int,
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
