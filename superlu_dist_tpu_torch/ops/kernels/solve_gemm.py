"""Kernels 9–10: the per-level solve GEMM and diagonal apply, each with a
transpose flag, and the two solves that run them (kernel 3's NOTRANS
solve and the transposed solve).

Counterpart of the JAX package's ``pallas_exec._solve_gemm_kernel`` and
``_diag_apply_kernel`` (``make_solve_gemm_call``/``make_diag_apply_call``,
driven by ``_pallas_solve_executor``), of its whole-sweep solve kernel
``_sweep_kernel`` (``build_solve_fn_pallas_fused``), and of the level loop
of ``blocklu._solve_core``. Per level, with op(M) = Mᵀ under
``transpose``:

- :func:`solve_gemm`: X[dst] −= op(pool[slot])·X[src] over the level's
  triples;
- :func:`diag_apply`: X[I] = op(dinv[I])·X[I] over the level's rows;
- :func:`solve_level`: both, X[I] = op(dinv[I])·(X[I] − Σ op(pool)·X[src]).

On the card (``csrc/solve_gemm.cu``) a level runs in two passes on one
stream: :func:`solve_chunks` (pass 1, one CTA per chunk of a
destination's chain, ``SweepTape.chunkptr``/``cptr``) writes each chunk's
sum into a scratch buffer, and :func:`solve_rows` (pass 2, one CTA per
row) subtracts a row's chunk sums in chunk order and applies the
diagonal. :func:`solve_level` is pass 1 and pass 2 with the diagonal;
:func:`solve_gemm` is pass 1 and pass 2 without it; :func:`diag_apply`
is pass 2 without partials.

The two solves share one host loop over the levels, which checks the
tensors once per solve and takes each level's arguments from
``SweepTape.launch_levels``:

- :func:`solve`, the NOTRANS solve (kernel 3): the L sweep with ``linv``,
  then the U sweep with ``uinv``, on the plan's tapes
  (``sweep.build_sweep_tape``), ``transpose=False``;
- :func:`solve_transposed`: the Uᵀ forward sweep with ``uinv`` and then
  the Lᵀ backward sweep with ``linv``, both transposed, on the tapes of
  :func:`build_trans_tape`, which keep the JAX package's level of every
  block row (``blocklu.trans_schedule``).

:func:`solve_batch` is the NOTRANS solve of every member of a stacked
batch (pools, inverses and right-hand sides stacked on a leading member
axis, one set of tapes): the same two passes per level through the
``_batch`` entries, the member on ``blockIdx.z``, one launch per pass per
level for all members, counted on SWEEP_BATCH.

Launch counters: with ``transpose=False`` both passes count on SWEEP
(kernel 3); with ``transpose=True`` pass 1 counts on SOLVE_GEMM and pass
2 on DIAG_APPLY; the standalone :func:`solve_gemm` counts both its passes
on SOLVE_GEMM and :func:`diag_apply` on DIAG_APPLY, whatever the flag.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..blocklu import trans_schedule
from ..host.symbolic import SymbolicPlan
from ._build import CudaKernel, ptr, stream_ptr
from .diag_lu import (CUDA_BLOCK_SIZES, CUDA_DTYPES, DTYPE_NAMES, at,
                      check_members, entry, member_chunks)
from .sweep import SweepTape, csr_tape

_V = ctypes.c_void_p
_I = ctypes.c_int
_ROWS = {f"slu_solve_rows_{s}": [_V] * 5 + [_I] * 6 + [_V]
         for s in CUDA_DTYPES.values()}
_CHUNKS = {f"slu_solve_gemm_{s}": [_V] * 6 + [_I] * 4 + [_V]
           for s in CUDA_DTYPES.values()}
SOLVE_GEMM = CudaKernel("solve_gemm", "solve_gemm.cu", {**_CHUNKS, **_ROWS})
DIAG_APPLY = CudaKernel("diag_apply", "solve_gemm.cu", _ROWS)
#: kernel 3, the NOTRANS sweep: both passes with ``transpose=False``
SWEEP = CudaKernel("sweep", "solve_gemm.cu", {**_CHUNKS, **_ROWS})
_LL = ctypes.c_longlong
#: kernel 3 over the members of a batch (``solve_batch``)
SWEEP_BATCH = CudaKernel("sweep_batch", "solve_gemm.cu", {
    **{f"slu_solve_gemm_batch_{s}": [_V] * 6 + [_I] * 5 + [_LL] * 3 + [_V]
       for s in CUDA_DTYPES.values()},
    **{f"slu_solve_rows_batch_{s}": [_V] * 5 + [_I] * 7 + [_LL] * 3 + [_V]
       for s in CUDA_DTYPES.values()}})


def build_trans_tape(plan: SymbolicPlan, which: str, device) -> SweepTape:
    """The Uᵀ (``which="U"``) or Lᵀ (``"L"``) sweep's levels as a CSR by
    destination in level order (the JAX package's
    ``make_trans_solve_tapes``, without bucket padding), its chains cut
    into chunks (``sweep.chunk_chains``)."""
    gptr, gslot, gsrc, gdst, dptr, diag, nlvl = trans_schedule(plan, which)
    return csr_tape(plan.nb, gslot, gsrc, gdst, dptr, diag, nlvl, device)


def _span(tape: SweepTape, level: int):
    lo, hi = int(tape.dptr[level]), int(tape.dptr[level + 1])
    rp = tape.host["rowptr"]
    return lo, hi, int(rp[lo]), int(rp[hi])


def solve_gemm_plain(pool, X, tape: SweepTape, level: int,
                     transpose: bool) -> None:
    """Plain version of :func:`solve_gemm`."""
    lo, hi, c0, c1 = _span(tape, level)
    if c1 == c0:
        return
    h, dev = tape.host, X.device
    cnt = np.diff(h["rowptr"][lo:hi + 1])
    dst = torch.as_tensor(np.repeat(h["rows"][lo:hi], cnt), device=dev)
    P = pool[torch.as_tensor(h["cslot"][c0:c1], device=dev)]
    if transpose:
        P = P.transpose(-1, -2)
    src = torch.as_tensor(h["csrc"][c0:c1], device=dev)
    X.index_add_(0, dst, P @ X[src], alpha=-1)


def diag_apply_plain(dinv, X, tape: SweepTape, level: int,
                     transpose: bool) -> None:
    """Plain version of :func:`diag_apply`."""
    lo, hi, _, _ = _span(tape, level)
    if hi == lo:
        return
    r = torch.as_tensor(tape.host["rows"][lo:hi], device=X.device)
    D = dinv[r]
    X[r] = (D.mT if transpose else D) @ X[r]


def solve_level_plain(pool, dinv, X, tape: SweepTape, level: int,
                      transpose: bool) -> None:
    """Plain version of :func:`solve_level`: the two plain phases."""
    solve_gemm_plain(pool, X, tape, level, transpose)
    diag_apply_plain(dinv, X, tape, level, transpose)


def solve_chunks(pool, X, tape: SweepTape, level: int, transpose: bool,
                 kernel: CudaKernel = SOLVE_GEMM):
    """Pass 1 on the card: each chunk's sum Σ op(pool[slot])·X[src] of
    ``level`` into the tape's scratch buffer, which it returns (None for a
    level without products). Counts one launch on ``kernel``."""
    q0, q1 = int(tape.qptr[level]), int(tape.qptr[level + 1])
    if q1 == q0:
        return None
    P = _scratch(tape, X)
    fn = entry("solve_gemm", X)
    kernel.count(fn)
    kernel.call(fn, ptr(pool), ptr(X), ptr(P), ptr(tape.cptr[q0:q1 + 1]),
                ptr(tape.cslot), ptr(tape.csrc), q1 - q0, pool.shape[-1],
                X.shape[2], int(transpose), stream_ptr(X.device))
    return P


def solve_rows(dinv, X, P, tape: SweepTape, level: int, transpose: bool,
               kernel: CudaKernel = DIAG_APPLY) -> None:
    """Pass 2 on the card, for the rows I of ``level``: X[I] −= the sums of
    I's chunks in ``P`` (from :func:`solve_chunks`; None for none), then
    X[I] = op(dinv[I])·X[I] unless ``dinv`` is None. Counts one launch on
    ``kernel``."""
    lo, hi, _, _ = _span(tape, level)
    if hi == lo:
        return
    bs = X.shape[1]
    fn = entry("solve_rows", X)
    kernel.count(fn)
    kernel.call(fn, None if dinv is None else ptr(dinv), ptr(X),
                None if P is None else ptr(P), ptr(tape.rows[lo:hi]),
                None if P is None else ptr(tape.chunkptr[lo:hi + 1]),
                int(tape.qptr[level]), hi - lo, bs, X.shape[2],
                int(transpose), int(dinv is not None), stream_ptr(X.device))


def solve_gemm(pool, X, tape: SweepTape, level: int, transpose: bool) -> None:
    """In place on ``X`` (nb, bs, nrhs): X[dst] −= op(pool[slot])·X[src]
    for the contributions into the block rows of ``level``."""
    if X.device.type == "cpu":
        return solve_gemm_plain(pool, X, tape, level, transpose)
    _check_cuda("solve_gemm", pool, X)
    P = solve_chunks(pool, X, tape, level, transpose)
    if P is not None:
        solve_rows(None, X, P, tape, level, transpose, kernel=SOLVE_GEMM)


def diag_apply(dinv, X, tape: SweepTape, level: int, transpose: bool) -> None:
    """In place on ``X``: X[I] = op(dinv[I])·X[I] for the block rows I of
    ``level``."""
    if X.device.type == "cpu":
        return diag_apply_plain(dinv, X, tape, level, transpose)
    _check_cuda("diag_apply", dinv, X)
    solve_rows(dinv, X, None, tape, level, transpose)


def solve_level(pool, dinv, X, tape: SweepTape, level: int,
                transpose: bool) -> None:
    """One level of a sweep in place on ``X`` (nb, bs, nrhs):
    X[I] = op(dinv[I])·(X[I] − Σ op(pool[slot])·X[src]) for the block rows
    I of ``level``."""
    if X.device.type == "cpu":
        return solve_level_plain(pool, dinv, X, tape, level, transpose)
    _check_cuda("solve_level", pool, X)
    _check_cuda("solve_level", dinv, X)
    k1, k2 = _counters(transpose)
    P = solve_chunks(pool, X, tape, level, transpose, k1)
    solve_rows(dinv, X, P, tape, level, transpose, k2)


def solve(pool, linv, uinv, tl: SweepTape, tu: SweepTape, X):
    """The NOTRANS solve A3·y = b in place on ``X`` (nb, bs, nrhs): the L
    sweep with ``linv`` on ``tl``, then the U sweep with ``uinv`` on
    ``tu``, each level by the two passes of :func:`solve_level` with
    ``transpose=False`` (counted on SWEEP). Returns X."""
    return _solve(pool, ((tl, linv), (tu, uinv)), X, False)


def solve_transposed(pool, uinv, linv, tu: SweepTape, tl: SweepTape, X):
    """A3ᵀ·y = b in place on ``X`` (nb, bs, nrhs): the Uᵀ forward sweep
    with ``uinv`` on ``tu``, then the Lᵀ backward sweep with ``linv`` on
    ``tl`` (the argument order of the JAX package's
    ``build_trans_solve_fn``). Returns X."""
    return _solve(pool, ((tu, uinv), (tl, linv)), X, True)


def _counters(transpose: bool):
    """The launch counters of (pass 1, pass 2) of :func:`solve_level`."""
    return (SOLVE_GEMM, DIAG_APPLY) if transpose else (SWEEP, SWEEP)


def _solve(pool, sweeps, X, transpose: bool):
    """Every level of each (tape, dinv) of ``sweeps`` in turn, in place on
    X: the plain levels on the CPU; on the card the tensors are checked
    once and each level's two launches take their arguments from
    ``SweepTape.launch_levels``."""
    if X.device.type == "cpu":
        for tape, dinv in sweeps:
            for level in range(tape.nlvl):
                solve_level_plain(pool, dinv, X, tape, level, transpose)
        return X
    what = "solve_transposed" if transpose else "solve"
    _check_cuda(what, pool, X)
    for _, dinv in sweeps:
        _check_cuda(what, dinv, X)
    k1, k2 = _counters(transpose)
    n1, n2 = entry("solve_gemm", X), entry("solve_rows", X)
    f1, f2 = k1.fn(n1), k2.fn(n2)
    bs, nrhs, tr = X.shape[1], X.shape[2], int(transpose)
    stream = stream_ptr(X.device)
    pp, xp = pool.data_ptr(), X.data_ptr()
    for tape, dinv in sweeps:
        P = _scratch(tape, X).data_ptr()
        dp, cs, cr = dinv.data_ptr(), tape.cslot.data_ptr(), \
            tape.csrc.data_ptr()
        for cp, nq, rows, chp, q0, nr in tape.launch_levels():
            if nq:
                k1.count(n1)
                k1.check(n1, f1(pp, xp, P, cp, cs, cr, nq, bs, nrhs, tr,
                                stream))
            if nr:
                k2.count(n2)
                k2.check(n2, f2(dp, xp, P if nq else None, rows,
                                chp if nq else None, q0, nr, bs, nrhs, tr,
                                1, stream))
    return X


def _scratch(tape: SweepTape, X):
    """The tape's buffer of chunk sums for X's dtype, width and device:
    (most chunks of one level, bs, nrhs), made once."""
    key = (X.dtype, X.shape[2], X.device)
    P = tape.scratch.get(key)
    if P is None:
        P = tape.scratch[key] = torch.empty(
            (tape.max_chunks,) + tuple(X.shape[1:]), dtype=X.dtype,
            device=X.device)
    return P


def _check_cuda(what, blocks, X):
    bs = blocks.shape[-1]
    if X.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {X.device}")
    for t in (blocks, X):
        if t.dtype not in CUDA_DTYPES or t.dtype != X.dtype \
                or not t.is_contiguous() or t.device != X.device:
            raise ValueError(f"{what}: blocks and X must be contiguous "
                             f"tensors of one dtype ({DTYPE_NAMES}) on one "
                             "device")
    if blocks.shape[-2:] != (bs, bs) or X.dim() != 3 or X.shape[1] != bs:
        raise ValueError(f"{what}: shapes must be blocks (., bs, bs) and X "
                         "(nb, bs, nrhs)")
    if bs not in CUDA_BLOCK_SIZES:
        raise ValueError(f"{what}: block size {bs} not in "
                         f"{CUDA_BLOCK_SIZES}")
    if blocks.data_ptr() % 16:
        raise ValueError(f"{what}: the blocks must start on 16 bytes (the "
                         "kernels read them in 16-byte words)")


# ---------------------------------------------------------------------------
# the stacked form: the NOTRANS solve of every member of a batch
# ---------------------------------------------------------------------------


def solve_batch(pool, linv, uinv, tl: SweepTape, tu: SweepTape, X):
    """:func:`solve` on every member in place: ``pool`` (members, rows, bs,
    bs), ``linv``/``uinv`` (members, nb, bs, bs), ``X`` (members, nb, bs,
    nrhs), the tapes shared. On the card each level's two passes are one
    launch each (per chunk of members) for all members, each member
    computing bit for bit what :func:`solve` computes on it alone. Returns
    X."""
    for tape, dinv in ((tl, linv), (tu, uinv)):
        if X.device.type != "cpu":
            _check_batch(pool, dinv, X)
        for level in range(tape.nlvl):
            _level_batch(pool, dinv, X, tape, level)
    return X


def solve_level_batch(pool, dinv, X, tape: SweepTape, level: int) -> None:
    """One level of :func:`solve_batch`'s sweeps (:func:`solve_level` with
    ``transpose=False``) on every member, in place on X."""
    if X.device.type != "cpu":
        _check_batch(pool, dinv, X)
    _level_batch(pool, dinv, X, tape, level)


def _check_batch(pool, dinv, X):
    check_members(pool, dinv, X)
    _check_cuda("solve_batch", pool[0], X[0])
    _check_cuda("solve_batch", dinv[0], X[0])


def _level_batch(pool, dinv, X, tape: SweepTape, level: int) -> None:
    """Both passes of ``level`` on every member: the plain level member by
    member on the CPU; on the card one launch a pass per chunk of members
    (counted on SWEEP_BATCH)."""
    if X.device.type == "cpu":
        for m in range(X.shape[0]):
            solve_level_plain(pool[m], dinv[m], X[m], tape, level, False)
        return
    cp, nq, rows, chp, q0, nr = tape.launch_levels()[level]
    bs, nrhs = X.shape[2], X.shape[3]
    n1, n2 = entry("solve_gemm_batch", X), entry("solve_rows_batch", X)
    P = _scratch_batch(tape, X)
    ps, vs, xs, qs = (t[0].numel() for t in (pool, dinv, X, P))
    cs, cr = tape.cslot.data_ptr(), tape.csrc.data_ptr()
    stream = stream_ptr(X.device)
    for m0, cnt in member_chunks(X.shape[0]):
        xp, qp = at(X, m0 * xs), at(P, m0 * qs)
        if nq:
            SWEEP_BATCH.count(n1)
            SWEEP_BATCH.call(n1, at(pool, m0 * ps), xp, qp, cp, cs, cr, nq,
                             bs, nrhs, 0, cnt, ps, xs, qs, stream)
        if nr:
            SWEEP_BATCH.count(n2)
            SWEEP_BATCH.call(n2, at(dinv, m0 * vs), xp, qp if nq else None,
                             rows, chp if nq else None, q0, nr, bs, nrhs, 0,
                             1, cnt, vs, xs, qs, stream)


def _scratch_batch(tape: SweepTape, X):
    """The members' buffers of chunk sums (members, most chunks of one
    level, bs, nrhs), made once per (dtype, width, device, members)."""
    key = (X.dtype, X.shape[3], X.device, X.shape[0])
    P = tape.scratch.get(key)
    if P is None:
        P = tape.scratch[key] = torch.empty(
            (X.shape[0], max(tape.max_chunks, 1)) + tuple(X.shape[2:]),
            dtype=X.dtype, device=X.device)
    return P
