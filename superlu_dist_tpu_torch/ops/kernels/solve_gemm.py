"""Kernels 9–10: the per-level solve GEMM and diagonal apply, each with a
transpose flag, and the transposed solve that runs them.

Counterpart of the JAX package's ``pallas_exec._solve_gemm_kernel`` and
``_diag_apply_kernel`` (``make_solve_gemm_call``/``make_diag_apply_call``,
driven by ``_pallas_solve_executor``) and of the level loop of
``blocklu._solve_core(transpose=True)``, which is the JAX package's
transposed solve. Per level, with op(M) = Mᵀ under ``transpose``:

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
is pass 2 without partials. SOLVE_GEMM counts the launches of pass 1 and
of solve_gemm's pass 2, DIAG_APPLY those of the other pass 2 launches.

:func:`solve_transposed` runs :func:`solve_level` over the Uᵀ forward
sweep with ``uinv`` and then the Lᵀ backward sweep with ``linv`` (both
transposed) on the tapes of :func:`build_trans_tape`, which keep the JAX
package's level of every block row (``blocklu.trans_schedule``). With
``transpose=False`` on the plan's L and U tapes the two phases compose to
the NOTRANS sweep of ``sweep.py``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..blocklu import trans_schedule
from ..host.symbolic import SymbolicPlan
from ._build import CudaKernel, ptr, stream_ptr
from .diag_lu import CUDA_BLOCK_SIZES, CUDA_DTYPES, entry
from .sweep import SweepTape, csr_tape

_V = ctypes.c_void_p
_I = ctypes.c_int
_ROWS = {f"slu_solve_rows_{s}": [_V] * 5 + [_I] * 6 + [_V]
         for s in ("f32", "f64")}
SOLVE_GEMM = CudaKernel("solve_gemm", "solve_gemm.cu", {
    **{f"slu_solve_gemm_{s}": [_V] * 6 + [_I] * 4 + [_V]
       for s in ("f32", "f64")}, **_ROWS})
DIAG_APPLY = CudaKernel("diag_apply", "solve_gemm.cu", _ROWS)


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


def solve_chunks(pool, X, tape: SweepTape, level: int, transpose: bool):
    """Pass 1 on the card: each chunk's sum Σ op(pool[slot])·X[src] of
    ``level`` into the tape's scratch buffer, which it returns (None for a
    level without products). Counts one launch on SOLVE_GEMM."""
    q0, q1 = int(tape.qptr[level]), int(tape.qptr[level + 1])
    if q1 == q0:
        return None
    P = _scratch(tape, X)
    fn = entry("solve_gemm", X)
    SOLVE_GEMM.count(fn)
    SOLVE_GEMM.call(fn, ptr(pool), ptr(X), ptr(P),
                    ptr(tape.cptr[q0:q1 + 1]), ptr(tape.cslot),
                    ptr(tape.csrc), q1 - q0, pool.shape[-1], X.shape[2],
                    int(transpose), stream_ptr(X.device))
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
    P = solve_chunks(pool, X, tape, level, transpose)
    solve_rows(dinv, X, P, tape, level, transpose)


def solve_transposed(pool, uinv, linv, tu: SweepTape, tl: SweepTape, X):
    """A3ᵀ·y = b in place on ``X`` (nb, bs, nrhs): the Uᵀ forward sweep
    with ``uinv`` on ``tu``, then the Lᵀ backward sweep with ``linv`` on
    ``tl`` (the argument order of the JAX package's
    ``build_trans_solve_fn``). Returns X."""
    for tape, dinv in ((tu, uinv), (tl, linv)):
        for level in range(tape.nlvl):
            solve_level(pool, dinv, X, tape, level, True)
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
                             "tensors of one dtype (float32 or float64) on "
                             "one device")
    if blocks.shape[-2:] != (bs, bs) or X.dim() != 3 or X.shape[1] != bs:
        raise ValueError(f"{what}: shapes must be blocks (., bs, bs) and X "
                         "(nb, bs, nrhs)")
    if bs not in CUDA_BLOCK_SIZES:
        raise ValueError(f"{what}: block size {bs} not in "
                         f"{CUDA_BLOCK_SIZES}")
    if blocks.data_ptr() % 16:
        raise ValueError(f"{what}: the blocks must start on 16 bytes (the "
                         "kernels read them in 16-byte words)")
