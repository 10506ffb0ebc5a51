"""Kernels 9–10: the per-level solve GEMM and diagonal apply, each with a
transpose flag, and the transposed solve that runs them.

Counterpart of the JAX package's ``pallas_exec._solve_gemm_kernel`` and
``_diag_apply_kernel`` (``make_solve_gemm_call``/``make_diag_apply_call``,
driven by ``_pallas_solve_executor``) and of the level loop of
``blocklu._solve_core(transpose=True)``, which is the JAX package's
transposed solve. Per level, on one stream (``csrc/solve_gemm.cu``):

1. :func:`solve_gemm`: X[dst] −= op(pool[slot])·X[src] over the level's
   triples, grouped by destination (one CTA sums a row's products);
2. :func:`diag_apply`: X[I] = op(dinv[I])·X[I] over the level's rows;

with op(M) = Mᵀ under ``transpose``. :func:`solve_transposed` runs the Uᵀ
forward sweep with ``uinv`` and then the Lᵀ backward sweep with ``linv``
(both transposed) on the tapes of :func:`build_trans_tape`, which keep the
JAX package's level of every block row (``blocklu.trans_schedule``). With
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
SOLVE_GEMM = CudaKernel("solve_gemm", "solve_gemm.cu", {
    f"slu_solve_gemm_{s}": [_V] * 6 + [_I] * 4 + [_V]
    for s in ("f32", "f64")})
DIAG_APPLY = CudaKernel("diag_apply", "solve_gemm.cu", {
    f"slu_diag_apply_{s}": [_V] * 3 + [_I] * 4 + [_V]
    for s in ("f32", "f64")})


def build_trans_tape(plan: SymbolicPlan, which: str, device) -> SweepTape:
    """The Uᵀ (``which="U"``) or Lᵀ (``"L"``) sweep's levels as a CSR by
    destination in level order (the JAX package's
    ``make_trans_solve_tapes``, without bucket padding)."""
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


def solve_gemm(pool, X, tape: SweepTape, level: int, transpose: bool) -> None:
    """In place on ``X`` (nb, bs, nrhs): X[dst] −= op(pool[slot])·X[src]
    for the contributions into the block rows of ``level``."""
    if X.device.type == "cpu":
        return solve_gemm_plain(pool, X, tape, level, transpose)
    _check_cuda("solve_gemm", pool, X)
    lo, hi, c0, c1 = _span(tape, level)
    if c1 == c0:
        return
    SOLVE_GEMM.launches += 1
    SOLVE_GEMM.call(entry("solve_gemm", X), ptr(pool), ptr(X),
                    ptr(tape.rows[lo:hi]), ptr(tape.rowptr[lo:hi + 1]),
                    ptr(tape.cslot), ptr(tape.csrc), hi - lo, pool.shape[-1],
                    X.shape[2], int(transpose), stream_ptr(X.device))


def diag_apply_plain(dinv, X, tape: SweepTape, level: int,
                     transpose: bool) -> None:
    """Plain version of :func:`diag_apply`."""
    lo, hi, _, _ = _span(tape, level)
    if hi == lo:
        return
    r = torch.as_tensor(tape.host["rows"][lo:hi], device=X.device)
    D = dinv[r]
    X[r] = (D.mT if transpose else D) @ X[r]


def diag_apply(dinv, X, tape: SweepTape, level: int, transpose: bool) -> None:
    """In place on ``X``: X[I] = op(dinv[I])·X[I] for the block rows I of
    ``level``."""
    if X.device.type == "cpu":
        return diag_apply_plain(dinv, X, tape, level, transpose)
    _check_cuda("diag_apply", dinv, X)
    lo, hi, _, _ = _span(tape, level)
    if hi == lo:
        return
    DIAG_APPLY.launches += 1
    DIAG_APPLY.call(entry("diag_apply", X), ptr(dinv), ptr(X),
                    ptr(tape.rows[lo:hi]), hi - lo, dinv.shape[-1],
                    X.shape[2], int(transpose), stream_ptr(X.device))


def solve_transposed(pool, uinv, linv, tu: SweepTape, tl: SweepTape, X):
    """A3ᵀ·y = b in place on ``X`` (nb, bs, nrhs): the Uᵀ forward sweep
    with ``uinv`` on ``tu``, then the Lᵀ backward sweep with ``linv`` on
    ``tl`` (the argument order of the JAX package's
    ``build_trans_solve_fn``). Returns X."""
    for tape, dinv in ((tu, uinv), (tl, linv)):
        for level in range(tape.nlvl):
            solve_gemm(pool, X, tape, level, True)
            diag_apply(dinv, X, tape, level, True)
    return X


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
