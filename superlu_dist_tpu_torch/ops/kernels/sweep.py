"""Kernel 3: the level-set triangular sweeps of the solve.

Counterpart of the JAX package's whole-sweep solve kernel
(``pallas_exec._sweep_kernel`` through ``build_solve_fn_pallas_fused``)
and of the level loop of ``blocklu._solve_core``. One launch of
``csrc/sweep.cu`` per level per sweep (L, then U): every contribution
into block row I, and I's diagonal apply, sit in I's level, and every
source row is at a lower level (``ops/host/symbolic.py::_level_schedule``).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..host.symbolic import SymbolicPlan
from ._build import CudaKernel, ptr, stream_ptr
from .diag_lu import CUDA_BLOCK_SIZES, CUDA_DTYPES, entry

_V = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel("sweep", "sweep.cu", {
    f"slu_sweep_{s}": [_V] * 7 + [_I, _I, _I, _V] for s in ("f32", "f64")})


@dataclasses.dataclass
class SweepTape:
    """One sweep's levels: the block rows ``rows[dptr[l]:dptr[l+1]]`` of
    level l; row b's contributions are ``cslot``/``csrc`` over
    ``rowptr[b]:rowptr[b+1]`` (a CSR by destination, in level order).
    ``dptr`` is a host array, the rest int32 device tensors."""

    nlvl: int
    dptr: np.ndarray
    rows: torch.Tensor
    rowptr: torch.Tensor
    cslot: torch.Tensor
    csrc: torch.Tensor
    host: dict


def build_sweep_tape(plan: SymbolicPlan, which: str, device) -> SweepTape:
    p = plan
    if which == "L":
        gslot, gsrc, gdst = p.lsol_gslot, p.lsol_gsrc, p.lsol_gdst
        dptr, rows, nlvl = p.lsol_dptr, p.lsol_diag, p.lsol_nlvl
    else:
        gslot, gsrc, gdst = p.usol_gslot, p.usol_gsrc, p.usol_gdst
        dptr, rows, nlvl = p.usol_dptr, p.usol_diag, p.usol_nlvl
    return csr_tape(p.nb, gslot, gsrc, gdst, dptr, rows, nlvl, device)


def csr_tape(nb, gslot, gsrc, gdst, dptr, rows, nlvl, device) -> SweepTape:
    """A :class:`SweepTape` from a level schedule: the (slot, src, dst)
    triples, and the block rows ``rows[dptr[l]:dptr[l+1]]`` of level l."""
    rows = np.asarray(rows, dtype=np.int64)
    gdst = np.asarray(gdst, dtype=np.int64)
    # position of each block row in the level-ordered row list; sort the
    # contributions by it (stable: the plan's order within a row stays)
    where = np.empty(nb, dtype=np.int64)
    where[rows] = np.arange(len(rows))
    o = np.argsort(where[gdst], kind="stable")
    rowptr = np.zeros(len(rows) + 1, dtype=np.int64)
    rowptr[1:] = np.cumsum(np.bincount(where[gdst], minlength=len(rows)))
    host = dict(rows=rows, rowptr=rowptr,
                cslot=np.asarray(gslot, dtype=np.int64)[o],
                csrc=np.asarray(gsrc, dtype=np.int64)[o])

    def dev(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int32), device=device)

    return SweepTape(nlvl=int(nlvl), dptr=np.asarray(dptr, dtype=np.int64),
                     rows=dev(rows), rowptr=dev(rowptr),
                     cslot=dev(host["cslot"]), csrc=dev(host["csrc"]),
                     host=host)


def sweep_level_plain(pool, dinv, X, tape: SweepTape, level: int) -> None:
    """Plain version of :func:`sweep_level`."""
    h = tape.host
    lo, hi = int(tape.dptr[level]), int(tape.dptr[level + 1])
    if hi == lo:
        return
    c0, c1 = int(h["rowptr"][lo]), int(h["rowptr"][hi])
    dev = X.device
    if c1 > c0:
        cnt = np.diff(h["rowptr"][lo:hi + 1])
        dst = torch.as_tensor(np.repeat(h["rows"][lo:hi], cnt), device=dev)
        sl = torch.as_tensor(h["cslot"][c0:c1], device=dev)
        src = torch.as_tensor(h["csrc"][c0:c1], device=dev)
        X.index_add_(0, dst, pool[sl] @ X[src], alpha=-1)
    r = torch.as_tensor(h["rows"][lo:hi], device=dev)
    X[r] = dinv[r] @ X[r]


def sweep_level(pool, dinv, X, tape: SweepTape, level: int) -> None:
    """One level of a sweep, in place on ``X`` (nb, bs, nrhs):
    X[I] = dinv[I]·(X[I] − Σ pool[slot]·X[src]) for the level's rows."""
    if X.device.type == "cpu":
        return sweep_level_plain(pool, dinv, X, tape, level)
    _check_cuda(pool, dinv, X, pool.shape[-1])
    _launch(pool, dinv, X, tape, level)


def _launch(pool, dinv, X, tape: SweepTape, level: int) -> None:
    lo, hi = int(tape.dptr[level]), int(tape.dptr[level + 1])
    if hi == lo:
        return
    KERNEL.launches += 1
    KERNEL.call(entry("sweep", X), ptr(pool), ptr(dinv), ptr(X),
                ptr(tape.rows[lo:hi]), ptr(tape.rowptr[lo:hi + 1]),
                ptr(tape.cslot), ptr(tape.csrc), hi - lo, pool.shape[-1],
                X.shape[2], stream_ptr(X.device))


def solve(pool, linv, uinv, tl: SweepTape, tu: SweepTape, X):
    """L then U sweep of ``X`` (nb, bs, nrhs) in place; returns X."""
    for level in range(tl.nlvl):
        sweep_level(pool, linv, X, tl, level)
    for level in range(tu.nlvl):
        sweep_level(pool, uinv, X, tu, level)
    return X


def _check_cuda(pool, dinv, X, bs):
    if X.device.type != "cuda":
        raise ValueError(f"sweep: unsupported device {X.device}")
    for t in (pool, dinv, X):
        if t.dtype not in CUDA_DTYPES or t.dtype != X.dtype \
                or not t.is_contiguous() or t.device != X.device:
            raise ValueError("sweep: pool, dinv and X must be contiguous "
                             "tensors of one dtype (float32 or float64) on "
                             "one device")
    if pool.shape[-2:] != (bs, bs) or dinv.shape[-2:] != (bs, bs) \
            or X.dim() != 3 or X.shape[1] != bs:
        raise ValueError("sweep: shapes must be pool/dinv (., bs, bs) and "
                         "X (nb, bs, nrhs)")
    if bs not in CUDA_BLOCK_SIZES:
        raise ValueError(f"sweep: block size {bs} not in {CUDA_BLOCK_SIZES}")
