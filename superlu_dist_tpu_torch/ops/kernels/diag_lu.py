"""Kernel 1: no-pivot LU with inverses of the diagonal tiles.

``diag_lu`` factors a batch of diagonal blocks of the pool in place and
stores their triangular inverses: on a CUDA tensor through the
hand-written kernel ``csrc/diag_lu.cu``, on a CPU tensor through
:func:`lu_inv_plain`. Counterpart of the JAX package's
``flk._lu_tile_blocked`` / ``blocklu.block_lu_inv``.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import CudaKernel, ptr, stream_ptr

_V = ctypes.c_void_p
KERNEL = CudaKernel("diag_lu", "diag_lu.cu", {
    "slu_diag_lu_f32": [_V, _V, _V, _V, _V, ctypes.c_int, ctypes.c_int,
                        ctypes.c_float, _V, _V],
})

#: block sizes the CUDA kernels take (powers of two; the tile and one
#: inverse fill 128 KiB of shared memory at 128)
CUDA_BLOCK_SIZES = (32, 64, 128)


def lu_inv_plain(T: torch.Tensor, thresh: float):
    """Batched no-pivot LU with ReplaceTinyPivot (reference:
    pdgstrf2.c): ``T`` is (batch, bs, bs). A pivot with |p| < thresh
    becomes sign(p)·thresh, or +thresh at 0, and is counted.

    Returns (LU compact, L⁻¹, U⁻¹, tiny count as an int tensor)."""
    T = T.clone()
    nbat, m, _ = T.shape
    th = torch.tensor(thresh, dtype=T.dtype, device=T.device)
    tiny = torch.zeros((), dtype=torch.int64, device=T.device)
    for j in range(m):
        p = T[:, j, j]
        ap = p.abs()
        bad = ap < th
        p = torch.where(bad, torch.where(ap > 0, torch.copysign(th, p), th),
                        p)
        T[:, j, j] = p
        tiny += bad.sum()
        if j + 1 < m:
            lcol = T[:, j + 1:, j] / p[:, None]
            T[:, j + 1:, j] = lcol
            T[:, j + 1:, j + 1:] -= lcol[:, :, None] * T[:, j, None, j + 1:]
    eye = torch.eye(m, dtype=T.dtype, device=T.device).expand(nbat, m, m)
    L = torch.tril(T, -1) + eye
    U = torch.triu(T)
    linv = torch.linalg.solve_triangular(L, eye, upper=False,
                                         unitriangular=True)
    uinv = torch.linalg.solve_triangular(U, eye, upper=True)
    return T, linv, uinv, tiny


def diag_lu_plain(pool, linv, uinv, slots, steps, thresh, tiny):
    """Plain version of :func:`diag_lu` (same arguments, same effect)."""
    if len(slots) == 0:
        return
    LU, li, ui, nt = lu_inv_plain(pool[slots], thresh)
    pool[slots] = LU
    linv[steps] = li
    uinv[steps] = ui
    tiny += nt.to(tiny.dtype)


def diag_lu(pool, linv, uinv, slots, steps, thresh: float, tiny) -> None:
    """Factor ``pool[slots]`` in place; ``linv[steps]``, ``uinv[steps]``
    receive the inverses and ``tiny`` (int32, shape (1,)) the count of
    replaced pivots. ``slots``/``steps`` are int32 index tensors."""
    if pool.device.type == "cpu":
        return diag_lu_plain(pool, linv, uinv, slots, steps, thresh, tiny)
    _check_cuda(pool, linv, uinv, slots, steps, tiny, pool.shape[-1])
    _launch(pool, linv, uinv, slots, steps, thresh, tiny)


def _launch(pool, linv, uinv, slots, steps, thresh, tiny):
    if len(slots) == 0:
        return
    KERNEL.launches += 1
    KERNEL.call("slu_diag_lu_f32", ptr(pool), ptr(linv), ptr(uinv),
                ptr(slots), ptr(steps), len(slots), pool.shape[-1],
                float(thresh), ptr(tiny), stream_ptr(pool.device))


def _check_cuda(pool, linv, uinv, slots, steps, tiny, bs):
    if pool.device.type != "cuda":
        raise ValueError(f"diag_lu: unsupported device {pool.device}")
    for t in (pool, linv, uinv):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != pool.device or t.shape[-2:] != (bs, bs):
            raise ValueError("diag_lu: pool/linv/uinv must be contiguous "
                             "float32 (., bs, bs) tensors on one device")
    for t in (slots, steps):
        if t.dtype != torch.int32 or not t.is_contiguous() \
                or t.device != pool.device or t.shape != slots.shape:
            raise ValueError("diag_lu: slots/steps must be contiguous "
                             "int32 tensors of one length on the device")
    if tiny.dtype != torch.int32 or tiny.device != pool.device:
        raise ValueError("diag_lu: tiny must be an int32 device tensor")
    if bs not in CUDA_BLOCK_SIZES:
        raise ValueError(f"diag_lu: block size {bs} not in "
                         f"{CUDA_BLOCK_SIZES}")
