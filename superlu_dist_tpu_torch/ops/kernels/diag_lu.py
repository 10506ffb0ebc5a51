"""Kernel 1: no-pivot LU with inverses of the diagonal tiles.

``diag_lu`` factors a batch of diagonal blocks of the pool in place and
stores their triangular inverses: on a CUDA tensor through the
hand-written kernel ``csrc/diag_lu.cu`` (float32, float64, complex64 or
complex128), on a CPU tensor through :func:`lu_inv_plain`. Counterpart of
the JAX package's ``flk._lu_tile_blocked`` / ``blocklu.block_lu_inv``.
A complex tiny pivot keeps its phase and the threshold stays real.
:func:`diag_lu_batch` does the same on every member of a stacked pool in
one launch (the ``_batch`` entries, the member on ``blockIdx.z``).
"""

from __future__ import annotations

import ctypes

import torch

from ._build import CudaKernel, ptr, stream_ptr

_V = ctypes.c_void_p
#: the threshold's C type of each entry (the real type of the element)
_THRESH = {"f32": ctypes.c_float, "f64": ctypes.c_double,
           "c64": ctypes.c_float, "c128": ctypes.c_double}
KERNEL = CudaKernel("diag_lu", "diag_lu.cu", {
    f"slu_diag_lu_{sfx}": [_V, _V, _V, _V, _V, ctypes.c_int, ctypes.c_int,
                           th, _V, _V]
    for sfx, th in _THRESH.items()})

_LL = ctypes.c_longlong
DIAG_LU_BATCH = CudaKernel("diag_lu_batch", "diag_lu.cu", {
    f"slu_diag_lu_batch_{sfx}": [_V] * 5 + [ctypes.c_int] * 2 + [_V, _V]
    + [ctypes.c_int, _LL, _LL, _V] for sfx in _THRESH})

#: the most members one batched launch takes (``gridDim.z``); a larger
#: batch launches in chunks of members
MAX_MEMBERS = 65535

#: block sizes the CUDA kernels take (powers of two; the tile and one
#: inverse fill 128 KiB of shared memory at 128)
CUDA_BLOCK_SIZES = (32, 64, 128)
#: element types of the kernels that the level executor and the solves
#: run, and the suffix of their C entries (clk, tck and flk take float32
#: only, as on the TPU)
CUDA_DTYPES = {torch.float32: "f32", torch.float64: "f64",
               torch.complex64: "c64", torch.complex128: "c128"}
#: how the wrappers' messages name them
DTYPE_NAMES = "float32, float64, complex64 or complex128"


def entry(name: str, t: torch.Tensor) -> str:
    """The C entry of kernel ``name`` for ``t``'s element type."""
    return f"slu_{name}_{CUDA_DTYPES[t.dtype]}"


def lu_inv_plain(T: torch.Tensor, thresh: float):
    """Batched no-pivot LU with ReplaceTinyPivot (reference:
    pdgstrf2.c): ``T`` is (batch, bs, bs). A pivot with |p| < thresh
    becomes sign(p)·thresh, or (p/|p|)·thresh for a complex p (the JAX
    package's ``blocklu._replace_tiny``), or +thresh at 0, and is counted;
    ``thresh`` is real.

    Returns (LU compact, L⁻¹, U⁻¹, tiny count as an int tensor)."""
    T = T.clone()
    nbat, m, _ = T.shape
    th = torch.tensor(thresh, dtype=T.real.dtype, device=T.device)
    tiny = torch.zeros((), dtype=torch.int64, device=T.device)
    for j in range(m):
        p = T[:, j, j]
        ap = p.abs()
        bad = ap < th
        unit = (p / torch.where(ap > 0, ap, 1)) if T.is_complex() \
            else torch.copysign(torch.ones_like(p), p)
        p = torch.where(bad, torch.where(ap > 0, unit * th, th).to(T.dtype),
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
    fn = entry("diag_lu", pool)
    KERNEL.count(fn)
    KERNEL.call(fn, ptr(pool), ptr(linv), ptr(uinv),
                ptr(slots), ptr(steps), len(slots), pool.shape[-1],
                float(thresh), ptr(tiny), stream_ptr(pool.device))


def _check_cuda(pool, linv, uinv, slots, steps, tiny, bs):
    if pool.device.type != "cuda":
        raise ValueError(f"diag_lu: unsupported device {pool.device}")
    for t in (pool, linv, uinv):
        if t.dtype not in CUDA_DTYPES or t.dtype != pool.dtype \
                or not t.is_contiguous() or t.device != pool.device \
                or t.shape[-2:] != (bs, bs):
            raise ValueError("diag_lu: pool/linv/uinv must be contiguous "
                             "(., bs, bs) tensors of one dtype "
                             f"({DTYPE_NAMES}) on one device")
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


# ---------------------------------------------------------------------------
# the stacked form: every member of a batch in one launch
# ---------------------------------------------------------------------------


def diag_lu_batch_plain(pool, linv, uinv, slots, steps, thresh, tiny):
    """Plain version of :func:`diag_lu_batch`: :func:`diag_lu_plain` on
    each member."""
    for m in range(pool.shape[0]):
        diag_lu_plain(pool[m], linv[m], uinv[m], slots, steps,
                      float(thresh[m]), tiny[m:m + 1])


def diag_lu_batch(pool, linv, uinv, slots, steps, thresh, tiny) -> None:
    """:func:`diag_lu` on every member of a stacked pool: ``pool`` is
    (members, rows, bs, bs), ``linv``/``uinv`` (members, nb, bs, bs),
    ``thresh`` the members' thresholds (a tensor of the element's real
    type) and ``tiny`` their int32 counters, both of shape (members,);
    ``slots``/``steps`` are shared. One launch per chunk of
    :data:`MAX_MEMBERS` members, each member computing what
    :func:`diag_lu` computes on it alone."""
    if pool.device.type == "cpu":
        return diag_lu_batch_plain(pool, linv, uinv, slots, steps, thresh,
                                   tiny)
    bs = pool.shape[-1]
    _check_cuda(pool, linv, uinv, slots, steps, tiny, bs)
    check_members(pool, linv, uinv)
    members = pool.shape[0]
    if thresh.shape != (members,) or thresh.dtype != pool.real.dtype \
            or thresh.device != pool.device or tiny.shape != (members,) \
            or not thresh.is_contiguous() or not tiny.is_contiguous():
        raise ValueError("diag_lu_batch: thresh and tiny must be contiguous "
                         "(members,) device tensors, thresh of the real type")
    if len(slots) == 0:
        return
    fn = entry("diag_lu_batch", pool)
    ps, vs = pool[0].numel(), linv[0].numel()
    for m0, cnt in member_chunks(members):
        DIAG_LU_BATCH.count(fn)
        DIAG_LU_BATCH.call(
            fn, at(pool, m0 * ps), at(linv, m0 * vs), at(uinv, m0 * vs),
            ptr(slots), ptr(steps), len(slots), bs, at(thresh, m0),
            at(tiny, m0), cnt, ps, vs, stream_ptr(pool.device))


def member_chunks(members: int):
    """(first member, members) of each launch of a batch."""
    return [(m0, min(MAX_MEMBERS, members - m0))
            for m0 in range(0, members, MAX_MEMBERS)]


def at(t: torch.Tensor, elems: int) -> ctypes.c_void_p:
    """The address ``elems`` elements into ``t`` (Python ints: no 32-bit
    overflow past 2³¹ elements)."""
    return ctypes.c_void_p(t.data_ptr() + elems * t.element_size())


def check_members(*ts):
    """Stacked tensors of one member count, each member contiguous."""
    m = ts[0].shape[0]
    for t in ts:
        if t.dim() != 4 or t.shape[0] != m or not t.is_contiguous():
            raise ValueError("batched kernels take contiguous (members, "
                             "rows, ., .) tensors of one member count")
