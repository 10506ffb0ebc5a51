"""Sparse mat-vec for iterative refinement.

Counterpart of the JAX package's ``ops/kernels/spmv.py`` (a COO gather +
``segment_sum``, analog of the reference's ``pdgsmv``,
SRC/double/pdgsmv.c). The JAX version is an XLA op, not a TPU kernel, so
this is plain PyTorch. Each output row is summed in one fixed order, its
entries' order in the COO, so two calls give bit-equal results on the
card (an ``index_add_`` adds with atomics on CUDA, in whatever order
they land, and refinement then takes a different number of steps from
call to call), and on the CPU the same bits as the JAX package's
``segment_sum``. The entries are grouped once, when the matrix is built,
by output row into buckets of rows of similar length, each bucket a
padded (rows, width) gather whose running sum along the row
(``cumsum(dim=1)``, one thread per row and column on CUDA) ends in the
row's sum. Widths are powers of two, so the padding stays under twice
the entries however uneven the row lengths (a hub row of a circuit
matrix gets a bucket of its own).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch


@dataclasses.dataclass
class SegmentSum:
    """Fixed-order sums of ``nnz`` gathered entries into ``n_out`` output
    rows: bucket ``(out, idx)`` sets y[out[i]] = Σ_j e[idx[i, j]], added
    in the order of j, where ``idx`` is (rows, width) and pads with
    ``nnz``, the index of a zero appended to the entries. Rows without
    entries are in no bucket."""

    n_out: int
    nnz: int
    buckets: list

    @classmethod
    def build(cls, seg: np.ndarray, n_out: int, device) -> "SegmentSum":
        """Group the entries by their output row ``seg`` (each row keeps
        its entries in their given order)."""
        seg = np.asarray(seg, dtype=np.int64)
        nnz = len(seg)
        order = np.argsort(seg, kind="stable")
        cnt = np.bincount(seg, minlength=n_out)
        start = np.concatenate([[0], np.cumsum(cnt)])
        width = np.where(cnt > 0, 1 << np.ceil(np.log2(np.maximum(cnt, 1)))
                         .astype(np.int64), 0)
        buckets = []
        for w in np.unique(width[width > 0]):
            r = np.flatnonzero(width == w)
            pos = start[r][:, None] + np.arange(w)
            idx = np.where(pos < start[r + 1][:, None],
                           order[np.minimum(pos, nnz - 1)], nnz)
            buckets.append((torch.as_tensor(r, device=device),
                            torch.as_tensor(idx, device=device)))
        return cls(n_out=n_out, nnz=nnz, buckets=buckets)

    def __call__(self, e: torch.Tensor) -> torch.Tensor:
        """y (n_out, k) from the entries ``e`` (nnz, k)."""
        e = torch.cat([e, e.new_zeros((1, e.shape[1]))])
        y = e.new_zeros((self.n_out, e.shape[1]))
        for out, idx in self.buckets:
            y[out] = e[idx].cumsum(dim=1)[:, -1]
        return y


@dataclasses.dataclass
class Coo:
    """A sparse matrix's entries on a device (``rows``, ``cols`` int64,
    ``vals``), with the fixed-order sums of A·x (by row) and of Aᵀ·x (by
    column)."""

    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    by_row: SegmentSum
    by_col: SegmentSum

    @classmethod
    def from_arrays(cls, rows, cols, vals, shape, device) -> "Coo":
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        return cls(rows=torch.as_tensor(rows, device=device),
                   cols=torch.as_tensor(cols, device=device),
                   vals=torch.as_tensor(np.asarray(vals), device=device),
                   by_row=SegmentSum.build(rows, shape[0], device),
                   by_col=SegmentSum.build(cols, shape[1], device))


def coo_arrays(A: sp.spmatrix, dtype, device) -> Coo:
    """A's entries on ``device`` in the order of ``scipy.sparse.coo_matrix``
    (the JAX package's), with values in ``dtype``."""
    C = sp.coo_matrix(A)
    return Coo.from_arrays(C.row, C.col, np.asarray(C.data, dtype=dtype),
                           A.shape, device)


def spmv(A: Coo, x):
    """y = A @ x; x: (n, k)."""
    return A.by_row(A.vals[:, None] * x[A.cols])


def abs_spmv(A: Coo, x):
    """y = |A| @ x (the backward-error denominator |A|·|x| + |b|,
    reference: pdgsrfs.c:189-231)."""
    return A.by_row(A.vals.abs()[:, None] * x[A.cols])


def spmv_t(A: Coo, x):
    """y = Aᵀ @ x (the residual of a transposed solve; the caller
    conjugates for Aᴴ)."""
    return A.by_col(A.vals[:, None] * x[A.rows])


def abs_spmv_t(A: Coo, x):
    """y = |A|ᵀ @ x, the backward-error denominator of a transposed
    solve."""
    return A.by_col(A.vals.abs()[:, None] * x[A.rows])
