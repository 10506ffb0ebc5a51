"""Sparse mat-vec for iterative refinement.

Counterpart of the JAX package's ``ops/kernels/spmv.py`` (a COO gather +
``segment_sum``, analog of the reference's ``pdgsmv``,
SRC/double/pdgsmv.c). Here a COO gather + ``index_add_`` in plain
PyTorch: the JAX version is an XLA op, not a TPU kernel, so it has no
hand-written counterpart.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch


def coo_arrays(A: sp.spmatrix, dtype, device):
    """(rows, cols, vals) of A on ``device``; indices int64."""
    C = sp.coo_matrix(A)
    return (torch.as_tensor(C.row.astype(np.int64), device=device),
            torch.as_tensor(C.col.astype(np.int64), device=device),
            torch.as_tensor(np.asarray(C.data, dtype=dtype), device=device))


def spmv(rows, cols, vals, x, n_rows: int):
    """y = A @ x with A in COO; x: (n, k)."""
    y = torch.zeros((n_rows, x.shape[1]), dtype=x.dtype, device=x.device)
    return y.index_add_(0, rows, vals[:, None] * x[cols])


def abs_spmv(rows, cols, vals, x, n_rows: int):
    """y = |A| @ x (the backward-error denominator |A|·|x| + |b|,
    reference: pdgsrfs.c:189-231)."""
    return spmv(rows, cols, vals.abs(), x, n_rows)


def spmv_t(rows, cols, vals, x, n_cols: int):
    """y = Aᵀ @ x with A in COO (the residual of a transposed solve; the
    caller conjugates for Aᴴ)."""
    return spmv(cols, rows, vals, x, n_cols)


def abs_spmv_t(rows, cols, vals, x, n_cols: int):
    """y = |A|ᵀ @ x, the backward-error denominator of a transposed
    solve."""
    return spmv(cols, rows, vals.abs(), x, n_cols)
