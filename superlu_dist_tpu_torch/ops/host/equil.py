"""Equilibration: row/column scaling to improve conditioning.

Analog of ``dgsequ_dist``/``dlaqgs_dist`` and their parallel drivers
``pdgsequ``/``pdlaqgs`` (reference: SRC/double/dgsequ_dist.c, dlaqgs_dist.c,
pdgsequ.c:1-244). Same semantics: R[i] = 1/max_j|a_ij|, C[j] = 1/max_i|r_i a_ij|,
and the LAPACK-style THRESH=0.1 decision for which scalings to apply.

Host-side (numpy): equilibration is O(nnz) preprocessing off the hot path; the
distributed variant reduces row/col maxima with a psum (see parallel/).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ...utils.options import DiagScale

#: if rowcnd/colcnd >= THRESH the corresponding scaling is skipped
#: (reference: dlaqgs_dist.c ``#define THRESH (0.1)``)
THRESH = 0.1


class SingularMatrixError(ValueError):
    """Structurally or numerically singular input (info>0 analog)."""


def gsequ(A: sp.spmatrix):
    """Compute row/col scale factors.

    Returns (R, C, rowcnd, colcnd, amax). Raises SingularMatrixError on an
    exactly-zero row or column (the reference returns info=i+1,
    dgsequ_dist.c).
    """
    A = sp.csc_matrix(A)
    n_rows, n_cols = A.shape
    absA = np.abs(A)

    rowmax = np.asarray(absA.max(axis=1).todense()).ravel()
    if np.any(rowmax == 0):
        i = int(np.argmax(rowmax == 0))
        raise SingularMatrixError(f"row {i} of A is exactly zero")

    smlnum = np.finfo(np.float64).tiny
    bignum = 1.0 / smlnum
    R = 1.0 / np.clip(rowmax, smlnum, bignum)
    rowcnd = max(np.min(rowmax), smlnum) / min(np.max(rowmax), bignum)

    # column max of diag(R) @ A
    RA = absA.multiply(R[:, None]).tocsc()
    colmax = np.asarray(RA.max(axis=0).todense()).ravel()
    if np.any(colmax == 0):
        j = int(np.argmax(colmax == 0))
        raise SingularMatrixError(f"column {j} of A is exactly zero")
    C = 1.0 / np.clip(colmax, smlnum, bignum)
    colcnd = max(np.min(colmax), smlnum) / min(np.max(colmax), bignum)

    amax = float(rowmax.max())
    return R, C, float(rowcnd), float(colcnd), amax


def laqgs(A: sp.spmatrix, R, C, rowcnd: float, colcnd: float, amax: float):
    """Apply equilibration if worthwhile; returns (A_scaled, equed).

    Decision logic mirrors dlaqgs_dist.c: skip a scaling when its cnd >= 0.1
    and amax is neither too small nor too large.
    """
    smlnum = np.finfo(np.float64).tiny / np.finfo(np.float64).eps
    bignum = 1.0 / smlnum

    row_ok = rowcnd >= THRESH and smlnum <= amax <= bignum
    col_ok = colcnd >= THRESH

    A = sp.csc_matrix(A, copy=True)
    if row_ok and col_ok:
        return A, DiagScale.NOEQUIL
    if row_ok:  # scale columns only
        A = A.multiply(C[None, :]).tocsc()
        return A, DiagScale.COL
    if col_ok:  # scale rows only
        A = A.multiply(R[:, None]).tocsc()
        return A, DiagScale.ROW
    A = A.multiply(R[:, None]).multiply(C[None, :]).tocsc()
    return A, DiagScale.BOTH


def equilibrate(A: sp.spmatrix):
    """One-shot: compute + apply. Returns (A_scaled, R, C, equed)."""
    R, C, rowcnd, colcnd, amax = gsequ(A)
    A2, equed = laqgs(A, R, C, rowcnd, colcnd, amax)
    if equed in (DiagScale.NOEQUIL, DiagScale.COL):
        R = np.ones_like(R)
    if equed in (DiagScale.NOEQUIL, DiagScale.ROW):
        C = np.ones_like(C)
    return A2, R, C, equed
