"""Matrix norms of a scipy sparse matrix, for the condition estimate
and the tests, and the componentwise backward error that the batch's
refinement reads."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def langs(norm: str, A) -> float:
    """Matrix norms, the analog of ``pdlangs``/``dlangs_dist``
    (reference: SRC/double/pdlangs.c, dlangs_dist.c).
    norm ∈ {"M" (max |a_ij|), "1", "I" (inf), "F"}.
    """
    A = sp.csc_matrix(A)
    if norm in ("M", "m"):
        return float(np.abs(A.data).max()) if A.nnz else 0.0
    if norm in ("1", "O", "o"):
        return float(np.abs(A).sum(axis=0).max())
    if norm in ("I", "i"):
        return float(np.abs(A).sum(axis=1).max())
    if norm in ("F", "f", "E", "e"):
        return float(np.sqrt((np.abs(A.data) ** 2).sum()))
    raise ValueError(f"unknown norm {norm!r}")


def backward_error(A, x, b) -> float:
    """Componentwise backward error max_i |r|_i / (|A|·|x| + |b|)_i
    (the ``berr`` of pdgsrfs.c:189-231)."""
    A = sp.csc_matrix(A)
    x = np.asarray(x)
    b = np.asarray(b)
    r = np.abs(b - A @ x)
    denom = np.abs(A) @ np.abs(x) + np.abs(b)
    safe = denom > 0
    out = np.zeros_like(r, dtype=np.float64)
    out[safe] = r[safe] / denom[safe]
    out[~safe] = np.where(r[~safe] > 0, np.inf, 0.0)
    return float(np.max(out)) if out.size else 0.0
