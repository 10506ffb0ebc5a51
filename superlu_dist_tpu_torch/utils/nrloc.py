"""Row-distributed input format (``NRformat_loc`` analog).

An exact copy of the JAX package's ``utils/nrloc.py`` (the port imports
nothing of that package); the drivers of this port take it as the JAX
package's do.

The reference's primary input is a block-row-distributed CSR: each rank owns
``m_loc`` consecutive rows starting at ``fst_row`` (reference:
SRC/include/supermatrix.h:54-217 NRformat_loc; assembled by the example
drivers' dcreate_matrix.c). Here the host gathers the chunks before
preprocessing — the role layer 0 plays in the 3D driver
(dGatherNRformat_loc3d, reference: SRC/double/dnrformat_loc3d.c:47-518) —
and scatters solutions back (dScatter_B3d analog).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import scipy.sparse as sp

__all__ = ["NRLocMatrix"]


class NRLocMatrix:
    """A square matrix stored as consecutive row chunks (one per "rank").

    ``local=True`` marks a PARTIAL view: this process's chunk(s) only,
    with the other rows owned by other processes (the true NRformat_loc
    convention). The distributed drivers then keep the input sharded —
    values are redistributed device-side (dReDistribute_A analog,
    reference: pddistribute.c:66-433) and only process 0 ever assembles
    global values (for row-pivoting/symbolic, the pdgssvx.c:768-794
    gather role)."""

    def __init__(self, chunks: Sequence[Tuple[int, sp.spmatrix]], n: int,
                 *, local: bool = False):
        """``chunks``: list of (fst_row, csr_rows); without ``local``,
        consecutive non-overlapping coverage of rows [0, n) is required."""
        self.n = n
        self.local = bool(local)
        self.chunks = sorted(((int(f), sp.csr_matrix(M)) for f, M in chunks),
                             key=lambda t: t[0])
        for fst, M in self.chunks:
            if M.shape[1] != n:
                raise ValueError("chunk column count != n")
        if not self.local:
            cover = 0
            for fst, M in self.chunks:
                if fst != cover:
                    raise ValueError(f"row coverage gap/overlap at {fst}")
                cover += M.shape[0]
            if cover != n:
                raise ValueError(f"chunks cover {cover} rows, expected {n}")

    @classmethod
    def from_global(cls, A: sp.spmatrix, nparts: int) -> "NRLocMatrix":
        """Split a global matrix into nparts block-row chunks
        (dcreate_matrix distribution convention: m_loc = n/nparts, the last
        part takes the remainder)."""
        A = sp.csr_matrix(A)
        n = A.shape[0]
        m_loc = n // nparts
        chunks = []
        for p in range(nparts):
            lo = p * m_loc
            hi = n if p == nparts - 1 else (p + 1) * m_loc
            chunks.append((lo, A[lo:hi]))
        return cls(chunks, n)

    def to_global(self) -> sp.csc_matrix:
        """Gather to one matrix (dGatherNRformat_loc3d analog)."""
        if self.local:
            raise ValueError(
                "partial (local=True) NRLocMatrix cannot be gathered "
                "host-side — the distributed drivers redistribute it "
                "device-side instead")
        return sp.csc_matrix(sp.vstack([M for _, M in self.chunks]))

    def to_coo_arrays(self, dtype=None):
        """(rows, cols, vals) of every chunk entry in GLOBAL coordinates
        (rows offset by fst_row). ``dtype`` casts the values; defaults to
        the chunks' own dtype (float64 when there are no chunks — pass
        an explicit dtype when cross-process consistency matters)."""
        ii, jj, vv = [], [], []
        for fst, M in self.chunks:
            C = M.tocoo()
            ii.append(C.row.astype(np.int64) + fst)
            jj.append(C.col.astype(np.int64))
            vv.append(C.data)
        rows = np.concatenate(ii) if ii else np.empty(0, np.int64)
        cols = np.concatenate(jj) if jj else np.empty(0, np.int64)
        vals = np.concatenate(vv) if vv else np.empty(0)
        if dtype is not None:
            vals = vals.astype(dtype)
        return rows, cols, vals

    def to_partial_csc(self) -> sp.csc_matrix:
        """This process's rows scattered into an (n, n) shell (other rows
        empty) — host memory stays O(local nnz)."""
        parts = []
        for fst, M in self.chunks:
            C = M.tocoo()
            parts.append((C.row + fst, C.col, C.data))
        if not parts:
            return sp.csc_matrix((self.n, self.n))
        rows = np.concatenate([p[0] for p in parts])
        cols = np.concatenate([p[1] for p in parts])
        data = np.concatenate([p[2] for p in parts])
        return sp.csc_matrix((data, (rows, cols)), shape=(self.n, self.n))

    def gather_rhs(self, b_chunks: Sequence[np.ndarray]) -> np.ndarray:
        """Stack per-chunk right-hand sides into the global b."""
        if len(b_chunks) != len(self.chunks):
            raise ValueError("one RHS chunk per matrix chunk required")
        return np.concatenate([np.asarray(b) for b in b_chunks], axis=0)

    def scatter_solution(self, x: np.ndarray) -> List[np.ndarray]:
        """Split the global solution back to row owners (dScatter_B3d)."""
        out = []
        for fst, M in self.chunks:
            out.append(x[fst:fst + M.shape[0]])
        return out
