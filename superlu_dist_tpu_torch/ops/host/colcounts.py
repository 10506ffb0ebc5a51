"""Cholesky column counts of the symmetrized pattern — the cheap scalar
fill/flop estimator behind the adaptive plan policy.

For GESP (static-pivoting LU) the fill of L and U is bounded by the
Cholesky fill of the symmetrized pattern A+Aᵀ (George/Ng), which is also
the bound the block planner's fill simulation converges to. Column counts
of that Cholesky factor are computable WITHOUT forming the factor in
near-linear time via the skeleton/leaf-counting algorithm of Gilbert, Ng
and Peyton (SIMAX 1994) — elimination-tree postorder + disjoint-set path
compression over "row subtree" leaves.

This gives the driver an O(nnz·α) estimate of scalar LU fill and flops
per candidate ordering, used to (a) detect pathological block pad ratios
and (b) rank fallback orderings, without ever running a scalar symbolic
factorization. The reference has no analog — its supernodes follow the
scalar structure exactly so pad cannot explode; a fixed-block-size design
needs this guard (VERDICT r4 item 1: big.rua pad 84399×).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .etree import postorder

__all__ = ["chol_column_counts", "estimate_gesp_stats"]


def _lower_sym_pattern(A: sp.spmatrix) -> sp.csc_matrix:
    """Strict lower triangle of the pattern of A + Aᵀ (CSC)."""
    A = sp.csc_matrix(A)
    P = sp.csc_matrix((np.ones(A.nnz, dtype=np.int8), A.indices, A.indptr),
                      shape=A.shape)
    S = (P + P.T).tocsc()
    return sp.tril(S, k=-1, format="csc")


def chol_column_counts(A: sp.spmatrix,
                       parent: np.ndarray | None = None) -> np.ndarray:
    """Column counts (including the diagonal) of chol(pattern(A + Aᵀ)).

    ``parent`` may pass a precomputed symmetrized elimination tree
    (align.sym_etree output) to skip recomputing it. The C++ engine
    (native/tree.cpp) serves large matrices; this Python path is the
    reference implementation and fallback.
    """
    L = _lower_sym_pattern(A)
    n = L.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    from .native import native_tree_counts
    nat = native_tree_counts(L.indptr, L.indices)
    if nat is not None:
        return nat[1]
    if parent is None:
        from .align import sym_etree
        parent = sym_etree(A)
    post = postorder(parent)

    # first descendant (postorder index) of every node + initial deltas
    first = np.full(n, -1, dtype=np.int64)
    delta = np.zeros(n, dtype=np.int64)
    for k in range(n):
        j = int(post[k])
        delta[j] = 1 if first[j] == -1 else 0   # j a leaf of its subtree
        while j != -1 and first[j] == -1:
            first[j] = k
            j = int(parent[j])

    # leaf detection over row subtrees with path-compressed set union
    maxfirst = np.full(n, -1, dtype=np.int64)
    prevleaf = np.full(n, -1, dtype=np.int64)
    anc = np.arange(n, dtype=np.int64)

    def find(u: int) -> int:
        r = u
        while anc[r] != r:
            r = int(anc[r])
        while anc[u] != r:           # path compression
            anc[u], u = r, int(anc[u])
        return r

    Lp, Li = L.indptr, L.indices
    # iterate columns in postorder; for each j, rows i > j adjacent to j
    for k in range(n):
        j = int(post[k])
        if parent[j] != -1:
            delta[parent[j]] -= 1    # j is not a root: correction term
        for p in range(Lp[j], Lp[j + 1]):
            i = int(Li[p])
            # j is a leaf of i's row subtree iff its first descendant is
            # later than every previously seen column adjacent to row i
            if first[j] > maxfirst[i]:
                maxfirst[i] = first[j]
                delta[j] += 1
                q = prevleaf[i]
                if q != -1:
                    delta[find(q)] -= 1
                prevleaf[i] = j
        if parent[j] != -1:
            anc[j] = int(parent[j])

    # accumulate deltas up the tree in postorder
    cc = delta.astype(np.int64)
    for k in range(n):
        j = int(post[k])
        p = int(parent[j])
        if p != -1:
            cc[p] += cc[j]
    return cc


def estimate_gesp_stats(A: sp.spmatrix,
                        parent: np.ndarray | None = None) -> dict:
    """Scalar-structure estimates for GESP LU of (already permuted) A:
    ``nnz_lu`` ≈ nnz(L)+nnz(U) and ``flops`` ≈ Σ_j 2·|L_j|·|U_j| + divs,
    both from the symmetric-pattern Cholesky bound (|L_j| = |U_j| = cc_j−1).
    Complex inputs count 4 real flops per complex flop (the reference's
    PStatPrint convention)."""
    cc = chol_column_counts(A, parent)
    low = (cc - 1).astype(np.float64)
    flops = float(np.sum(2.0 * low * low + low))
    nnz_lu = int(2 * low.sum() + len(cc))
    if np.dtype(sp.csc_matrix(A).dtype).kind == "c":
        flops *= 4.0
    return dict(nnz_lu=nnz_lu, flops=max(flops, 1.0), cc=cc)
