"""Static pivoting: weighted bipartite matching (MC64-style).

TPU-native framework analog of the f2c'd Duff–Koster MC64 code and its driver
(reference: SRC/prec-independent/mc64ad_dist.c:121-2655,
SRC/double/dldperm_dist.c:1-177). Re-implemented from the published algorithm
(Duff & Koster, "On algorithms for permuting large entries to the diagonal of
a sparse matrix", SIMAX 2001): job 5 finds a row permutation maximizing the
product of |diagonal| entries via a min-cost perfect matching on costs
c_ij = log(max_i |a_ij|) − log|a_ij|, solved by successive shortest
augmenting paths under Johnson potentials (sparse Jonker–Volgenant).

The optimal duals (u, v) satisfy u_i + v_j ≤ c_ij with equality on matched
edges, so R1[i] = exp(u_i), C1[j] = exp(v_j − log colmax_j) make
diag(R1)·A·diag(C1) have unit diagonal after the permutation and all entries
≤ 1 in magnitude — exactly MC64 job-5 semantics.

This runs on the host: sequential graph code off the steady-state path
(SamePattern_SameRowPerm reuse skips it entirely).
"""

from __future__ import annotations

import heapq

import numpy as np
import scipy.sparse as sp

from .equil import SingularMatrixError

__all__ = ["ldperm", "maximum_product_matching", "max_cardinality_rowperm"]


def maximum_product_matching(A: sp.spmatrix):
    """Maximum-product perfect matching with dual scalings (MC64 job 5).

    Returns ``(rowperm, u, v, logcmax)`` where ``rowperm[j]`` is the row
    matched to column j and (u, v) are optimal duals of the min-cost
    assignment on c_ij = logcmax[j] − log|a_ij|.
    """
    A = sp.csc_matrix(A)
    n = A.shape[0]
    if A.shape[0] != A.shape[1]:
        raise ValueError("matching requires a square matrix")
    Ap = A.indptr
    Ai = A.indices
    absx = np.abs(A.data).astype(np.float64)

    # per-column max → costs; explicit zeros get +inf cost (never matched)
    logcmax = np.empty(n)
    cost = np.empty(len(absx))
    with np.errstate(divide="ignore"):
        logx = np.log(absx)
    for j in range(n):
        lo, hi = Ap[j], Ap[j + 1]
        m = absx[lo:hi].max() if hi > lo else 0.0
        if m <= 0.0:
            raise SingularMatrixError(f"column {j} has no nonzero entries")
        logcmax[j] = np.log(m)
        cost[lo:hi] = logcmax[j] - logx[lo:hi]

    INF = np.inf
    u = np.zeros(n)                                # row potentials
    v = np.zeros(n)                                # column potentials
    match_row = np.full(n, -1, dtype=np.int64)     # row  -> matched col
    match_col = np.full(n, -1, dtype=np.int64)     # col  -> matched row

    # Greedy init on zero-cost (column-max) edges; keeps u=v=0 feasible.
    for j in range(n):
        for p in range(Ap[j], Ap[j + 1]):
            i = Ai[p]
            if match_row[i] < 0 and cost[p] == 0.0:
                match_row[i] = j
                match_col[j] = i
                break

    dist = np.full(n, INF)
    done = np.zeros(n, dtype=bool)
    prev_col = np.empty(n, dtype=np.int64)     # row -> column it was reached from
    touched: list[int] = []

    for j0 in range(n):
        if match_col[j0] >= 0:
            continue
        # --- Dijkstra from column j0 over rows, in reduced costs ---
        for i in touched:
            dist[i] = INF
            done[i] = False
        touched = []
        heap = []
        for p in range(Ap[j0], Ap[j0 + 1]):
            i = Ai[p]
            d = cost[p] - u[i] - v[j0]
            if d < dist[i]:
                if dist[i] == INF:
                    touched.append(i)
                dist[i] = d
                prev_col[i] = j0
                heapq.heappush(heap, (d, i))
        found = -1
        D = INF
        finalized: list[int] = []
        while heap:
            d, i = heapq.heappop(heap)
            if done[i] or d > dist[i]:
                continue
            done[i] = True
            finalized.append(i)
            if match_row[i] < 0:
                found, D = i, d
                break
            jj = match_row[i]   # move to column jj at zero reduced cost
            for p in range(Ap[jj], Ap[jj + 1]):
                i2 = Ai[p]
                if done[i2]:
                    continue
                nd = d + cost[p] - u[i2] - v[jj]
                if nd < dist[i2]:
                    if dist[i2] == INF:
                        touched.append(i2)
                    dist[i2] = nd
                    prev_col[i2] = jj
                    heapq.heappush(heap, (nd, i2))
        if found < 0:
            raise SingularMatrixError(
                "matrix is structurally singular (no perfect matching)")

        # --- dual update (keeps reduced costs >= 0, matched edges at 0):
        #     u[i] += d(i) - D for finalized rows,
        #     v[j] += D - d(j) for scanned columns (d(j)=d(matched row)), j0 at d=0.
        v[j0] += D
        for i in finalized:
            if i == found:
                continue
            u[i] += dist[i] - D
            v[match_row[i]] += D - dist[i]

        # --- augment along the alternating path ---
        i = found
        while True:
            jj = prev_col[i]
            match_row[i] = jj
            match_col[jj], i = i, match_col[jj]
            if jj == j0:
                break

    return match_col.copy(), u, v, logcmax


def max_cardinality_rowperm(A: sp.spmatrix):
    """Maximum-cardinality matching (MC64 job-1/2 analog) via scipy TPL."""
    from scipy.sparse.csgraph import maximum_bipartite_matching
    perm = maximum_bipartite_matching(sp.csr_matrix(A), perm_type="row")
    if np.any(perm < 0):
        raise SingularMatrixError("structurally singular matrix")
    return np.asarray(perm, dtype=np.int64)


def ldperm(A: sp.spmatrix, job: int = 5):
    """Driver: row permutation + scalings (analog of ``dldperm_dist``).

    Returns ``(rowperm, R1, C1)``: with B = diag(R1)·A·diag(C1),
    B[rowperm[j], j] has magnitude 1 and |B| <= 1 everywhere for job 5;
    permuting row rowperm[j] to position j puts the matching on the diagonal.
    For other jobs the scalings are ones.
    """
    n = A.shape[0]
    if job == 5:
        rowperm, u, v, logcmax = maximum_product_matching(A)
        R1 = np.exp(u)
        C1 = np.exp(v - logcmax)
        return rowperm, R1, C1
    rowperm = max_cardinality_rowperm(A)
    return rowperm, np.ones(n), np.ones(n)


def hwpm_rowperm(A: sp.spmatrix, nthreads: int = 0):
    """Parallel heavy-weight perfect matching (LARGE_DIAG_HWPM).

    The reference binds CombBLAS's distributed approximate matching
    (d_c2cpp_GetHWPM.cpp:55): an APPROXIMATE maximum log-product perfect
    matching, permutation only — the HWPM path applies no R1/C1 scalings.
    Here: a multi-threaded epsilon-scaled auction (native/hwpm.cpp).
    Returns ``rowperm`` such that A[rowperm, :] has the heavy diagonal
    (i.e. rowperm[k] = column matched to row k of the permuted matrix),
    falling back to the serial exact matching if the native engine is
    unavailable or the auction stalls.
    """
    from .native import native_hwpm
    A = sp.csc_matrix(A)
    col_of = native_hwpm(A.indptr, A.indices,
                         np.abs(A.data).astype(np.float64), nthreads)
    if col_of is None:
        perm, _, _, _ = maximum_product_matching(A)
        return perm
    # col_of[j] = row matched to column j; build rowperm as used by
    # ldperm: rowperm[j] = matched row (A2 = A[rowperm] puts heavy
    # entries on the diagonal)
    return np.asarray(col_of, dtype=np.int64)
