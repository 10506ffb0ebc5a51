"""Fill-reducing column orderings.

Analog of the dispatch in ``get_perm_c_dist`` (reference:
SRC/prec-independent/get_perm_c.c:461-606) with the same strategy menu
(superlu_enum_consts.h ``colperm_t``):

- NATURAL            → identity
- MMD_AT_PLUS_A      → minimum degree on the pattern of A^T + A
- MMD_ATA            → minimum degree on the pattern of A^T A
- COLAMD             → approximate column minimum degree (scipy's COLAMD as a
                       third-party library, exactly as the reference links the
                       COLAMD TPL)
- METIS_AT_PLUS_A    → multilevel nested dissection on A^T + A (own
                       METIS-class engine: native/mlnd.cpp fast path,
                       mlnd.py fallback, BFS bisection last resort)

The minimum-degree code is an original implementation of the classic
quotient-graph algorithm with element absorption and AMD-style approximate
external degrees (Amestoy–Davis–Duff, SIMAX 1996 — public algorithm; the
reference instead ships GENMMD, SRC/prec-independent/mmd.c).
Nested dissection uses pseudo-peripheral BFS level-structure bisection
(George–Liu) with minimum degree on small leaves.
"""

from __future__ import annotations

import heapq

import numpy as np
import scipy.sparse as sp

from ...utils.options import ColPerm

__all__ = ["get_perm_c", "minimum_degree", "nested_dissection", "colamd"]


def _sym_pattern_at_plus_a(A: sp.spmatrix) -> sp.csr_matrix:
    """Boolean pattern of A^T + A with no diagonal."""
    A = sp.csr_matrix(A, copy=False)
    B = (A + A.T).tocsr()
    B.setdiag(0)
    B.eliminate_zeros()
    B.data[:] = 1
    return B


def _sym_pattern_ata(A: sp.spmatrix) -> sp.csr_matrix:
    """Boolean pattern of A^T A with no diagonal (getata_dist analog)."""
    A = sp.csc_matrix(A, copy=False)
    P = sp.csc_matrix(
        (np.ones(A.nnz, dtype=np.int8), A.indices, A.indptr), shape=A.shape)
    B = (P.T @ P).tocsr()
    B.setdiag(0)
    B.eliminate_zeros()
    B.data[:] = 1
    return B


def minimum_degree(G: sp.csr_matrix) -> np.ndarray:
    """Approximate minimum-degree ordering of a symmetric pattern ``G``.

    Quotient-graph implementation: eliminated vertices become *elements*
    (cliques); element absorption keeps memory linear; degrees are AMD-style
    upper bounds maintained lazily in a heap. Returns the permutation as an
    array ``perm`` with perm[k] = k-th vertex to eliminate.

    The C++ engine (native/amd.cpp) is the fast path — the Python
    fallback is O(n·deg²) with sets and only fit for small n or testing
    (disable the engine with SLU_TPU_NATIVE=0).
    """
    n = G.shape[0]
    indptr, indices = G.indptr, G.indices
    from .native import native_min_degree
    perm = native_min_degree(indptr, indices)
    if perm is not None:
        return perm
    # variable -> set of adjacent variables / elements
    adj = [set(indices[indptr[v]:indptr[v + 1]].tolist()) for v in range(n)]
    elems = [set() for _ in range(n)]     # variable -> adjacent element ids
    emembers: dict[int, set] = {}         # element id -> member variables
    alive = np.ones(n, dtype=bool)
    degree = np.array([len(a) for a in adj], dtype=np.int64)
    heap = [(degree[v], v) for v in range(n)]
    heapq.heapify(heap)
    perm = np.empty(n, dtype=np.int64)
    next_elem = 0

    for k in range(n):
        while True:
            d, v = heapq.heappop(heap)
            if alive[v] and d == degree[v]:
                break
        perm[k] = v
        alive[v] = False
        # Lv = adj(v) ∪ members of v's elements, minus eliminated
        Lv = set(w for w in adj[v] if alive[w])
        for e in elems[v]:
            Lv.update(w for w in emembers[e] if alive[w])
        # absorb v's elements into the new element
        for e in elems[v]:
            del emembers[e]
        eid = next_elem
        next_elem += 1
        emembers[eid] = Lv
        absorbed = set(elems[v])
        for w in Lv:
            adj[w].discard(v)
            adj[w].difference_update(Lv)   # clique edges now implied by eid
            elems[w].difference_update(absorbed)
            elems[w].add(eid)
            # AMD-style approximate degree: direct neighbours + element sizes
            d = len(adj[w])
            for e in elems[w]:
                d += len(emembers[e]) - 1
            degree[w] = d
            heapq.heappush(heap, (d, w))
        adj[v] = set()
        elems[v] = set()
    return perm


def _pseudo_peripheral(indptr, indices, seed, alive_mask):
    """Find a pseudo-peripheral vertex by repeated BFS (George–Liu)."""
    v = seed
    last_ecc = -1
    for _ in range(8):
        levels = _bfs_levels(indptr, indices, v, alive_mask)
        ecc = levels.max(initial=0)
        far = np.flatnonzero(levels == ecc)
        if ecc <= last_ecc:
            return v, levels
        last_ecc = ecc
        v = int(far[0])
    return v, _bfs_levels(indptr, indices, v, alive_mask)


def _bfs_levels(indptr, indices, src, mask):
    n = len(mask)
    levels = np.full(n, -1, dtype=np.int64)
    levels[src] = 0
    frontier = [src]
    lvl = 0
    while frontier:
        lvl += 1
        nxt = []
        for u in frontier:
            for w in indices[indptr[u]:indptr[u + 1]]:
                if mask[w] and levels[w] < 0:
                    levels[w] = lvl
                    nxt.append(int(w))
        frontier = nxt
    return levels


def nested_dissection(G: sp.csr_matrix, leaf_size: int = 64) -> np.ndarray:
    """Nested-dissection ordering of a symmetric pattern via BFS bisection.

    Separator = the middle BFS level from a pseudo-peripheral vertex; halves
    are recursed, separator ordered last. Leaves below ``leaf_size`` use
    minimum degree. (METIS_AT_PLUS_A stand-in; get_perm_c.c:500-546.)
    """
    n = G.shape[0]
    indptr, indices = G.indptr, G.indices
    perm_out = np.empty(n, dtype=np.int64)
    pos = 0

    def order_leaf(verts):
        nonlocal pos
        if len(verts) > 2:
            sub = G[verts][:, verts].tocsr()
            local = minimum_degree(sub)
            ordered = np.asarray(verts)[local]
        else:
            ordered = np.asarray(verts)
        perm_out[pos:pos + len(ordered)] = ordered
        pos += len(ordered)

    def dissect(verts):
        nonlocal pos
        if len(verts) <= leaf_size:
            order_leaf(verts)
            return
        mask = np.zeros(n, dtype=bool)
        mask[verts] = True
        src = int(verts[0])
        src, levels = _pseudo_peripheral(indptr, indices, src, mask)
        reachable = np.flatnonzero((levels >= 0) & mask)
        # disconnected remainder handled as its own component
        rest = [v for v in verts if levels[v] < 0]
        maxlvl = int(levels[reachable].max()) if len(reachable) else 0
        if maxlvl < 2:
            order_leaf(list(reachable) + rest)
            return
        mid = maxlvl // 2
        sep = [int(v) for v in reachable if levels[v] == mid]
        left = [int(v) for v in reachable if levels[v] < mid]
        right = [int(v) for v in reachable if levels[v] > mid]
        if not left or not right:
            order_leaf(list(reachable) + rest)
            return
        dissect(left)
        dissect(right)
        if rest:
            dissect(rest)
        # separator last
        perm_out[pos:pos + len(sep)] = sep
        pos += len(sep)

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    try:
        dissect(list(range(n)))
    finally:
        sys.setrecursionlimit(old)
    assert pos == n
    return perm_out


def geometric_nd(shape: tuple) -> np.ndarray:
    """Exact geometric nested dissection for a structured grid.

    For matrices whose unknowns live on a regular 1/2/3-D grid (index
    varying fastest in the first dimension), recursive coordinate
    bisection with the median hyperplane as separator — the separator
    itself ordered by the same recursion (one dimension lower). Analog of
    feeding a geometric partitioner's ordering through perm_c (the
    reference accepts any ordering via MY_PERMC, superlu_enum_consts.h);
    on grid problems this matches METIS-class quality and produces far
    denser 128-blocks than graph-based bisection: the separator's
    recursive cuts coincide with the descendants' boundaries, so every
    subdomain touches contiguous runs of each ancestor separator.

    Returns ``perm`` with perm[k] = k-th grid index to eliminate.
    """
    import sys
    dims = [list(range(int(s))) for s in shape]
    strides = np.cumprod([1] + [int(s) for s in shape[:-1]])

    def nd(axes):
        sizes = [len(a) for a in axes]
        if max(sizes) <= 2:
            # leaf box: first dim fastest
            idx = []
            def rec(d, acc):
                if d < 0:
                    idx.append(acc)
                    return
                for c in axes[d]:
                    rec(d - 1, acc + c * strides[d])
            rec(len(axes) - 1, 0)
            return idx
        ax = int(np.argmax(sizes))
        coords = axes[ax]
        mid = len(coords) // 2
        lo, hi, sep = coords[:mid], coords[mid + 1:], [coords[mid]]

        def sub(c):
            a = list(axes)
            a[ax] = c
            return a

        return nd(sub(lo)) + nd(sub(hi)) + nd(sub(sep))

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 100000))
    try:
        perm = np.asarray(nd(dims), dtype=np.int64)
    finally:
        sys.setrecursionlimit(old)
    n = int(np.prod([len(d) for d in dims]))
    assert len(perm) == n and len(np.unique(perm)) == n
    return perm


def colamd(A: sp.spmatrix) -> np.ndarray:
    """COLAMD column ordering via the scipy/SuperLU TPL (cheap: incomplete
    factorization with full dropping only runs the symbolic COLAMD phase)."""
    import scipy.sparse.linalg as spla
    A = sp.csc_matrix(A)
    lu = spla.spilu(A.astype(np.float64) if A.dtype.kind != "c"
                    else A.astype(np.complex128),
                    drop_tol=1e30, fill_factor=1.0)
    return np.asarray(lu.perm_c, dtype=np.int64)


def get_perm_c(strategy: ColPerm, A: sp.spmatrix) -> np.ndarray:
    """Column-ordering dispatch (analog of get_perm_c_dist)."""
    n = A.shape[1]
    if strategy == ColPerm.NATURAL:
        return np.arange(n, dtype=np.int64)
    if strategy == ColPerm.COLAMD:
        return colamd(A)
    if strategy == ColPerm.MMD_ATA:
        return minimum_degree(_sym_pattern_ata(A))
    if strategy == ColPerm.MMD_AT_PLUS_A:
        return minimum_degree(_sym_pattern_at_plus_a(A))
    if strategy in (ColPerm.METIS_AT_PLUS_A, ColPerm.PARMETIS):
        G = _sym_pattern_at_plus_a(A)
        # METIS-class multilevel ND: C++ engine first (native/mlnd.cpp,
        # n=1e5-scale in ~1s), Python mlnd.py next (same algorithm,
        # minutes at n>=3e4), BFS level bisection as the last resort
        from .native import native_nested_dissection
        perm = native_nested_dissection(G.indptr, G.indices)
        if perm is not None:
            return perm
        if n <= 16384:
            from .mlnd import nested_dissection_ml
            return nested_dissection_ml(G)
        return nested_dissection(G)
    raise ValueError(f"unsupported column ordering: {strategy}")
