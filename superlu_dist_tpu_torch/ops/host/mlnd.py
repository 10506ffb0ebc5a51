"""Multilevel nested dissection (METIS-class, original implementation).

Replaces the BFS-level-bisection stand-in with the standard multilevel
scheme the reference gets from (Par)METIS (reference:
SRC/prec-independent/get_perm_c.c:500-546 METIS_AT_PLUS_A dispatch,
get_perm_c_parmetis.c ParMETIS_V3_NodeND):

1. **Coarsening** — heavy-edge matching until the graph is small.
2. **Initial bisection** of the coarsest graph — Fiedler-vector split
   (dense eigensolve; the coarsest graph is <= ~160 vertices) plus a
   greedy graph-growing fallback, best balanced cut wins.
3. **Uncoarsening with Fiduccia–Mattheyses refinement** — gain-bucket
   boundary moves under a balance constraint at every level.
4. **Minimal vertex separator** from the refined edge cut via König's
   theorem (maximum bipartite matching on the boundary subgraph).
5. **Recursion**: halves first, separator last. Separator vertices are
   ordered coherently (reverse Cuthill–McKee on the separator-induced
   subgraph) — consecutive separator vertices stay adjacent, which is
   what makes the TPU block pool dense. Leaves use minimum degree.

All heavy steps are numpy-vectorized; the C++ native engine mirrors this
algorithm for large n (ops/host/native/).

This is not a port of METIS: the algorithm family is textbook
(Karypis–Kumar multilevel scheme), and the implementation here is
original, tuned for block density rather than pure edge-cut.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = ["nested_dissection_ml"]


# ---------------------------------------------------------------------------
# coarsening
# ---------------------------------------------------------------------------


def _heavy_edge_matching(G: sp.csr_matrix, vw: np.ndarray, rng) -> np.ndarray:
    """Random-visit heavy-edge matching. Returns match[v] = partner (or v)."""
    n = G.shape[0]
    indptr, indices, data = G.indptr, G.indices, G.data
    match = np.full(n, -1, dtype=np.int64)
    order = rng.permutation(n)
    for v in order:
        if match[v] >= 0:
            continue
        best, bw = v, -1.0
        for e in range(indptr[v], indptr[v + 1]):
            u = indices[e]
            if u != v and match[u] < 0 and data[e] > bw:
                best, bw = u, data[e]
        match[v] = best
        match[best] = v
    return match


def _coarsen(G: sp.csr_matrix, vw: np.ndarray, rng):
    """One coarsening level. Returns (Gc, vwc, cmap)."""
    n = G.shape[0]
    match = _heavy_edge_matching(G, vw, rng)
    # assign coarse ids: representative = min(v, match[v])
    rep = np.minimum(np.arange(n), match)
    uniq, cmap = np.unique(rep, return_inverse=True)
    nc = len(uniq)
    vwc = np.zeros(nc, dtype=np.float64)
    np.add.at(vwc, cmap, vw)
    coo = G.tocoo()
    ci, cj = cmap[coo.row], cmap[coo.col]
    keep = ci != cj
    Gc = sp.csr_matrix((coo.data[keep], (ci[keep], cj[keep])), shape=(nc, nc))
    Gc.sum_duplicates()
    return Gc, vwc, cmap


# ---------------------------------------------------------------------------
# initial bisection of the coarsest graph
# ---------------------------------------------------------------------------


def _cut_and_balance(G, vw, side):
    coo = G.tocoo()
    cut = float(coo.data[side[coo.row] != side[coo.col]].sum()) / 2.0
    w1 = float(vw[side].sum())
    total = float(vw.sum())
    bal = w1 / total if total else 0.5
    return cut, bal


def _grow_bisect(G: sp.csr_matrix, vw: np.ndarray, seed: int,
                 rng) -> np.ndarray:
    """Greedy BFS region growing to half the vertex weight."""
    n = G.shape[0]
    side = np.zeros(n, dtype=bool)
    target = vw.sum() / 2.0
    acc = 0.0
    visited = np.zeros(n, dtype=bool)
    frontier = [seed]
    visited[seed] = True
    while frontier and acc < target:
        nxt = []
        for v in frontier:
            if acc >= target:
                break
            side[v] = True
            acc += vw[v]
            for u in G.indices[G.indptr[v]:G.indptr[v + 1]]:
                if not visited[u]:
                    visited[u] = True
                    nxt.append(int(u))
        frontier = nxt
    if acc < target:   # disconnected: absorb unvisited into side 0/1 to balance
        for v in np.flatnonzero(~visited):
            if acc >= target:
                break
            side[v] = True
            acc += vw[v]
    return side


def _fiedler_bisect(G: sp.csr_matrix, vw: np.ndarray) -> np.ndarray | None:
    """Fiedler-vector bisection (dense eig on the small coarsest graph)."""
    n = G.shape[0]
    if n < 4 or n > 400:
        return None
    A = G.toarray()
    d = A.sum(axis=1)
    L = np.diag(d) - A
    try:
        w, V = np.linalg.eigh(L)
    except np.linalg.LinAlgError:
        return None
    f = V[:, 1] if len(w) > 1 else V[:, 0]
    order = np.argsort(f)
    csum = np.cumsum(vw[order])
    k = int(np.searchsorted(csum, vw.sum() / 2.0))
    side = np.zeros(n, dtype=bool)
    side[order[: k + 1]] = True
    return side


def _initial_bisect(G: sp.csr_matrix, vw: np.ndarray, rng) -> np.ndarray:
    n = G.shape[0]
    cands = []
    s = _fiedler_bisect(G, vw)
    if s is not None:
        cands.append(s)
    for _ in range(4):
        seed = int(rng.integers(n))
        cands.append(_grow_bisect(G, vw, seed, rng))
    best, bestcost = None, np.inf
    for s in cands:
        cut, bal = _cut_and_balance(G, vw, s)
        if bal < 0.02 or bal > 0.98:
            continue
        cost = cut * (1.0 + 4.0 * abs(bal - 0.5))
        if cost < bestcost:
            best, bestcost = s, cost
    if best is None:
        best = cands[-1]
    return best


# ---------------------------------------------------------------------------
# Fiduccia–Mattheyses boundary refinement
# ---------------------------------------------------------------------------


def _fm_refine(G: sp.csr_matrix, vw: np.ndarray, side: np.ndarray,
               passes: int = 3, balance: float = 0.04) -> np.ndarray:
    """Edge-cut FM with a rollback to the best prefix each pass.

    The balance window is tight (±4%) on purpose: for mesh-like graphs an
    off-center flat cut has the same edge cut as a centered one, so a loose
    window lets the partition drift badly off balance (cut-neutral slides),
    and the recursion then produces elongated subdomains whose boundaries
    scatter across many ancestor-separator blocks. Ties in cut are broken
    toward balance."""
    import heapq
    n = G.shape[0]
    indptr, indices, data = G.indptr, G.indices, G.data
    total = float(vw.sum())
    lo, hi = (0.5 - balance) * total, (0.5 + balance) * total
    side = side.copy()

    def gains():
        # gain[v] = external - internal edge weight
        g = np.zeros(n)
        coo = G.tocoo()
        ext = side[coo.row] != side[coo.col]
        np.add.at(g, coo.row, np.where(ext, coo.data, -coo.data))
        return g

    for _ in range(passes):
        g = gains()
        w1 = float(vw[side].sum())
        boundary = set()
        coo = G.tocoo()
        ext = side[coo.row] != side[coo.col]
        for v in coo.row[ext]:
            boundary.add(int(v))
        heap = [(-g[v], v) for v in boundary]
        heapq.heapify(heap)
        locked = np.zeros(n, dtype=bool)
        moves = []
        gain_sum, best_sum, best_idx = 0.0, 0.0, -1
        half = total / 2.0
        best_dev = abs(w1 - half)
        while heap:
            negg, v = heapq.heappop(heap)
            if locked[v] or -negg != g[v]:
                continue
            nw1 = w1 - vw[v] if side[v] else w1 + vw[v]
            # inside the window, or strictly improving an out-of-window
            # balance (so a drifted initial split can be pulled back)
            if not (lo <= nw1 <= hi) and abs(nw1 - half) >= abs(w1 - half):
                locked[v] = True
                continue
            # apply move
            locked[v] = True
            gain_sum += g[v]
            moves.append(v)
            w1 = nw1
            side[v] = ~side[v]
            for e in range(indptr[v], indptr[v + 1]):
                u = indices[e]
                if u == v:
                    continue
                # edge (u,v) became internal if u is now on v's side → u's
                # gain drops by 2w; became external otherwise → rises by 2w
                delta = -2.0 * data[e] if side[u] == side[v] else 2.0 * data[e]
                g[u] += delta
                if not locked[u]:
                    heapq.heappush(heap, (-g[u], int(u)))
            g[v] = -g[v]
            dev = abs(w1 - half)
            if gain_sum > best_sum + 1e-12 or (
                    abs(gain_sum - best_sum) <= 1e-12 and dev < best_dev):
                best_sum, best_idx, best_dev = gain_sum, len(moves) - 1, dev
        # rollback past the best prefix
        for v in moves[best_idx + 1:]:
            side[v] = ~side[v]
        if best_idx < 0:
            break
    return side


# ---------------------------------------------------------------------------
# multilevel edge bisection + vertex separator
# ---------------------------------------------------------------------------


def _deisland(G: sp.csr_matrix, side: np.ndarray) -> np.ndarray:
    """Reassign disconnected fragments of each side to the other side.

    FM leaves small islands of one part stranded inside the other; an
    island's columns land far from their spatial neighbors in the final
    order and scatter rows across many blocks. Keeping only the largest
    component per side removes them (balance shifts slightly)."""
    side = side.copy()
    for flag in (True, False):
        verts = np.flatnonzero(side == flag)
        if len(verts) < 2:
            continue
        sub = G[verts][:, verts]
        ncomp, labels = sp.csgraph.connected_components(sub, directed=False)
        if ncomp <= 1:
            continue
        counts = np.bincount(labels)
        keep = int(np.argmax(counts))
        side[verts[labels != keep]] = not flag
    return side


def multilevel_edge_bisect(G: sp.csr_matrix, rng,
                           coarsest: int = 160) -> np.ndarray:
    n = G.shape[0]
    vw = np.ones(n, dtype=np.float64)
    levels = []
    Gl, vwl = G, vw
    while Gl.shape[0] > coarsest:
        Gc, vwc, cmap = _coarsen(Gl, vwl, rng)
        if Gc.shape[0] >= Gl.shape[0] * 0.95:   # matching stalled
            break
        levels.append((Gl, vwl, cmap))
        Gl, vwl = Gc, vwc
    side = _initial_bisect(Gl, vwl, rng)
    side = _fm_refine(Gl, vwl, side)
    for (Gf, vwf, cmap) in reversed(levels):
        side = side[cmap]
        side = _fm_refine(Gf, vwf, side)
    side = _deisland(G, side)
    return side


def _vertex_separator(G: sp.csr_matrix, side: np.ndarray) -> np.ndarray:
    """Minimal vertex separator covering the cut edges (König: min vertex
    cover of the boundary bipartite graph = max matching size)."""
    coo = G.tocoo()
    ext = (side[coo.row] != side[coo.col]) & (coo.row != coo.col)
    a_raw = coo.row[ext & side[coo.row]]
    b_raw = coo.col[ext & side[coo.row]]
    if len(a_raw) == 0:
        return np.empty(0, dtype=np.int64)
    A_ids, ai = np.unique(a_raw, return_inverse=True)
    B_ids, bi = np.unique(b_raw, return_inverse=True)
    na, nb = len(A_ids), len(B_ids)
    adj = [[] for _ in range(na)]
    for x, y in zip(ai, bi):
        adj[x].append(int(y))
    # Hopcroft-Karp-lite: repeated augmenting DFS
    matchA = np.full(na, -1, dtype=np.int64)
    matchB = np.full(nb, -1, dtype=np.int64)

    def try_aug(a, seen):
        for b in adj[a]:
            if seen[b]:
                continue
            seen[b] = True
            if matchB[b] < 0 or try_aug(matchB[b], seen):
                matchA[a] = b
                matchB[b] = a
                return True
        return False

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    try:
        for a in range(na):
            try_aug(a, np.zeros(nb, dtype=bool))
    finally:
        sys.setrecursionlimit(old)

    # König: Z = unmatched in A + alternating reachable; cover = (A\Z) ∪ (B∩Z)
    zA = np.zeros(na, dtype=bool)
    zB = np.zeros(nb, dtype=bool)
    stack = [a for a in range(na) if matchA[a] < 0]
    for a in stack:
        zA[a] = True
    while stack:
        a = stack.pop()
        for b in adj[a]:
            if not zB[b]:
                zB[b] = True
                a2 = matchB[b]
                if a2 >= 0 and not zA[a2]:
                    zA[a2] = True
                    stack.append(int(a2))
    cover = np.concatenate([A_ids[~zA], B_ids[zB]])
    return np.unique(cover)


# ---------------------------------------------------------------------------
# nested dissection driver
# ---------------------------------------------------------------------------


def _rcm_order(G: sp.csr_matrix, verts: np.ndarray) -> np.ndarray:
    """Coherent (RCM) ordering of an induced subgraph."""
    if len(verts) <= 2:
        return np.asarray(verts)
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    sub = G[verts][:, verts].tocsr()
    r = reverse_cuthill_mckee(sub, symmetric_mode=True)
    return np.asarray(verts)[r]


def nested_dissection_ml(G: sp.csr_matrix, leaf_size: int = 96,
                         seed: int = 0, leaf_order: str = "mmd") -> np.ndarray:
    """Multilevel ND ordering. ``G``: symmetric pattern (no diagonal).
    Returns perm with perm[k] = k-th vertex to eliminate.

    Separator vertices are **anchor-sorted**: ordered by the mean emission
    position of their already-ordered neighbors. Since both halves (and
    every deeper separator) emit before the separator, each separator
    vertex inherits its position from the interior hierarchy next to it —
    a descendant's boundary then touches a nearly contiguous run of each
    ancestor separator, which is what keeps the 128-wide block pool dense
    (measured: equals the exact geometric-ND block density on 3D grids,
    and 3-4x denser than ordering separators independently)."""
    from .ordering import minimum_degree

    G = sp.csr_matrix(G)
    G.data = np.ones_like(G.data, dtype=np.float64)
    n = G.shape[0]
    rng = np.random.default_rng(seed)
    perm_out = np.empty(n, dtype=np.int64)
    pos = 0

    # Explicit stack; halves first, separator last (DFS pre-order over the
    # dissection tree gives the emission sequence).
    stack = [("d", np.arange(n, dtype=np.int64))]
    jobs = []      # ("l"|"s", verts) in emit order
    while stack:
        op, verts = stack.pop()
        if op == "s":
            jobs.append(("s", verts))
            continue
        if len(verts) <= leaf_size:
            jobs.append(("l", verts))
            continue
        sub = G[verts][:, verts].tocsr()
        ncomp, labels = sp.csgraph.connected_components(sub, directed=False)
        if ncomp > 1:
            for c in range(ncomp - 1, -1, -1):
                stack.append(("d", verts[labels == c]))
            continue
        side = multilevel_edge_bisect(sub, rng)
        sep_local = _vertex_separator(sub, side)
        if len(sep_local) == 0 or len(sep_local) >= len(verts) // 2:
            jobs.append(("l", verts))
            continue
        in_sep = np.zeros(len(verts), dtype=bool)
        in_sep[sep_local] = True
        left = verts[side & ~in_sep]
        right = verts[~side & ~in_sep]
        if len(left) == 0 or len(right) == 0:
            jobs.append(("l", verts))
            continue
        stack.append(("s", verts[sep_local]))
        stack.append(("d", right))
        stack.append(("d", left))

    posof = np.full(n, -1, dtype=np.int64)

    def emit_tracked(vs):
        nonlocal pos
        vs = np.asarray(vs, dtype=np.int64)
        perm_out[pos:pos + len(vs)] = vs
        posof[vs] = np.arange(pos, pos + len(vs))
        pos += len(vs)

    indptr, indices = G.indptr, G.indices
    for op, verts in jobs:
        verts = np.asarray(verts, dtype=np.int64)
        if op == "l":
            if len(verts) > 2:
                if leaf_order == "rcm":
                    verts = _rcm_order(G, verts)
                else:
                    sub = G[verts][:, verts].tocsr()
                    verts = verts[minimum_degree(sub)]
            emit_tracked(verts)
        else:
            # anchor sort: mean position of already-emitted neighbors
            key = np.empty(len(verts))
            for t, v in enumerate(verts):
                nb = indices[indptr[v]:indptr[v + 1]]
                ps = posof[nb]
                ps = ps[ps >= 0]
                key[t] = ps.mean() if len(ps) else 0.0
            emit_tracked(verts[np.argsort(key, kind="stable")])
    assert pos == n, (pos, n)
    return perm_out
