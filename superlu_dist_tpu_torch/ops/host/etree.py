"""Column elimination tree and postorder.

Analog of ``sp_coletree_dist`` / ``TreePostorder_dist`` (reference:
SRC/prec-independent/etree.c:1-431). The column etree of A is the elimination
tree of A^T A, computed without forming A^T A by threading each row's column
list through the path-compression scan (Gilbert–Ng–Peyton; the standard
algorithm as presented in Davis, "Direct Methods for Sparse Linear Systems").
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = ["col_etree", "postorder", "tree_levels"]


def col_etree(A: sp.spmatrix) -> np.ndarray:
    """Column elimination tree: parent[j] of each column, -1 for roots."""
    A = sp.csc_matrix(A)
    n = A.shape[1]
    Ap, Ai = A.indptr, A.indices
    parent = np.full(n, -1, dtype=np.int64)
    ancestor = np.full(n, -1, dtype=np.int64)
    prev_col = np.full(A.shape[0], -1, dtype=np.int64)  # per row
    for k in range(n):
        for p in range(Ap[k], Ap[k + 1]):
            r = Ai[p]
            i = prev_col[r]
            # walk up with path compression
            while i != -1 and i < k:
                inext = ancestor[i]
                ancestor[i] = k
                if inext == -1:
                    parent[i] = k
                i = inext
            prev_col[r] = k
    return parent


def postorder(parent: np.ndarray) -> np.ndarray:
    """Postorder the forest; returns post with post[k] = k-th vertex visited."""
    n = len(parent)
    # children lists
    head = np.full(n, -1, dtype=np.int64)
    nxt = np.full(n, -1, dtype=np.int64)
    for v in range(n - 1, -1, -1):
        p = parent[v]
        if p >= 0:
            nxt[v] = head[p]
            head[p] = v
    post = np.empty(n, dtype=np.int64)
    cnt = 0
    stack = []
    for root in range(n):
        if parent[root] != -1:
            continue
        stack.append(root)
        while stack:
            v = stack[-1]
            c = head[v]
            if c != -1:
                head[v] = nxt[c]       # remove child from list
                stack.append(c)
            else:
                post[cnt] = v
                cnt += 1
                stack.pop()
    assert cnt == n, "parent array is not a forest"
    return post


def tree_levels(parent: np.ndarray) -> np.ndarray:
    """Topological level of each vertex: leaves at the deepest levels.

    level[v] = 1 + max(level of children), leaves = 0 — the level sets used
    for batched scheduling (analog of ``topological_ordering``,
    reference: SRC/prec-independent/supernodal_etree.c:59).
    """
    n = len(parent)
    level = np.zeros(n, dtype=np.int64)
    # process in an order where children precede parents: vertices are not
    # guaranteed sorted, so iterate via postorder
    for v in postorder(parent):
        p = parent[v]
        if p >= 0:
            level[p] = max(level[p], level[v] + 1)
    return level
