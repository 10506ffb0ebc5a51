"""Etree-aligned block boundaries: the scalable large-n schedule.

The block planner quantizes columns into fixed B-wide blocks *by position*.
Under a nested-dissection ordering, position blocks straddle the boundaries
between independent subtrees and the separators above them, so nearly every
block column transitively depends on the previous one and the elimination
schedule collapses to a serial chain (970 of 972 levels held one block at
n=125k). The reference never has this problem because its supernodes follow
the etree (relaxed supernodes, symbfact.c:238-272) and its schedule comes
from the supernodal etree's topological levels (reference:
SRC/prec-independent/supernodal_etree.c:32-1099, dstatic_schedule.c:46).

This module restores that structure on the TPU side without giving up the
fixed B×B block pool: a *column expansion* pass that

1. computes the column elimination tree of the permuted matrix and applies
   its postorder (a legal equivalent reordering — exactly what the
   reference's ``sp_colorder`` does, reference: SRC/prec-independent/
   sp_colorder.c),
2. partitions the postordered columns into *units*: maximal complete
   subtrees of ≤ B columns ("domains") and single chain nodes whose subtree
   exceeds B ("separator" skeleton),
3. packs units into B-wide blocks — domain units bin-packed together
   (disjoint subtrees are independent, so any of them may share a block),
   chain nodes packed into consecutive run blocks, never mixing the two —
   and pads each block's tail with decoupled identity columns.

Block columns made of complete subtrees then depend only on blocks strictly
above them in the tree, so the elimination level schedule recovers the
etree's parallelism: independent domains factor as one batched level.

The expansion costs padding columns (bounded by ``max_inflate``); pad
columns carry a unit diagonal only, so they add no GEMM work and no solve
work — only pool slots inside blocks that already exist.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .etree import postorder

__all__ = ["aligned_blocking", "expand_matrix", "sym_etree", "AlignResult"]


def sym_etree(A: sp.spmatrix) -> np.ndarray:
    """Elimination tree of the symmetrized pattern ``A + Aᵀ`` (Liu's
    algorithm with path compression).

    For LU *without* runtime pivoting (GESP static pivoting), fill is
    bounded by the Cholesky fill of the symmetrized pattern (George/Ng), so
    this — not the column etree of AᵀA, which is the partial-pivoting
    bound — is the dependency structure the block schedule must follow.
    Mirrors the symmetric-pattern branch of the reference's etree use
    (reference: SRC/prec-independent/etree.c, get_perm_c.c AT_PLUS_A path).
    """
    A = sp.csc_matrix(A)
    P = sp.csc_matrix(
        (np.ones(A.nnz, dtype=np.int8), A.indices, A.indptr), shape=A.shape)
    S = sp.csc_matrix(P + P.T)   # pattern-only: values cannot cancel
    n = S.shape[0]
    # native fast path (tree.cpp — the same Liu algorithm in C++;
    # measured ~1 s of Python pointer chasing at n=125k)
    from .native import native_tree_counts
    L = sp.tril(S, k=-1, format="csc")
    nat = native_tree_counts(L.indptr, L.indices)
    if nat is not None:
        return nat[0]
    Sp, Si = S.indptr, S.indices
    parent = np.full(n, -1, dtype=np.int64)
    ancestor = np.full(n, -1, dtype=np.int64)
    for k in range(n):
        for p in range(Sp[k], Sp[k + 1]):
            i = Si[p]
            while i != -1 and i < k:
                inext = ancestor[i]
                ancestor[i] = k
                if inext == -1:
                    parent[i] = k
                i = inext
    return parent


class AlignResult:
    """Postorder + expansion map produced by :func:`aligned_blocking`."""

    __slots__ = ("po", "expand", "n_e", "n_blocks", "n_domain_units")

    def __init__(self, po, expand, n_e, n_blocks, n_domain_units):
        self.po = po            # (n,) postorder permutation of columns
        self.expand = expand    # (n,) padded position of postordered col t
        self.n_e = n_e          # expanded dimension (n_blocks * bs)
        self.n_blocks = n_blocks
        self.n_domain_units = n_domain_units


def _subtree_sizes(parent_t: np.ndarray) -> np.ndarray:
    """Subtree sizes for a postorder-labeled forest (children < parent)."""
    n = len(parent_t)
    sz = np.ones(n, dtype=np.int64)
    for t in range(n):
        p = parent_t[t]
        if p >= 0:
            sz[p] += sz[t]
    return sz


def aligned_blocking(A: sp.spmatrix, bs: int,
                     max_inflate: float = 1.5) -> AlignResult | None:
    """Compute the etree-aligned expansion for (already permuted) ``A``.

    Returns ``None`` when alignment is a no-op or too costly: the matrix is
    tiny (≤ 2 blocks), or the padded dimension would exceed ``max_inflate``
    times the unaligned padded dimension.
    """
    n = A.shape[0]
    if n <= 2 * bs:
        return None
    parent = sym_etree(A)
    po = postorder(parent)
    ipo = np.empty(n, dtype=np.int64)
    ipo[po] = np.arange(n)
    parent_t = np.where(parent[po] >= 0, ipo[parent[po].clip(min=0)], -1)
    sz = _subtree_sizes(parent_t)

    # maximal small roots: subtree fits in one block, parent's does not
    psz = np.where(parent_t >= 0, sz[parent_t.clip(min=0)], n + 1)
    small_root = (sz <= bs) & (psz > bs)
    # unit starting at postorder position t (or -1 → chain node)
    first_unit = np.full(n, -1, dtype=np.int64)
    roots = np.flatnonzero(small_root)
    first_unit[roots - sz[roots] + 1] = roots

    # walk the postorder into units: ('S', start, size) | ('U', start, 1)
    units: list[tuple[str, int, int]] = []
    t = 0
    while t < n:
        v = first_unit[t]
        if v >= 0:
            units.append(("S", t, int(sz[v])))
            t = int(v) + 1
        else:
            units.append(("U", t, 1))
            t += 1

    # Sequential greedy packing over contiguous postorder segments. Every
    # block is a postorder interval, so the only reorder is the postorder
    # itself (fill-preserving) and the expansion keeps locality. Cut rules:
    #   1. overflow — the next unit does not fit in the block;
    #   2. region change — a domain unit never joins a block that already
    #      holds a chain node. Chain nodes following domains are their
    #      ancestors (postorder contiguity), so absorbing them is the
    #      relaxed-supernode amalgamation of the reference
    #      (symbfact.c:238-272 relax_snode); but a *domain* after a chain
    #      run starts an unrelated region — packing it behind the previous
    #      region's separator would re-serialize the schedule.
    blocks: list[list[tuple[int, int]]] = []   # block -> [(start, size)]
    n_domain_units = 0
    cur: list[tuple[int, int]] = []
    cur_used = 0
    cur_has_chain = False
    for kind, start, size in units:
        if kind == "S":
            n_domain_units += 1
        cut = cur_used + size > bs or (kind == "S" and cur_has_chain)
        if cut and cur:
            blocks.append(cur)
            cur, cur_used, cur_has_chain = [], 0, False
        if kind == "U" and cur and cur[-1][0] + cur[-1][1] == start:
            cur[-1] = (cur[-1][0], cur[-1][1] + size)   # extend interval
        else:
            cur.append((start, size))
        cur_used += size
        cur_has_chain = cur_has_chain or kind == "U"
    if cur:
        blocks.append(cur)

    n_blocks = len(blocks)
    n_e = n_blocks * bs
    nb_plain = -(-n // bs)
    if n_e > max_inflate * nb_plain * bs:
        return None

    expand = np.empty(n, dtype=np.int64)
    for b, intervals in enumerate(blocks):
        off = b * bs
        for start, size in intervals:
            expand[start:start + size] = np.arange(off, off + size)
            off += size
    return AlignResult(po, expand, n_e, n_blocks, n_domain_units)


def expand_matrix(A: sp.spmatrix, expand: np.ndarray,
                  n_e: int) -> sp.csc_matrix:
    """Scatter ``A`` into the expanded dimension; pad positions get a unit
    diagonal (decoupled identity columns — no fill, no flops)."""
    A = sp.coo_matrix(A)
    n = A.shape[0]
    present = np.zeros(n_e, dtype=bool)
    present[expand] = True
    pad = np.flatnonzero(~present)
    rows = np.concatenate([expand[A.row], pad])
    cols = np.concatenate([expand[A.col], pad])
    data = np.concatenate([A.data, np.ones(len(pad), dtype=A.data.dtype)])
    return sp.csc_matrix((data, (rows, cols)), shape=(n_e, n_e))
