"""Synthetic test matrices.

A copy of the JAX package's generators that the port's tests and
``chip_smoke.py`` use, so the two packages see identical inputs from the
same seed.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def laplacian_2d(k: int, dtype=np.float64) -> sp.csc_matrix:
    """k×k 5-point Laplacian (the g20 fixture is the 20×20 grid case)."""
    T = sp.diags([-1.0, 4.0, -1.0], [-1, 0, 1], shape=(k, k))
    I = sp.identity(k)
    A = sp.kron(I, T) + sp.kron(sp.diags([-1.0, -1.0], [-1, 1],
                                         shape=(k, k)), I)
    return sp.csc_matrix(A, dtype=dtype)


def laplacian_3d(k: int, dtype=np.float64) -> sp.csc_matrix:
    T = sp.diags([-1.0, 6.0, -1.0], [-1, 0, 1], shape=(k, k))
    I = sp.identity(k)
    A = (sp.kron(sp.kron(I, I), T)
         + sp.kron(sp.kron(I, sp.diags([-1.0, -1.0], [-1, 1], shape=(k, k))), I)
         + sp.kron(sp.kron(sp.diags([-1.0, -1.0], [-1, 1], shape=(k, k)), I), I))
    return sp.csc_matrix(A, dtype=dtype)


# ---------------------------------------------------------------------------
# Irregular (SuiteSparse-class) generators.
#
# The reference's whole test diet is irregular HB/MM matrices
# (reference: EXAMPLE/dcreate_matrix.c:1-235, TEST/pdtest.c:107-563) and
# BASELINE.md names SuiteSparse acceptance targets (audikw_1, nlpkkt80).
# This environment has no network egress, so instead of downloading we
# generate synthetic *analogs spanning the same structural classes*:
#   fem3d   — 3D Delaunay tetrahedral mesh, 3 dof/node elasticity-style
#             blocks (audikw_1 class: 3D structural FEM, natural 3-wide
#             supernodes, heavy irregular fill)
#   circuit — preferential-attachment power-law graph + diagonal coupling
#             (G3_circuit / memchip class: hub nodes, skewed degrees)
#   kkt     — saddle-point KKT system [[H Aᵀ],[A 0]] with an all-zero
#             (2,2) block (nlpkkt80 class: indefinite, zero diagonal —
#             exercises MC64 static pivoting)
#   aniso2d — strongly anisotropic 2D 5-point operator (stretched-grid
#             class: structured pattern, ill-conditioned values)
# All generators are deterministic per (n, seed).
# ---------------------------------------------------------------------------


def fem3d_delaunay(npts: int, seed: int = 0, dof: int = 3) -> sp.csc_matrix:
    """3D tetrahedral-mesh elasticity analog: vertex adjacency of a 3D
    Delaunay tetrahedralization, expanded to ``dof`` unknowns per node
    with dense dof×dof couplings and an SPD-ish diagonal shift. This is
    the audikw_1 structural class (3 dof/node, irregular 3D fill)."""
    from scipy.spatial import Delaunay
    rng = np.random.default_rng(seed)
    pts = rng.random((npts, 3))
    tri = Delaunay(pts)
    s = tri.simplices                       # (ntet, 4)
    pairs = np.vstack([s[:, [a, b]] for a in range(4) for b in range(a + 1, 4)])
    i = np.concatenate([pairs[:, 0], pairs[:, 1]])
    j = np.concatenate([pairs[:, 1], pairs[:, 0]])
    Adj = sp.coo_matrix((np.ones(len(i)), (i, j)), shape=(npts, npts)).tocsr()
    Adj.data[:] = 1.0                       # dedupe to pattern
    Adj.sum_duplicates()
    Adj.data[:] = 1.0
    if dof > 1:
        Adj = sp.kron(Adj, np.ones((dof, dof)), format="csr")
    n = npts * dof
    A = Adj.tocoo()
    vals = -rng.random(A.nnz)
    A = sp.csr_matrix((vals, (A.row, A.col)), shape=(n, n))
    d = -np.asarray(A.sum(axis=1)).ravel() + 1.0
    return sp.csc_matrix(A + sp.diags(d))


def circuit_graph(n: int, m: int = 3, seed: int = 0) -> sp.csc_matrix:
    """Circuit conductance matrix in the G3_circuit / memchip class:
    cells on a quasi-planar grid with 4-neighbor local wiring, a random
    fraction of medium-range wires (distance-decaying displacement), and
    a few high-degree hub nodes (power/clock rails). Real circuit
    matrices are mostly local with skewed hub rows — NOT expanders, so
    fill stays tractable while the degree distribution is irregular."""
    rng = np.random.default_rng(seed)
    k = int(np.ceil(np.sqrt(n)))
    ids = np.arange(n)
    x, y = ids % k, ids // k
    # local 4-neighbor wiring (with ~10% random opens)
    right = ids[(x < k - 1) & (ids + 1 < n)]
    up = ids[ids + k < n]
    src = np.concatenate([right, up])
    dst = np.concatenate([right + 1, up + k])
    keep = rng.random(len(src)) > 0.1
    src, dst = src[keep], dst[keep]
    # medium-range wires: m//2 per node on average, displacement with a
    # heavy-ish tail (geometric radius), random direction
    nw = (n * max(1, m // 2))
    ws = rng.integers(0, n, size=nw)
    r = (2 + rng.geometric(0.25, size=nw)).astype(np.int64)
    ang = rng.random(nw) * 2 * np.pi
    wx = (ws % k + np.round(r * np.cos(ang))).astype(np.int64) % k
    wy = (ws // k + np.round(r * np.sin(ang))).astype(np.int64)
    wd = (wy % ((n + k - 1) // k)) * k + wx
    ok = (wd < n) & (wd != ws)
    src = np.concatenate([src, ws[ok]])
    dst = np.concatenate([dst, wd[ok]])
    # hub rails: ~n/2000 hubs each strapping ~64 random cells
    nhub = max(1, n // 2000)
    hubs = rng.choice(n, size=nhub, replace=False)
    hs = np.repeat(hubs, 64)
    hd = rng.integers(0, n, size=len(hs))
    ok = hs != hd
    src = np.concatenate([src, hs[ok]])
    dst = np.concatenate([dst, hd[ok]])
    w = -(0.1 + rng.random(len(src)))
    G = sp.coo_matrix((np.concatenate([w, w]),
                       (np.concatenate([src, dst]),
                        np.concatenate([dst, src]))), shape=(n, n)).tocsr()
    G.sum_duplicates()
    d = -np.asarray(G.sum(axis=1)).ravel() + 0.01
    return sp.csc_matrix(G + sp.diags(d))


def kkt_system(n_primal: int, n_con: int | None = None,
               seed: int = 0) -> sp.csc_matrix:
    """Saddle-point KKT matrix [[H Aᵀ],[A 0]] from a grid-structured QP —
    the nlpkkt80 class. The (2,2) block is exactly zero: every constraint
    row has a zero diagonal, so a static row permutation (MC64) is
    *required* for GESP to factor it."""
    rng = np.random.default_rng(seed)
    if n_con is None:
        n_con = n_primal // 2
    k = max(2, int(np.sqrt(n_primal)))
    H = laplacian_2d(k).tocoo()
    H = sp.coo_matrix((H.data, (H.row, H.col)), shape=(k * k, k * k))
    npr = k * k
    # sparse constraint Jacobian: each constraint couples 3 primals. The
    # anchor column is a DISTINCT primal per constraint (drawn without
    # replacement) so a perfect matching exists structurally — random
    # anchors collide and violate Hall's condition at this density.
    n_con = min(n_con, npr)
    rows = np.repeat(np.arange(n_con), 3)
    base = rng.permutation(npr)[:n_con]
    cols = (base[:, None] + np.array([0, 1, k])[None, :]).ravel() % npr
    Av = rng.standard_normal(3 * n_con) + 0.5
    Acon = sp.coo_matrix((Av, (rows, cols)), shape=(n_con, npr)).tocsr()
    Acon.sum_duplicates()
    K = sp.bmat([[H.tocsr() + sp.identity(npr), Acon.T],
                 [Acon, None]], format="csc")
    K.sort_indices()
    return sp.csc_matrix(K)


def aniso2d(k: int, eps: float = 1e-3) -> sp.csc_matrix:
    """Anisotropic 2D operator −u_xx − eps·u_yy on a k×k grid: structured
    pattern, strongly graded values (conditioning stress; the atmosmodd /
    stretched-mesh class)."""
    T = sp.diags([-1.0, 2.0 + 2.0 * eps, -1.0], [-1, 0, 1], shape=(k, k))
    I = sp.identity(k)
    A = sp.kron(I, T) + sp.kron(
        sp.diags([-eps, -eps], [-1, 1], shape=(k, k)), I)
    return sp.csc_matrix(A)


def unsymmetric_pattern(n: int, seed: int = 0) -> sp.csc_matrix:
    """Strongly unsymmetric matrix exercising the row-permutation path:
    small diagonal, large off-diagonal entries (MC64 must fix the diagonal)."""
    rng = np.random.default_rng(seed)
    A = sp.random(n, n, density=min(0.05, 20.0 / n), random_state=rng,
                  format="lil", dtype=np.float64)
    A.setdiag(rng.standard_normal(n) * 1e-3)
    perm = rng.permutation(n)
    for i in range(n):
        A[i, perm[i]] = 10.0 + rng.random()
    return sp.csc_matrix(A)
