"""Synthetic test matrices and the pdtest residual test.

A copy of the JAX package's generators that the port's tests and
``chip_smoke.py`` use, so the two packages see identical inputs from the
same seed, and of its ``THRESH`` and ``compute_resid`` (the reference's
TEST/pdtest.c acceptance test), which the card tests use without JAX,
and of ``reference_matrix`` (the reference's fixture files, read by
``utils/io.py``). ``backward_error`` lives in ``utils/norms.py`` and is
re-exported here.
"""

from __future__ import annotations

import os

import numpy as np
import scipy.sparse as sp

from .norms import backward_error  # noqa: F401  (re-exported)

#: the reference's EXAMPLE fixtures (g4.rua, g20.rua, big.rua, cg20.cua),
#: read only where ``SLU_TPU_REFERENCE_EXAMPLES`` names their directory
REFERENCE_EXAMPLE_DIR = os.environ.get("SLU_TPU_REFERENCE_EXAMPLES")


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


def laplacian_3d_unsym(k: int, seed: int = 1) -> sp.csc_matrix:
    """``laplacian_3d(k)`` with unsymmetric values: every off-diagonal
    entry times an independent ``default_rng(seed).uniform(0.5, 1.0)``
    draw, the diagonal kept at 6. Strictly diagonally dominant, with the
    7-point pattern (so the plan of ``laplacian_3d(k)``); a transpose left
    out of a solve shows, as it would not on the symmetric operator."""
    A = sp.coo_matrix(laplacian_3d(k))
    off = A.row != A.col
    data = A.data.copy()
    data[off] *= np.random.default_rng(seed).uniform(0.5, 1.0,
                                                     int(off.sum()))
    return sp.csc_matrix((data, (A.row, A.col)), shape=A.shape)


def helmholtz_3d(k: int, kappa2: float = 2.0, sigma: float = 0.5,
                 dtype=np.complex64) -> sp.csc_matrix:
    """Complex shifted 3D Helmholtz operator −Δ − (κ² + iσ)I on a k³
    grid — the production-scale complex benchmark class (the z-precision
    suite's workload; reference: SRC/complex16/pzgstrf.c). The complex
    shift makes the operator invertible and genuinely complex-valued."""
    A = laplacian_3d(k, dtype=np.float64).astype(np.complex128)
    n = A.shape[0]
    A = A - sp.identity(n) * (kappa2 + 1j * sigma)
    return sp.csc_matrix(A, dtype=dtype)


def laplacian_arrowhead(k: int = 6, seed: int = 1) -> sp.csc_matrix:
    """``k`` disjoint 16×16-grid Laplacians (two 128-blocks each) and a
    128-wide random coupling border: at block size 128 many elimination
    steps per level update shared ancestor blocks (the "bushy" fixture of
    the JAX package's tests/test_pallas.py, on which its single-buffered
    Pallas Schur kernel lost contributions)."""
    D = sp.block_diag([laplacian_2d(16) for _ in range(k)], format="lil")
    n_inner = D.shape[0]
    m = 128
    rng = np.random.default_rng(seed)
    B = sp.lil_matrix((n_inner, m))
    C = sp.lil_matrix((m, n_inner))
    for j in range(m):
        for _ in range(3):
            i = rng.integers(0, n_inner)
            B[i, j] = rng.standard_normal()
            C[j, i] = rng.standard_normal()
    E = sp.lil_matrix(np.eye(m) * 50.0)
    return sp.csc_matrix(sp.bmat([[D, B], [C, E]], format="csc"))


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


def reference_matrix(name: str):
    """Load a fixture matrix from ``REFERENCE_EXAMPLE_DIR``, or None where
    that is unset or does not hold ``name``."""
    if REFERENCE_EXAMPLE_DIR is None:
        return None
    path = os.path.join(REFERENCE_EXAMPLE_DIR, name)
    if not os.path.exists(path):
        return None
    from .io import read_matrix
    return read_matrix(path)


def _fixed(vals, fmt: str, per_line: int) -> list:
    """Lines of ``vals``, each ``fmt``-formatted, ``per_line`` a line."""
    return ["".join(fmt % v for v in vals[i:i + per_line])
            for i in range(0, len(vals), per_line)]


def write_hb(path, A, mxtype: str = "RUA", rb: bool = False) -> None:
    """Write CSC ``A`` as a Harwell-Boeing file (with ``rb``, as a
    Rutherford-Boeing one) that keeps the format's fixed field widths:
    pointers and indices (10I8), values (3E25.16, which round-trips
    float64). ``scipy.io.hb_write`` writes its values one character
    narrower than the format it declares, which ``utils/io.py`` (as the
    reference's dreadhb) refuses. For a symmetric ``mxtype`` ``A`` holds
    the lower triangle; a complex one writes (re, im) pairs."""
    A = sp.csc_matrix(A)
    ptr = _fixed(A.indptr + 1, "%8d", 10)
    ind = _fixed(A.indices + 1, "%8d", 10)
    data = A.data
    if mxtype[0] in "Cc":
        data = np.column_stack([data.real, data.imag]).reshape(-1)
    val = _fixed(np.asarray(data, dtype=np.float64), "%25.16E", 3)
    counts = (f"{len(ptr) + len(ind) + len(val):14d}{len(ptr):14d}"
              f"{len(ind):14d}{len(val):14d}")
    fmts = f"{'(10I8)':<16}{'(10I8)':<16}{'(3E25.16)':<20}"
    lines = [f"{'test matrix':<72}{'KEY':<8}",
             counts if rb else counts + f"{0:14d}",
             f"{mxtype:<14}{A.shape[0]:14d}{A.shape[1]:14d}{A.nnz:14d}"
             f"{0:14d}",
             fmts if rb else fmts + f"{'':<20}"]
    with open(path, "w") as f:
        f.write("\n".join(lines + ptr + ind + val) + "\n")


#: acceptance threshold for the residual test value
#: (reference: TEST/pdtest.c:44 ``#define THRESH 20.0``)
THRESH = 20.0


def compute_resid(A, x, b, work_dtype=np.float64) -> float:
    """Residual test value ‖b−Ax‖∞ / (‖A‖∞·‖x‖∞·n·eps) — must be < THRESH.

    Mirrors ``pdcompute_resid`` (reference: TEST/pdcompute_resid.c:83-151).
    ``work_dtype`` sets eps: the working precision of the solve being tested
    (float32 for an unrefined single-precision factorization).
    """
    A = sp.csc_matrix(A)
    x = np.asarray(x, dtype=np.result_type(A.dtype, np.float64))
    b = np.asarray(b, dtype=x.dtype)
    n = A.shape[0]
    wd = np.dtype(work_dtype)
    if wd.kind == "c":
        wd = np.dtype(np.float32) if wd.itemsize == 8 else np.dtype(np.float64)
    eps = np.finfo(wd).eps
    anorm = np.max(np.abs(A).sum(axis=1))
    r = b - A @ x
    rnorm = np.max(np.abs(r))
    xnorm = np.max(np.abs(x))
    if anorm == 0 or xnorm == 0:
        return np.inf if rnorm > 0 else 0.0
    return float(rnorm / (anorm * xnorm * n * eps))

