"""Debug / inspection utilities.

Analogs of the reference's dutil_dist.c helpers (reference:
SRC/double/dutil_dist.c:26-1000 dPrint_*, CheckZeroDiagonal,
distCheckArray; env-gated LU dump via WRITELU/LUFILE): reconstruct dense
L/U from the block pool, dump/compare factors, and sanity checks. A copy
of the JAX package's ``utils/debug.py`` on the port's factor: the pool,
``linv`` and ``uinv`` are torch tensors (on the card or the CPU), read
with ``.cpu().numpy()``. The pool holds ``nslots + 2`` blocks (no bucket
padding), slot ``s`` at row ``s`` as in the JAX package; a complex pool is
native complex; under ``SLU_TPU_COMPLEX=embed`` it is the float32 factor
of the 2n real rows, which :func:`lu_to_dense` returns as it stands.

The driver runs two of them after every factor when asked to
(``SparseLU._debug_hooks``): ``SLU_TPU_CHECKLU=1`` records
:func:`check_factorization` in ``stat.counters["checklu_max_resid"]`` and
``SLU_TPU_WRITELU=<path>`` calls :func:`dump_lu`.
"""

from __future__ import annotations

import numpy as np


def _host(t, grid=None) -> np.ndarray:
    """A factor array on the host. A grid's list of per-rank tensors is
    stacked in the grid's shape, each rank's blocks padded with zero
    blocks to the longest (the JAX package's sharded pool is one array
    of that shape)."""
    if not isinstance(t, (list, tuple)):
        return t.detach().cpu().numpy()
    ranks = [_host(r) for r in t]
    rows = max(r.shape[0] for r in ranks)
    out = np.zeros((len(ranks), rows) + ranks[0].shape[1:],
                   dtype=ranks[0].dtype)
    for i, r in enumerate(ranks):
        out[i, : r.shape[0]] = r
    return out.reshape(tuple(grid.shape) + out.shape[1:]) if grid else out


def _pool(lu) -> np.ndarray:
    """The single-device pool (slot s at row s) on the host."""
    if isinstance(lu.pool, (list, tuple)):
        raise ValueError(
            "the factor of a process grid is sharded over its ranks; "
            "lu_to_dense reads a single-device pool (the JAX package's "
            "refuses the grid's sharded pool too)")
    return _host(lu.pool)


def lu_to_dense(lu):
    """Reconstruct dense (L, U) from a factored SparseLU (small matrices;
    debugging only). L unit-lower, U upper, of the permuted system
    Pc·Pr·Dr·A·Dc·Pcᵀ."""
    plan = lu.plan
    bs, n = plan.bs, plan.n_pad
    pool = _pool(lu)
    M = np.zeros((n, n), dtype=pool.dtype)
    for s in range(plan.nslots):
        I, J = int(plan.slot_row[s]), int(plan.slot_col[s])
        M[I * bs:(I + 1) * bs, J * bs:(J + 1) * bs] = pool[s]
    L = np.tril(M, -1) + np.eye(n, dtype=M.dtype)
    U = np.triu(M)
    return L[: plan.n, : plan.n], U[: plan.n, : plan.n]


def check_factorization(lu, A3=None, tol=1e-3) -> float:
    """‖L·U − A3‖ / ‖A3‖ for the permuted system (CheckLU analog, env
    CHECKLU in the reference). Returns the relative error. Without
    ``A3`` it is rebuilt from the original matrix, the scalings, the
    permutations and the alignment's expansion (and ring-embedded where
    the factor is)."""
    import scipy.sparse as sp
    if A3 is None:
        A3 = lu._A_orig.multiply(lu.row_scale[:, None]) \
            .multiply(lu.col_scale[None, :]).tocsc()
        A3 = A3[lu.rowperm, :][lu.colperm, :][:, lu.colperm]
        A3 = lu._expand_A(sp.csc_matrix(A3))   # etree-aligned blocking
        if getattr(lu, "_embed", False):
            from ..models.driver import _embed_csc
            A3 = _embed_csc(A3)
    L, U = lu_to_dense(lu)
    R = L @ U - sp.csc_matrix(A3).toarray()
    rel = float(np.abs(R).max() / max(np.abs(A3.data).max(), 1e-300))
    return rel


def check_zero_diagonal(lu, tol=0.0):
    """Indices of (near-)zero diagonal entries of U (CheckZeroDiagonal
    analog, superlu_defs.h:1205)."""
    d = np.abs(lu.diag_u())
    return np.flatnonzero(d <= tol * max(1.0, d.max()))


def dump_lu(lu, path):
    """Persist the factored state (WRITELU/LUFILE analog). A grid's
    per-rank factors are written stacked in the grid's shape."""
    grid = getattr(lu, "grid", None)
    np.savez_compressed(
        path,
        pool=_host(lu.pool, grid), linv=_host(lu.linv, grid),
        uinv=_host(lu.uinv, grid), rowperm=lu.rowperm, colperm=lu.colperm,
        row_scale=lu.row_scale, col_scale=lu.col_scale,
        slot_row=lu.plan.slot_row, slot_col=lu.plan.slot_col, n=lu.n,
        bs=lu.plan.bs)


def compare_lu(path_a, path_b, rtol=1e-6) -> bool:
    """Compare two dumped factorizations (distCheckArray analog)."""
    a, b = np.load(path_a), np.load(path_b)
    for k in ("pool", "rowperm", "colperm"):
        if a[k].shape != b[k].shape:
            return False
        if k == "pool":
            if not np.allclose(a[k], b[k], rtol=rtol, atol=rtol):
                return False
        elif not np.array_equal(a[k], b[k]):
            return False
    return True


def print_block(lu, I: int, J: int, file=None) -> None:
    """Pretty-print one B×B block of the factor (dPrint_Dense_Matrix-style
    inspection, reference: SRC/double/dutil_dist.c dPrint_* helpers). The
    port's pool is never planar: a planar complex state is made native by
    ``SparseLU.from_numpy_state``."""
    import sys
    plan = lu.plan
    out = file or sys.stdout
    srow = np.asarray(plan.slot_row)
    scol = np.asarray(plan.slot_col)
    hit = np.flatnonzero((srow == I) & (scol == J))
    if not len(hit):
        print(f"block ({I},{J}): structurally zero", file=out)
        return
    blk = _host(lu.pool[int(hit[0])])
    print(f"block ({I},{J}) slot {int(hit[0])}:", file=out)
    with np.printoptions(precision=4, suppress=True, linewidth=120):
        print(blk, file=out)


def lu_summary(lu) -> str:
    """One-paragraph structural summary of a factorization (the
    PStatPrint-adjacent dQuerySpace role): dimensions, block structure,
    schedule shape, memory."""
    plan = lu.plan
    lev = np.asarray(plan.step_level)
    counts = np.bincount(lev, minlength=plan.n_flevels)
    lines = [
        f"n={lu.n} (padded {plan.n_pad}, expansion "
        f"{'on' if getattr(lu, '_expand', None) is not None else 'off'})",
        f"block size {plan.bs}, {plan.nb} block columns, "
        f"{plan.nslots} stored blocks ({plan.a_blocks} from A)",
        f"elimination levels {plan.n_flevels} "
        f"(serial {int(np.sum(counts == 1))}, "
        f"mean steps/level {plan.nb / plan.n_flevels:.2f}, "
        f"max {int(counts.max())})",
        f"solve levels L={plan.lsol_nlvl} U={plan.usol_nlvl}",
        f"pool {plan.pool_bytes(lu._fdtype) / 2**20:.1f} "
        f"MiB, model flops {plan.factor_flops:.3e}",
    ]
    return "\n".join(lines)


def dump_pattern(lu, path) -> None:
    """Write the filled block pattern as a PBM bitmap (block row/col
    occupancy) for eyeballing fill — the dPrint_CompCol role at block
    granularity."""
    plan = lu.plan
    nb = plan.nb
    grid = np.zeros((nb, nb), dtype=np.uint8)
    grid[np.asarray(plan.slot_row), np.asarray(plan.slot_col)] = 1
    with open(path, "w") as f:
        f.write(f"P1\n{nb} {nb}\n")
        for r in range(nb):
            f.write(" ".join("1" if v else "0" for v in grid[r]) + "\n")
