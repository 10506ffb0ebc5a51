"""Batched many-matrix interface, in PyTorch on one CUDA device.

Port of the JAX package's ``models/batch.py``, with its two paths:

1. **Same-pattern batch** (:class:`BatchedSparseLU`): N matrices with one
   sparsity pattern share the preprocessing of the first (row and column
   permutations, etree alignment, the symbolic plan and every tape), and
   each keeps its own equilibration and tiny-pivot threshold
   (SamePattern_SameRowPerm semantics; the first also keeps the MC64 duals
   its row permutation came with). Their pools are stacked on a leading
   member axis and factored together by the level executor's kernels
   with a member axis (``schur.factor_batch``: one launch per level per
   phase for every member, where the JAX package runs one ``jax.vmap`` of
   its level core), and solved together by the batched NOTRANS sweep
   (``solve_gemm.solve_batch``). The counterpart of the reference's MAGMA
   vbatched factorization (CplusplusFactor/batch_factorize.cu:544-592).
2. **Block-diagonal composite** (:func:`gssvx_batch`): heterogeneous
   matrices are each equilibrated, statically pivoted and ordered (the
   dequil_batch / dpivot_batch / get_perm_c_batch pipeline,
   pdgssvx3d_csc_batch.c:80-503), assembled into one block-diagonal
   system and factored in one call by :class:`SparseLU`, by
   :class:`DistributedSparseLU` over a ``Grid2D``, or by
   :class:`Distributed3DSparseLU` over a ``Grid3D``; the solutions are
   split back per matrix.

Deliberate differences from the JAX package:

- The batch factors on the level executor's kernels whatever
  ``executor`` names (the JAX package vmaps its XLA level core whatever
  the executor), and always in the native element type: complex64 is not
  ring-embedded here.
- The first matrix's prototype (which carries the shared preprocessing,
  plan and tapes) builds its tapes and launches no kernel; ``stat``'s
  ``FACT`` phase times the batched factor of every member.
- The refinement residuals of every member run on the device at once,
  through one block-diagonal COO (``ops/spmv.py``), with the JAX
  package's stop rule (every berr ≤ 4·eps, or ``max_refine_steps``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import scipy.sparse as sp
import torch

from ..ops import blocklu as _blocklu
from ..ops import spmv as _spmv
from ..ops.host import equil as _equil
from ..ops.host import mc64 as _mc64
from ..ops.host import ordering as _ordering
from ..ops.kernels import schur as _schur
from ..ops.kernels import solve_gemm as _solve_gemm
from ..parallel.grid import Grid3D
from ..utils.norms import backward_error
from ..utils.options import (ColPerm, Equil, IterRefine, Options, RowPerm,
                             apply_env_overrides)
from ..utils.stats import Stats
from .driver import _TORCH, SolveResult, SparseLU


class _Prototype(SparseLU):
    """The first matrix of a batch, which carries the shared
    preprocessing, plan and tapes, native (no ring embedding). It launches
    no kernel: the batch factors every member, the first included."""

    _embed_ok = False

    def _device_factor(self, A3: sp.csc_matrix):
        self.pool = self.linv = self.uinv = None
        with self.stat.phase("DIST"):
            self._factor_tapes(A3)


class BatchedSparseLU:
    """Factor a batch of same-pattern matrices together. ``pool_b``,
    ``linv_b`` and ``uinv_b`` stack the members' factors on a leading axis
    of ``count``; ``row_scales``/``col_scales`` are (count, n)."""

    #: the batch factors on the level executor's kernels at full
    #: precision ("highest", whatever ``gemm_precision`` says, as the JAX
    #: package's batch runs no fused kernel) and never escalates
    _escalate_ok = False

    def __init__(self, As: Sequence[sp.spmatrix],
                 options: Optional[Options] = None, *, device=None):
        if not As:
            raise ValueError("empty batch")
        self.options = apply_env_overrides(options or Options())
        self.count = len(As)
        # the shared preprocessing (and tapes of the level executor and
        # the sweeps) from the first matrix, under its own Stats
        p = self._proto = _Prototype(As[0], self.options.replace(
            iter_refine=IterRefine.NOREFINE, executor="pallas"),
            device=device)
        self.device = p.device
        self.stat = Stats()
        self.stat.device = self.device
        self.n, self.plan, self.dtype = p.n, p.plan, p.dtype
        ref = sp.csc_matrix(As[0])
        self._As = [ref]
        rows = [p.row_scale]
        cols = [p.col_scale]
        threshs = [p._thresh()]
        eps = float(np.finfo(self.dtype).eps)
        for A in As[1:]:
            Ac = sp.csc_matrix(A)
            if (not np.array_equal(Ac.indptr, ref.indptr)
                    or not np.array_equal(Ac.indices, ref.indices)):
                raise ValueError(
                    "BatchedSparseLU requires identical sparsity patterns; "
                    "use gssvx_batch for heterogeneous matrices")
            if self.options.equil == Equil.YES:
                _, R, C, _ = _equil.equilibrate(Ac)
            else:
                R = C = np.ones(self.n)
            rows.append(np.asarray(R))
            cols.append(np.asarray(C))
            A3 = Ac.multiply(R[:, None]).multiply(C[None, :]).tocsc()
            threshs.append(np.sqrt(eps) * float(np.abs(A3.data).max())
                           if self.options.replace_tiny_pivot and A3.nnz
                           else 0.0)
            self._As.append(Ac)
        self.row_scales = np.stack(rows)
        self.col_scales = np.stack(cols)
        plan, dev = self.plan, self.device
        pool_b = torch.empty((self.count, plan.nslots + 2, plan.bs, plan.bs),
                             dtype=_TORCH[self.dtype], device=dev)
        for m, A in enumerate(self._As):
            pool_b[m] = self._pool_values(A, rows[m], cols[m])
        self.stat.peak_buffer_bytes = self.count * plan.pool_bytes(
            self.dtype)
        #: the members' tiny-pivot thresholds, on the device
        self.thresh = torch.as_tensor(np.asarray(threshs), device=dev,
                                      dtype=pool_b.real.dtype)
        with self.stat.phase("FACT"):
            self.pool_b, self.linv_b, self.uinv_b, tiny = \
                _schur.factor_batch(pool_b, self.thresh, p._ftapes, plan.nb)
        self.stat.ops["FACT"] += self.count * plan.factor_flops
        self.tiny = tiny.cpu().numpy()
        self.stat.tiny_pivots += int(self.tiny.sum())
        self.stat.counters["executor"] = "pallas"
        self.stat.counters["gemm_precision"] = "highest"
        self.stat.counters["batch_count"] = self.count
        # the debug hooks audit the first member's factor, as the JAX
        # package's run on its prototype's factor of As[0]; the counter
        # lands in the batch's Stats too (the JAX package's prototype
        # shares them)
        p.pool, p.linv, p.uinv = self.pool_b[0], self.linv_b[0], \
            self.uinv_b[0]
        try:
            p._debug_hooks()
        finally:
            p.pool = p.linv = p.uinv = None
        if "checklu_max_resid" in p.stat.counters:
            self.stat.counters["checklu_max_resid"] = \
                p.stat.counters["checklu_max_resid"]
        rdt = _TORCH[p.refine_dtype]
        prc = p.rowperm[p.colperm]
        self._t_rs = torch.as_tensor(self.row_scales[:, prc], dtype=rdt,
                                     device=dev)
        self._t_cs = torch.as_tensor(self.col_scales[:, p.colperm],
                                     dtype=rdt, device=dev)
        # every member's A at once, block-diagonal, for the residuals
        self._coo = _spmv.coo_arrays(sp.block_diag(self._As, format="csc"),
                                     p.refine_dtype, dev)
        self.refine_steps = np.zeros(self.count, dtype=np.int64)

    def initial_pools(self) -> torch.Tensor:
        """The members' pools before the factor, stacked (the batched
        factor's input, made again from the matrices)."""
        return torch.stack([self._pool_values(A, self.row_scales[m],
                                              self.col_scales[m])
                            for m, A in enumerate(self._As)])

    def _pool_values(self, A, R, C) -> torch.Tensor:
        """A member's scaled and permuted values scattered into a pool on
        the prototype's plan (its expansion included)."""
        p = self._proto
        A3 = sp.csc_matrix(A).multiply(np.asarray(R)[:, None]) \
            .multiply(np.asarray(C)[None, :]).tocsc()
        A3 = A3[p.rowperm, :][p.colperm, :][:, p.colperm]
        A3 = p._expand_A(sp.csc_matrix(A3))
        return _blocklu.init_pool(p.plan, sp.csc_matrix(A3).data, p.dtype,
                                  self.device)

    def _solve_t(self, R: torch.Tensor) -> torch.Tensor:
        """X = A_m⁻¹ R[m] for every member m, R (count, n, k) on the
        device; the result has R's dtype."""
        p, plan = self._proto, self.plan
        fdt = _TORCH[self.dtype]
        count, _, k = R.shape
        bp = torch.zeros((count, plan.n_pad, k), dtype=fdt,
                         device=self.device)
        rs = self._t_rs.to(R.dtype)[:, :, None]
        bp[:, p._t_ridx] = (rs * R[:, p._t_prc]).to(fdt)
        X = _solve_gemm.solve_batch(self.pool_b, self.linv_b, self.uinv_b,
                                    p._ltape, p._utape,
                                    bp.view(count, plan.nb, plan.bs, k))
        y = X.view(count, plan.n_pad, k)[:, p._t_ridx].to(R.dtype)
        x = torch.empty((count, self.n, k), dtype=R.dtype,
                        device=self.device)
        x[:, p._t_pc] = self._t_cs.to(R.dtype)[:, :, None] * y
        return x

    def _stacked(self, Bs, dtype):
        """Bs (count, n) or (count, n, nrhs) as a (count, n, nrhs) device
        tensor of ``dtype``, and whether it had no nrhs axis."""
        B = torch.as_tensor(np.asarray(Bs) if not isinstance(
            Bs, torch.Tensor) else Bs, device=self.device).to(dtype)
        if B.shape[:2] != (self.count, self.n) or B.dim() not in (2, 3):
            raise ValueError(f"expected ({self.count}, {self.n}[, nrhs]) "
                             f"right-hand sides, got {tuple(B.shape)}")
        return (B[:, :, None], True) if B.dim() == 2 else (B, False)

    def solve(self, Bs) -> np.ndarray:
        """Bs: (count, n) or (count, n, nrhs) → the solutions of the same
        shape, in the residual dtype (float64 or complex128 under
        SLU_DOUBLE), as a numpy array."""
        B, squeeze = self._stacked(Bs, _TORCH[self._proto.refine_dtype])
        with self.stat.phase("SOLVE"):
            X = self._solve_t(B)
        X = X.cpu().numpy()
        return X[:, :, 0] if squeeze else X

    def _residual(self, X: torch.Tensor, B: torch.Tensor):
        """(R, berr): R = B − A·X of every member, and each member's
        componentwise backward error max |r| / (|A|·|x| + |b|) over its
        rows and right-hand sides (the JAX package's ``backward_error``)."""
        count, n, k = X.shape
        xf = X.reshape(count * n, k)
        bf = B.reshape(count * n, k)
        r = bf - _spmv.spmv(self._coo, xf)
        den = _spmv.abs_spmv(self._coo, xf.abs()) + bf.abs()
        num = r.abs()
        val = torch.where(den > 0, num / torch.where(den > 0, den, 1),
                          torch.where(num > 0, float("inf"), 0.0))
        return r.reshape(count, n, k), val.reshape(count, n * k).amax(dim=1)

    def refine(self, Bs, X0) -> tuple:
        """Iterative refinement of every member with residuals in the
        residual dtype on the device and the batched solve, with the JAX
        package's stop rule: before each step, stop when every member's
        berr ≤ 4·eps; at most ``max_refine_steps`` steps. Returns (X,
        berr), berr per member from the last check. ``refine_steps`` holds
        per member the steps it took to reach 4·eps (the steps run, if it
        never did); ``stat.refine_steps`` the steps run."""
        rdt = _TORCH[self._proto.refine_dtype]
        B, squeeze = self._stacked(Bs, rdt)
        X, _ = self._stacked(X0, rdt)
        X = X.clone()
        lim = 4 * float(np.finfo(np.float64).eps)
        steps = np.zeros(self.count, dtype=np.int64)
        reached = np.zeros(self.count, dtype=bool)
        berr = torch.zeros(self.count)
        with self.stat.phase("REFINE"):
            for it in range(self.options.max_refine_steps):
                R, berr = self._residual(X, B)
                done = (berr <= lim).cpu().numpy()
                reached |= done
                if done.all():
                    break
                X = X + self._solve_t(R)
                steps[~reached] = it + 1
                self.stat.refine_steps = it + 1
        self.refine_steps = steps
        X = X.cpu().numpy()
        return (X[:, :, 0] if squeeze else X), berr.cpu().numpy()


def gssvx_batch(As: Sequence[sp.spmatrix], Bs: Sequence[np.ndarray],
                options: Optional[Options] = None, grid=None, *,
                device=None):
    """Heterogeneous batch through a block-diagonal composite system.

    Each matrix is equilibrated, matched (MC64) and ordered on its own
    (options' fact/ordering axes, pdgssvx3d_csc_batch.c:110-217), so the
    composite needs no further permutation; it is factored by
    :class:`SparseLU` on ``device``, by :class:`DistributedSparseLU` over
    ``grid`` (a ``Grid2D``) or by :class:`Distributed3DSparseLU` over a
    ``Grid3D``. The solutions are split back per matrix and refined
    together. Returns (list of SolveResult, the composite's LU). A batch
    with any complex member is solved in complex128."""
    options = apply_env_overrides(options or Options())
    count = len(As)
    if count != len(Bs):
        raise ValueError("len(As) != len(Bs)")

    pre = []
    for A, b in zip(As, Bs):
        A = sp.csc_matrix(A)
        n = A.shape[0]
        if options.equil == Equil.YES:
            A1, R, C, _ = _equil.equilibrate(A)
        else:
            A1, R, C = A, np.ones(n), np.ones(n)
        if options.row_perm in (RowPerm.LARGE_DIAG_MC64,
                                RowPerm.LARGE_DIAG_HWPM):
            rp, R1, C1 = _mc64.ldperm(A1, job=5)
            A1 = A1.multiply(R1[:, None]).multiply(C1[None, :]).tocsc()
            R, C = R1 * R, C * C1
        else:
            rp = np.arange(n, dtype=np.int64)
        A2 = sp.csc_matrix(A1)[rp, :]
        if options.col_perm == ColPerm.NATURAL:
            pc = np.arange(n, dtype=np.int64)
        else:
            pc = _ordering.get_perm_c(options.col_perm, A2)
        A3 = A2[pc, :][:, pc]
        pre.append((A, np.asarray(b), R, C, rp, pc, sp.csc_matrix(A3)))

    A_big = sp.block_diag([q[6] for q in pre], format="csc")
    composite = options.replace(
        equil=Equil.NO, row_perm=RowPerm.NOROWPERM,
        col_perm=ColPerm.NATURAL, iter_refine=IterRefine.NOREFINE)
    if grid is None:
        lu = SparseLU(A_big, composite, device=device)
    elif isinstance(grid, Grid3D):
        from .driver3d import Distributed3DSparseLU
        lu = Distributed3DSparseLU(A_big, grid, composite, device=device)
    else:
        from .dist_driver import DistributedSparseLU
        lu = DistributedSparseLU(A_big, grid, composite, device=device)

    offs = np.cumsum([0] + [q[0].shape[0] for q in pre])
    nrhs = max(q[1].shape[1] if q[1].ndim == 2 else 1 for q in pre)
    rdtype = np.complex128 if any(q[0].dtype.kind == "c" for q in pre) \
        else np.float64

    def to_big(vecs):
        """Per-matrix right-hand sides → the composite's, preprocessed."""
        big = np.zeros((A_big.shape[0], nrhs), dtype=rdtype)
        for i, (_, _, R, _, rp, pc, _) in enumerate(pre):
            v = vecs[i]
            prc = rp[pc]
            big[offs[i]:offs[i + 1], : v.shape[1]] = R[prc, None] * v[prc]
        return big

    def from_big(y_big):
        out = []
        for i, (A, _, _, C, _, pc, _) in enumerate(pre):
            y = y_big[offs[i]:offs[i + 1]]
            x = np.empty((A.shape[0], nrhs), dtype=y.dtype)
            x[pc] = C[pc, None] * y
            out.append(x)
        return out

    Bcols = [q[1] if q[1].ndim == 2 else q[1][:, None] for q in pre]
    Xs = [x.astype(rdtype) for x in
          from_big(lu.solve(to_big(Bcols)).astype(rdtype))]

    steps = 0
    if options.iter_refine != IterRefine.NOREFINE:
        for it in range(options.max_refine_steps):
            Rs = [Bcols[i] - pre[i][0] @ Xs[i] for i in range(count)]
            berrs = [max(backward_error(pre[i][0], Xs[i][:, j],
                                        Bcols[i][:, j])
                         for j in range(Bcols[i].shape[1]))
                     for i in range(count)]
            if max(berrs) <= np.finfo(np.float64).eps * 4:
                break
            dXs = from_big(lu.solve(to_big(Rs)).astype(rdtype))
            Xs = [Xs[i] + dXs[i] for i in range(count)]
            steps = it + 1

    results: List[SolveResult] = []
    for i, (A, b, *_rest) in enumerate(pre):
        x = Xs[i][:, : Bcols[i].shape[1]]
        berr = np.array([backward_error(A, x[:, j], Bcols[i][:, j])
                         for j in range(Bcols[i].shape[1])])
        stat = Stats()
        stat.refine_steps = steps
        results.append(SolveResult(
            x=x[:, 0] if b.ndim == 1 else x, berr=berr, stat=stat))
    return results, lu
