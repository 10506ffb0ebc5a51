"""Expert driver: the ``pdgssvx`` analog, in PyTorch on one CUDA device.

Port of the JAX package's ``models/driver.py`` main path:
  equilibrate → static row pivot (MC64) → fill-reducing column order →
  etree alignment → block symbolic → clk factor on the device → level
  sweeps → iterative refinement with a float64 residual.
The factored operator satisfies Pc·Pr·Dr·A·Dc·Pcᵀ = L·U as in the
reference (pdgssvx.c "What is performed").

Deliberate differences from the JAX package:

- ``device`` is a keyword argument of :class:`SparseLU` and :func:`gssvx`
  (not an ``Options`` field). It defaults to ``cuda``; without CUDA the
  entry points raise unless the caller passes ``device="cpu"``, which
  runs every kernel's plain PyTorch version.
- The kernels compute in IEEE FP32, so ``gemm_precision="auto"``
  resolves to ``"highest"`` and the low-precision-first escalation of
  the JAX package never fires.
- Etree alignment stays on whatever the device, as the JAX package
  keeps it off the TPU, so both build the same plan.
- This slice serves real ``float32`` on CUDA (``float64`` on the CPU
  too), DOFACT, NOTRANS, the clk executor, and no condition estimate;
  the rest raises ``NotImplementedError`` naming its ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from ..ops import blocklu as _blocklu
from ..ops import spmv as _spmv
from ..ops.host import equil as _equil
from ..ops.host import mc64 as _mc64
from ..ops.host import ordering as _ordering
from ..ops.host.symbolic import SymbolicPlan, block_symbolic
from ..ops.kernels import clk as _clk
from ..ops.kernels import sweep as _sweep
from ..utils.options import (ColPerm, DiagScale, Equil, Fact, IterRefine,
                             Options, RowPerm, Trans, apply_env_overrides)
from ..utils.stats import Stats

_DTYPES = {"float32": np.float32, "float64": np.float64}
_TORCH = {np.dtype(np.float32): torch.float32,
          np.dtype(np.float64): torch.float64}


def _resolve_refine_dtype(options) -> np.dtype:
    """Residual dtype: SLU_DOUBLE promotes to float64 (psgssvx_d2 mixed
    precision), SLU_SINGLE keeps the working precision; an explicit
    ``options.refine_dtype`` wins."""
    if options.refine_dtype:
        return np.dtype(options.refine_dtype)
    if options.iter_refine == IterRefine.SLU_SINGLE:
        return np.dtype(_DTYPES[options.dtype])
    return np.dtype(np.float64)


def _resolve_device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch versions of the kernels")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           "available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check_supported(opts: Options, device: torch.device, A) -> None:
    """Refuse what this slice of the port does not serve yet."""
    def todo(what, item):
        raise NotImplementedError(
            f"{what} is not ported yet (ROADMAP.md, {item})")

    if opts.dtype in ("complex64", "complex128") or \
            np.iscomplexobj(getattr(A, "data", A)):
        todo("complex dtypes", "queue 1 item 4")
    if opts.dtype not in _DTYPES:
        raise ValueError(f"unknown dtype {opts.dtype!r}")
    if opts.dtype == "float64" and device.type == "cuda":
        todo("float64 on CUDA", "queue 1 item 3")
    if opts.ilu_level is not None:
        todo("ilu_level", "queue 1 item 5")
    if opts.executor not in (None, "clk"):
        todo(f"executor={opts.executor!r}", "queue 2")
    if opts.trans != Trans.NOTRANS:
        todo(f"trans={opts.trans}", "queue 1 item 1")
    if opts.fact != Fact.DOFACT:
        todo(f"fact={opts.fact}", "queue 1 item 1")
    if opts.condition_number:
        todo("condition_number", "queue 1 item 1")
    if (opts.gemm_precision or "auto") not in ("auto", "highest"):
        todo(f"gemm_precision={opts.gemm_precision!r}", "queue 1 item 2")


def _check_user_perm(p, n: int, what: str) -> np.ndarray:
    """Validate a user-supplied permutation (check_perm_dist analog)."""
    p = np.asarray(p, dtype=np.int64)
    if p.shape != (n,) or len(np.unique(p)) != n or p.min() < 0 \
            or p.max() >= n:
        raise ValueError(
            f"{what} must be a permutation of 0..{n - 1} (got shape "
            f"{p.shape})")
    return p


@dataclasses.dataclass
class SolveResult:
    x: np.ndarray
    berr: np.ndarray          # componentwise backward error per RHS
    stat: Stats
    info: int = 0
    rcond: Optional[float] = None


class SparseLU:
    """Factorized sparse operator (LUstruct + ScalePermstruct analog):
    scalings (Dr, Dc), permutations (Pr, Pc), the symbolic plan, and the
    factored block pool with the diagonal inverses, on ``self.device``.
    """

    def __init__(self, A, options: Optional[Options] = None,
                 stat: Optional[Stats] = None, *, device=None):
        self.options = apply_env_overrides(options or Options())
        self.device = _resolve_device(device)
        _check_supported(self.options, self.device, A)
        # the kernels and every reference product run in full FP32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.stat = stat or Stats()
        self.stat.device = self.device
        A = sp.csc_matrix(A)
        if A.shape[0] != A.shape[1]:
            raise ValueError("SparseLU requires a square matrix")
        self.n = A.shape[0]
        self.dtype = np.dtype(_DTYPES[self.options.dtype])
        self.refine_dtype = _resolve_refine_dtype(self.options)
        self.plan = None
        self._factor(A)

    # ------------------------------------------------------------------
    # preprocessing + factorization
    # ------------------------------------------------------------------

    def _preprocess(self, A: sp.spmatrix) -> sp.csc_matrix:
        opts, stat = self.options, self.stat
        n = self.n

        with stat.phase("EQUIL"):
            if opts.equil == Equil.YES:
                A1, R, C, equed = _equil.equilibrate(A)
            else:
                A1, R, C = A, np.ones(n), np.ones(n)
                equed = DiagScale.NOEQUIL
        self.equed = equed

        with stat.phase("ROWPERM"):
            if opts.row_perm == RowPerm.LARGE_DIAG_HWPM:
                rowperm = _mc64.hwpm_rowperm(A1)
            elif opts.row_perm == RowPerm.LARGE_DIAG_MC64:
                rowperm, R1, C1 = _mc64.ldperm(A1, job=5)
                A1 = A1.multiply(R1[:, None]).multiply(C1[None, :]).tocsc()
                R = R1 * R
                C = C * C1
            elif opts.row_perm == RowPerm.MY_PERMR:
                rowperm = _check_user_perm(opts.user_rowperm, n,
                                           "user_rowperm")
            else:
                rowperm = np.arange(n, dtype=np.int64)
        A2 = sp.csc_matrix(A1)[rowperm, :]

        with stat.phase("COLPERM"):
            if opts.col_perm == ColPerm.MY_PERMC:
                pc = _check_user_perm(opts.user_colperm, n, "user_colperm")
            else:
                pc = _ordering.get_perm_c(opts.col_perm, A2)
        A3 = A2[pc, :][:, pc]

        self.row_scale = np.asarray(R)
        self.col_scale = np.asarray(C)
        self.rowperm = np.asarray(rowperm, dtype=np.int64)
        self.colperm = np.asarray(pc, dtype=np.int64)
        return self._align_blocks(sp.csc_matrix(A3))

    def _align_blocks(self, A3: sp.csc_matrix) -> sp.csc_matrix:
        """Postorder + expand ``A3`` so block boundaries follow the etree
        (reference: supernodal_etree.c topological levels). Alignment
        stays on in "auto" mode: the JAX package stands it down only on
        the TPU."""
        from ..ops.host import align as _align
        opts, stat = self.options, self.stat
        self._expand = None
        self._n_e = None
        mode = (opts.align_blocks or "auto").lower()
        bs = opts.block_size
        if mode == "off" or bs < 2:
            return A3
        with stat.phase("COLPERM"):
            res = _align.aligned_blocking(
                A3, bs,
                max_inflate=(np.inf if mode == "on"
                             else opts.align_max_inflate))
        if res is None:
            return A3
        A3 = A3[res.po, :][:, res.po]
        self.colperm = self.colperm[res.po]
        self._expand = res.expand
        self._n_e = res.n_e
        stat.counters["align_inflate"] = round(res.n_e / self.n, 3)
        stat.counters["align_blocks"] = res.n_blocks
        return _align.expand_matrix(A3, res.expand, res.n_e)

    def _factor(self, A: sp.csc_matrix):
        stat = self.stat
        self._A_orig = A
        A3 = self._preprocess(A)
        self._anorm = float(np.abs(A3.data).max()) if A3.nnz else 1.0

        with stat.phase("SYMBFAC"):
            plan = self._symbolic(A3)
            A3, plan = self._adapt_plan(A3, plan)
        self._rows_idx = self._expand if self._expand is not None \
            else np.arange(self.n, dtype=np.int64)

        self.plan = plan
        stat.counters["fill_blocks"] = plan.nslots
        stat.counters["factor_flops_model"] = plan.factor_flops
        from ..utils.profiling import record_schedule_counters
        record_schedule_counters(stat, plan)
        stat.peak_buffer_bytes = max(stat.peak_buffer_bytes,
                                     plan.pool_bytes(self.dtype))

        self._device_factor(A3)
        stat.ops["FACT"] += plan.factor_flops

        # pdgstrf info>0 contract: with tiny-pivot replacement off, an
        # exactly singular leading minor leaves a zero/non-finite U(j,j)
        self.info = 0
        if not self.options.replace_tiny_pivot:
            du = self.diag_u()
            bad = np.flatnonzero(~np.isfinite(du) | (du == 0))
            if len(bad):
                self.info = int(bad[0]) + 1

        self._coo_ref = _spmv.coo_arrays(A, self.refine_dtype, self.device)
        self._transforms()

    def _symbolic(self, A3: sp.csc_matrix):
        return block_symbolic(A3, self.options.block_size,
                              ilu_level=self.options.ilu_level)

    def _eval_candidate(self, A2: sp.csc_matrix, pc: np.ndarray, bs: int,
                        tag: str, flops_cap: float | None = None) -> dict:
        """One candidate plan (ordering ``pc`` at block size ``bs``),
        without mutating driver state; returns a scoring record. A
        candidate whose scalar flop estimate exceeds ``flops_cap`` is
        skipped (``{"skipped": True}``)."""
        from ..ops.host import align as _align
        from ..ops.host.colcounts import estimate_gesp_stats
        A3 = sp.csc_matrix(A2[pc, :][:, pc])
        if flops_cap is not None:
            pre = estimate_gesp_stats(A3)
            if pre["flops"] > flops_cap:
                return dict(tag=tag, skipped=True)
        colperm, expand, n_e = pc, None, None
        mode = (self.options.align_blocks or "auto").lower()
        if mode != "off" and bs >= 2:
            res = _align.aligned_blocking(
                A3, bs, max_inflate=(np.inf if mode == "on"
                                     else self.options.align_max_inflate))
            if res is not None:
                A3 = A3[res.po, :][:, res.po]
                colperm = pc[res.po]
                expand, n_e = res.expand, res.n_e
                A3 = _align.expand_matrix(A3, expand, n_e)
        plan = block_symbolic(A3, bs, ilu_level=self.options.ilu_level)
        est = estimate_gesp_stats(A3)
        return dict(tag=tag, A3=A3, plan=plan, colperm=colperm,
                    expand=expand, n_e=n_e,
                    pool=plan.pool_bytes(self.dtype),
                    pad=plan.factor_flops / est["flops"])

    def _adapt_plan(self, A3: sp.csc_matrix, plan):
        """Adaptive plan policy (host logic, as in the JAX package): when
        the plan's flop pad against the Gilbert–Ng–Peyton estimate exceeds
        ``adapt_pad_max``, or its pool exceeds ``hbm_budget_gb``, retry
        the other fill-reducing orderings (get_perm_c.c:500-546) and, for
        budget overruns, smaller block sizes, keeping the cheapest plan.
        Every decision lands in ``stat.counters['adapt_*']``."""
        opts, stat = self.options, self.stat
        if (opts.adapt_policy or "auto") == "off":
            return A3, plan
        budget = opts.hbm_budget_gb * 2**30
        pool = plan.pool_bytes(self.dtype)
        proxy = plan.nslots * plan.bs * plan.bs / max(self._A_orig.nnz, 1)
        if pool <= budget and proxy <= opts.adapt_pad_max:
            return A3, plan
        t0 = time.perf_counter()
        from ..ops.host.colcounts import estimate_gesp_stats
        est = estimate_gesp_stats(A3)
        pad0 = plan.factor_flops / est["flops"]
        stat.counters["adapt_pad_est"] = round(pad0, 1)
        if pool <= budget and pad0 <= opts.adapt_pad_max:
            stat.counters["adapt_check_s"] = round(
                time.perf_counter() - t0, 2)
            return A3, plan
        A2 = sp.csc_matrix(
            self._A_orig.multiply(self.row_scale[:, None])
            .multiply(self.col_scale[None, :]))[self.rowperm, :].tocsc()
        cur = dict(tag="current", A3=A3, plan=plan, colperm=self.colperm,
                   expand=self._expand, n_e=self._n_e, pool=pool, pad=pad0)
        cands = [cur]
        for strat in (ColPerm.METIS_AT_PLUS_A, ColPerm.COLAMD,
                      ColPerm.MMD_AT_PLUS_A):
            if strat == opts.col_perm:
                continue
            try:
                pc = _ordering.get_perm_c(strat, A2)
                rec = self._eval_candidate(A2, pc, plan.bs, strat.name,
                                           flops_cap=2.0 * est["flops"])
                if rec.get("skipped"):
                    stat.counters[f"adapt_skip_{strat.name}"] = 1
                else:
                    cands.append(rec)
            except Exception as e:        # a failing candidate is logged
                stat.counters[f"adapt_fail_{strat.name}"] = repr(e)

        def score(rec):
            return (rec["pool"] > budget, rec["plan"].factor_flops)

        best = min(cands, key=score)
        if best["pool"] > budget:
            for bs in (64, 32):
                try:
                    rec = self._eval_candidate(
                        A2, np.asarray(best["colperm"]), bs,
                        f"{best['tag']}_bs{bs}")
                except Exception as e:
                    stat.counters[f"adapt_fail_bs{bs}"] = repr(e)
                    continue
                cands.append(rec)
                if rec["pool"] <= budget:
                    break
            best = min(cands, key=score)
        stat.counters["adapt_tried"] = ",".join(
            f"{r['tag']}:pad={r['pad']:.0f}:pool={r['pool']/2**30:.2f}G"
            for r in cands)
        stat.counters["adapt_check_s"] = round(time.perf_counter() - t0, 2)
        if best is cur:
            stat.counters["adapt_chosen"] = "current"
            return A3, plan
        self.colperm = np.asarray(best["colperm"], dtype=np.int64)
        self._expand, self._n_e = best["expand"], best["n_e"]
        if best["plan"].bs != plan.bs:
            self.options = opts.replace(block_size=best["plan"].bs)
        stat.counters["adapt_chosen"] = best["tag"]
        return best["A3"], best["plan"]

    def _thresh(self) -> float:
        """ReplaceTinyPivot threshold sqrt(eps)·‖A3‖_max, rounded to the
        factor dtype as the kernels compare in it."""
        t = (np.sqrt(np.finfo(self.dtype).eps) * self._anorm
             if self.options.replace_tiny_pivot else 0.0)
        return float(self.dtype.type(t))

    def _device_factor(self, A3: sp.csc_matrix):
        """Assemble the pool on the device and run the clk factor."""
        self.pool = self.linv = self.uinv = None
        stat, plan = self.stat, self.plan
        self._a3_data = np.asarray(A3.data)     # the factor's input values
        with stat.phase("DIST"):
            t0 = time.perf_counter()
            self._ftapes = _clk.build_clk_tapes(plan, self.device)
            self._ltape = _sweep.build_sweep_tape(plan, "L", self.device)
            self._utape = _sweep.build_sweep_tape(plan, "U", self.device)
            stat.counters["dist_tapes_s"] = round(time.perf_counter() - t0, 3)
            pool = _blocklu.init_pool(plan, A3.data, self.dtype, self.device)
        # FP32 kernels: "auto" resolves to "highest" (no escalation)
        stat.counters["gemm_precision"] = "highest"
        stat.counters["clk_jobs"] = len(self._ftapes.host["job_src"])
        with stat.phase("FACT"):
            pool, linv, uinv, tiny = _clk.factor(pool, self._thresh(),
                                                 self._ftapes, plan.nb)
        self.pool, self.linv, self.uinv = pool, linv, uinv
        stat.tiny_pivots += int(tiny.item())

    def _transforms(self):
        """Device copies of the permutations and scalings of a solve."""
        dev, rdt = self.device, _TORCH[self.refine_dtype]
        prc = self.rowperm[self.colperm]

        def t(a, dtype=None):
            return torch.as_tensor(np.ascontiguousarray(a), device=dev,
                                   dtype=dtype)

        self._t_ridx = t(self._rows_idx)
        self._t_prc = t(prc)
        self._t_pc = t(self.colperm)
        self._t_rs = t(self.row_scale[prc], rdt)
        self._t_cs = t(self.col_scale[self.colperm], rdt)

    # ------------------------------------------------------------------
    # solves
    # ------------------------------------------------------------------

    def _require_factors(self):
        if getattr(self, "pool", None) is None:
            raise RuntimeError("factorization incomplete or released")

    def _lu_solve(self, r: torch.Tensor) -> torch.Tensor:
        """x = A⁻¹ r through the factors: Dr/Pr/Pc transforms, the L and
        U sweeps in the factor dtype, and the back-transform, all on the
        device. ``r`` is (n, k); the result has r's dtype."""
        plan = self.plan
        fdt = _TORCH[self.dtype]
        k = r.shape[1]
        rs = self._t_rs.to(r.dtype)[:, None]
        bp = torch.zeros((plan.n_pad, k), dtype=fdt, device=self.device)
        bp[self._t_ridx] = (rs * r[self._t_prc]).to(fdt)
        X = _sweep.solve(self.pool, self.linv, self.uinv, self._ltape,
                         self._utape, bp.view(plan.nb, plan.bs, k))
        y = X.view(plan.n_pad, k)[self._t_ridx].to(r.dtype)
        x = torch.zeros((self.n, k), dtype=r.dtype, device=self.device)
        x[self._t_pc] = self._t_cs.to(r.dtype)[:, None] * y
        return x

    def solve(self, b, trans: Trans = Trans.NOTRANS):
        """Single LU solve (no refinement), the ``pdgstrs`` analog. A
        torch tensor comes back as a tensor on the device, anything else
        as a numpy array."""
        self._require_factors()
        if trans not in (Trans.NOTRANS, "N", 0):
            raise NotImplementedError(
                "transposed solves are not ported yet (ROADMAP.md, queue 1 "
                "item 1)")
        as_tensor = isinstance(b, torch.Tensor)
        bt = torch.as_tensor(b, device=self.device)
        squeeze = bt.dim() == 1
        if squeeze:
            bt = bt[:, None]
        with self.stat.phase("SOLVE"):
            x = self._lu_solve(bt.to(_TORCH[self.dtype]))
        x = x[:, 0] if squeeze else x
        return x if as_tensor else x.cpu().numpy()

    def _berr_t(self, x: torch.Tensor, b: torch.Tensor):
        """Componentwise backward error with the safe1/safe2 guards
        (reference: pdgsrfs.c:189-231) on the device; returns (berr, r)."""
        rows, cols, vals = self._coo_ref
        r = b - _spmv.spmv(rows, cols, vals, x, self.n)
        denom = _spmv.abs_spmv(rows, cols, vals, x.abs(), self.n) + b.abs()
        nz = self._max_row_nnz() + 1
        safe1 = nz * np.finfo(np.float64).tiny
        safe2 = safe1 / np.finfo(np.float64).eps
        num = r.abs()
        val = torch.where(denom > safe2, num / torch.clamp(denom, min=safe1),
                          (num + safe1) / (denom + safe1))
        return val.amax(dim=0), r

    def _berr(self, x, b):
        """Host-facing backward error of (n, k) arrays; returns (berr, r)
        as numpy."""
        rdt = _TORCH[self.refine_dtype]
        berr, r = self._berr_t(
            torch.as_tensor(np.asarray(x), device=self.device).to(rdt),
            torch.as_tensor(np.asarray(b), device=self.device).to(rdt))
        return berr.cpu().numpy(), r.cpu().numpy()

    def _max_row_nnz(self) -> int:
        return int(self._A_orig.getnnz(axis=1).max())

    def refine(self, b, x0, trans: Trans = Trans.NOTRANS):
        """Iterative refinement, the ``pdgsrfs`` analog (pdgsrfs.c:
        129-251), with residuals in ``refine_dtype`` on the device. It
        keeps the JAX package's fused loop exactly: the first step always
        runs; after it, refinement goes on while some berr > eps, every
        berr ≤ rthresh·(previous berr) and fewer than ``max_refine_steps``
        steps ran. The FP32 factor is never re-run at another precision.
        Returns (x, berr) as numpy arrays."""
        self._require_factors()
        if trans not in (Trans.NOTRANS, "N", 0):
            raise NotImplementedError(
                "transposed refinement is not ported yet (ROADMAP.md, "
                "queue 1 item 1)")
        opts = self.options
        rdt = _TORCH[self.refine_dtype]
        bt = torch.as_tensor(np.asarray(b) if not isinstance(
            b, torch.Tensor) else b, device=self.device).to(rdt)
        xt = torch.as_tensor(np.asarray(x0) if not isinstance(
            x0, torch.Tensor) else x0, device=self.device).to(rdt)
        squeeze = bt.dim() == 1
        if squeeze:
            bt = bt[:, None]
        if xt.dim() == 1:
            xt = xt[:, None]
        eps = float(np.finfo(self.refine_dtype).eps)
        with self.stat.phase("REFINE"):
            berr, r = self._berr_t(xt, bt)
            prev = torch.full_like(berr, float("inf"))
            it = 0
            while it < opts.max_refine_steps and (
                    it == 0 or bool((berr > eps).any()
                                    & (berr <= opts.refine_rthresh
                                       * prev).all())):
                xt = xt + self._lu_solve(r)
                prev = berr
                berr, r = self._berr_t(xt, bt)
                it += 1
        self.stat.refine_steps = it
        x = xt.cpu().numpy()
        return (x[:, 0] if squeeze else x), np.atleast_1d(berr.cpu().numpy())

    # ------------------------------------------------------------------
    # extras
    # ------------------------------------------------------------------

    def diag_u(self) -> np.ndarray:
        """Diagonal of U in elimination order (reference: pdGetDiagU.c)."""
        bs, nb = self.plan.bs, self.plan.nb
        d = self.pool[torch.as_tensor(np.asarray(self.plan.diag_slot,
                                                 dtype=np.int64),
                                      device=self.device)]
        d = torch.diagonal(d, dim1=1, dim2=2).reshape(nb * bs).cpu().numpy()
        sel = slice(0, self.n) if self._expand is None else self._expand
        return d[sel]

    @classmethod
    def from_numpy_state(cls, state: dict, device=None) -> "SparseLU":
        """A solve-ready object from plain numpy arrays, e.g. the state of
        a JAX-package ``SparseLU``: ``options`` (optional), ``rowperm``,
        ``colperm``, ``row_scale``, ``col_scale``, ``expand`` (None
        without alignment), every ``SymbolicPlan`` field under ``plan``
        (a dict), ``pool``, ``linv``, ``uinv`` (bucket-padded rows are
        accepted and cut), ``anorm``, and the COO of the original A as
        ``a_row``, ``a_col``, ``a_data`` with ``n``."""
        lu = cls.__new__(cls)
        lu.options = state.get("options") or Options()
        lu.device = _resolve_device(device)
        _check_supported(lu.options, lu.device, state["a_data"])
        lu.stat = Stats()
        lu.stat.device = lu.device
        lu.n = int(state["n"])
        lu.dtype = np.dtype(_DTYPES[lu.options.dtype])
        lu.refine_dtype = _resolve_refine_dtype(lu.options)
        lu.plan = SymbolicPlan(**{
            f.name: state["plan"][f.name]
            for f in dataclasses.fields(SymbolicPlan)})
        plan = lu.plan
        lu.rowperm = np.asarray(state["rowperm"], dtype=np.int64)
        lu.colperm = np.asarray(state["colperm"], dtype=np.int64)
        lu.row_scale = np.asarray(state["row_scale"])
        lu.col_scale = np.asarray(state["col_scale"])
        exp = state.get("expand")
        lu._expand = None if exp is None or len(exp) == 0 \
            else np.asarray(exp, dtype=np.int64)
        lu._n_e = plan.n if lu._expand is not None else None
        lu._rows_idx = lu._expand if lu._expand is not None \
            else np.arange(lu.n, dtype=np.int64)
        lu._anorm = float(state.get("anorm", 1.0))
        lu._A_orig = sp.csc_matrix(
            (np.asarray(state["a_data"]),
             (np.asarray(state["a_row"]), np.asarray(state["a_col"]))),
            shape=(lu.n, lu.n))
        fdt = _TORCH[lu.dtype]

        def dev(a, rows):
            a = np.asarray(a)
            if a.shape[0] < rows:
                raise ValueError(f"factor array has {a.shape[0]} rows, "
                                 f"the plan needs {rows}")
            return torch.tensor(np.asarray(a[:rows]), device=lu.device,
                                dtype=fdt)

        lu.pool = dev(state["pool"], plan.nslots + 2)
        lu.linv = dev(state["linv"], plan.nb)
        lu.uinv = dev(state["uinv"], plan.nb)
        lu._ltape = _sweep.build_sweep_tape(plan, "L", lu.device)
        lu._utape = _sweep.build_sweep_tape(plan, "U", lu.device)
        lu._coo_ref = _spmv.coo_arrays(lu._A_orig, lu.refine_dtype,
                                       lu.device)
        lu._transforms()
        lu.info = 0
        return lu


def gssvx(A, b, options: Optional[Options] = None,
          lu: Optional[SparseLU] = None, *, device=None):
    """One-call expert driver (``pdgssvx`` analog). Returns (result, lu).

    Factors A on ``device`` (default ``cuda``; ``"cpu"`` runs the plain
    PyTorch versions of the kernels), solves, and refines to the
    ``refine_dtype`` backward error. As in the JAX package, ``lu`` is
    only read by the reuse modes of ``options.fact``, which are not
    ported yet; under DOFACT a new factorization is made."""
    options = options or Options()
    stat = Stats()
    lu = SparseLU(A, options=options, stat=stat, device=device)
    x = lu.solve(np.asarray(b))
    if options.iter_refine != IterRefine.NOREFINE:
        x, berr = lu.refine(b, x)
    else:
        xb = x[:, None] if x.ndim == 1 else x
        bb = np.asarray(b)
        bb = bb[:, None] if bb.ndim == 1 else bb
        berr, _ = lu._berr(xb, bb)
    return SolveResult(x=x, berr=np.atleast_1d(berr), stat=stat,
                       info=lu.info), lu
