"""Expert driver: the ``pdgssvx`` analog, in PyTorch on one CUDA device.

Port of the JAX package's ``models/driver.py`` single-device driver:
  equilibrate → static row pivot (MC64) → fill-reducing column order →
  etree alignment → block symbolic → clk factor on the device → level
  sweeps → iterative refinement with a float64 residual; and the
  transposed solve, the condition estimate, ``logdet``, the reuse modes of
  ``Options.fact`` and factor persistence (:func:`save_factors`,
  :func:`load_factors`).
The factored operator satisfies Pc·Pr·Dr·A·Dc·Pcᵀ = L·U as in the
reference (pdgssvx.c "What is performed").

Deliberate differences from the JAX package:

- ``device`` is a keyword argument of :class:`SparseLU` and :func:`gssvx`
  (not an ``Options`` field). It defaults to ``cuda``; without CUDA the
  entry points raise unless the caller passes ``device="cpu"``, which
  runs every kernel's plain PyTorch version.
- The pass precision of the factor's products (``gemm_precision``)
  resolves as the JAX package resolves it (:func:`_resolve_precision`):
  ``"auto"`` factors bf16-first (``"default"``: one bf16 pass with
  float32 accumulation, on the tensor cores) when refinement is
  configured, and ``"highest"`` (IEEE FP32, or the working type) under
  ``NOREFINE`` (ADVICE.md item 1, matched on purpose); ``"bf16"`` and
  ``"default"`` force the low pass; ``"highest"`` opts out. If
  refinement stalls above 1000·eps after a low-pass factor under
  ``"auto"``, :meth:`SparseLU.refine` re-factors at ``"highest"``, counts
  ``precision_escalated`` and keeps ``"highest"`` for later refactors.
  ``"auto"`` arms the low pass only on CUDA, the counterpart of the JAX
  package's Pallas path; on the CPU it resolves to ``"highest"``, as the
  JAX package's CPU (XLA) path runs, and an explicit ``"bf16"`` runs the
  plain versions' bf16 products. The fused executors clk, tck and flk
  (ILU(k) plans run flk), and the ring-embedded complex64 factor that
  runs one of them, have the low pass; the level executor, float64 and
  native complex report ``"highest"``, as the JAX package's non-fused
  executors do. The port reads no
  ``SLU_TPU_CLK_GEMM_PRECISION``, so nothing overrides the precision the
  counter reports (ADVICE.md item 3, diverged from on purpose).
- Etree alignment stays on whatever the device, as the JAX package
  keeps it off the TPU, so both build the same plan.
- The port serves ``float32``, ``float64``, ``complex64`` and
  ``complex128`` on CUDA and on the CPU, every ``Fact`` and ``Trans``
  mode, the condition estimate, exact LU and ILU(k) plans
  (``ilu_level``), every executor name (clk, tck, flk, the level-by-level
  ``"pallas"`` and ``"xla"``) and the per-level factor profile
  (:meth:`SparseLU.profile_levels`).
- Complex runs natively: the pool holds ``complex64``/``complex128``
  blocks (torch's interleaved layout) and the level executor's kernels
  take them as their element type, where the JAX package runs planar
  (re, im) real arithmetic off the CPU, or the real ring embedding on the
  TPU. Refinement residuals are ``complex128`` (``SLU_SINGLE`` keeps the
  working precision), a tiny pivot keeps its phase, and Aᴴx = b is solved
  as x = conj(A⁻ᵀ conj(b)), as the JAX package's native path does.
  Checkpoints hold the native pool; :func:`load_factors` and
  :meth:`SparseLU.from_numpy_state` also read the JAX package's planar
  ``(slots, 2, bs, bs)`` layout.
- complex64 also runs in the JAX package's ring embedding a+bi →
  [[a, −b], [b, a]] when ``SLU_TPU_COMPLEX=embed`` (the JAX package's
  default on the TPU, and the layout of every complex64 checkpoint it
  writes there): the embedded matrix of 2n real rows (rows 2k and 2k+1
  interleaved, the alignment at half the block width) is factored in
  float32 by the executor that float32 runs (clk, flk, tck or the level
  executor), the right-hand sides are embedded and the solutions read
  back, and the transposed sweep of the embedded pool solves Aᴴ natively
  (embed(A)ᵀ = embed(Aᴴ)), so TRANS is x = conj(A⁻ᴴ conj(b)). The pool is
  the scalar LU of the 2n matrix, not embed(LU(A)): a diagonal block s =
  a+bi stores a at (2k, 2k) and the L entry b/a at (2k+1, 2k), so
  :meth:`SparseLU.diag_u` reads Im(U_kk) as F(2k+1, 2k)·F(2k, 2k), where
  the JAX package reads F(2k+1, 2k) alone (its driver.py:1777-1784) and
  its ``logdet`` phase is off. Checkpoints carry ``embed`` both ways. The
  adaptive plan retry does not run on an embedded plan (its candidates
  would have to be embedded too).
- The transposed solve (Aᵀx = b, and Aᴴx = b through conjugation) runs
  the hand-written counterparts of the JAX package's
  ``pallas_exec._solve_gemm_kernel`` and ``_diag_apply_kernel`` with
  ``transpose=True`` (``ops/kernels/solve_gemm.py``), where the JAX
  package runs the XLA level loop ``blocklu._solve_core(transpose=True)``
  that computes the same function per level on the same schedule. The
  NOTRANS solve, the port of the JAX package's whole-sweep kernel, runs
  the same two-pass kernels with ``transpose=False`` on the plan's L and U
  tapes (``solve_gemm.solve``).
- The executor is chosen as in the JAX package (driver.py:630-651,
  705-797): clk for exact plans, flk for ILU plans and ``executor="flk"``,
  tck for ``executor="tck"`` (not rerouted: an ILU plan raises
  ``ValueError``), the level executor for ``executor="pallas"`` (with or
  without ILU). ``executor="xla"`` and every float64 factor run the level
  executor's kernels, the port's counterpart of the JAX package's
  level-batched XLA executor (the JAX package runs no fused kernel but in
  float32), and so does every complex factor; ``stat.counters["executor"]``
  names what ran. The port has no
  ``flk_supported`` check and no ``"xla-fallback"``: those exist for the
  TPU's SMEM budget for tapes, and the CUDA kernels read their tapes from
  device memory, so flk serves every plan.
"""

from __future__ import annotations

import dataclasses
import os
import time
import types
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
from ..ops.kernels import flk as _flk
from ..ops.kernels import schur as _schur
from ..ops.kernels import solve_gemm as _solve_gemm
from ..ops.kernels import sweep as _sweep
from ..ops.kernels import tck as _tck
from ..utils.options import (ColPerm, DiagScale, Equil, Fact, IterRefine,
                             Options, RowPerm, Trans, apply_env_overrides)
from ..utils.stats import Stats
from ..utils.norms import langs

_DTYPES = {"float32": np.float32, "float64": np.float64,
           "complex64": np.complex64, "complex128": np.complex128}
_TORCH = {np.dtype(np.float32): torch.float32,
          np.dtype(np.float64): torch.float64,
          np.dtype(np.complex64): torch.complex64,
          np.dtype(np.complex128): torch.complex128}
#: the residual dtype of each working dtype under SLU_DOUBLE (the JAX
#: package's ``_REFINE_DTYPES``)
_REFINE_DTYPES = {"float32": np.float64, "float64": np.float64,
                  "complex64": np.complex128, "complex128": np.complex128}


def _resolve_refine_dtype(options) -> np.dtype:
    """Residual dtype: SLU_DOUBLE promotes to float64 or complex128
    (psgssvx_d2 mixed precision), SLU_SINGLE keeps the working precision;
    an explicit ``options.refine_dtype`` wins."""
    if options.refine_dtype:
        return np.dtype(options.refine_dtype)
    if options.iter_refine == IterRefine.SLU_SINGLE:
        return np.dtype(_DTYPES[options.dtype])
    return np.dtype(_REFINE_DTYPES[options.dtype])


def _embed_csc(A: sp.spmatrix) -> sp.csc_matrix:
    """The real ring embedding of a complex matrix: each entry a+bi
    becomes the block [[a, −b], [b, a]] (rows and columns 2k, 2k+1), in
    float32 (the JAX package's ``_embed_csc``)."""
    A = sp.csc_matrix(A)
    re = np.array([[1.0, 0.0], [0.0, 1.0]], dtype=np.float32)
    im = np.array([[0.0, -1.0], [1.0, 0.0]], dtype=np.float32)
    return (sp.kron(A.real, re, format="csc")
            + sp.kron(A.imag.astype(np.float32), im, format="csc")
            ).astype(np.float32)


def _embed_rows(v: torch.Tensor) -> torch.Tensor:
    """(n, k) complex → (2n, k) real: rows 2i and 2i+1 hold Re and Im of
    row i."""
    r = torch.view_as_real(v)                  # (n, k, 2)
    return r.transpose(1, 2).reshape(2 * v.shape[0], v.shape[1])


def _unembed_rows(y: torch.Tensor) -> torch.Tensor:
    """(2n, k) real → (n, k) complex, the inverse of :func:`_embed_rows`."""
    y = y.reshape(y.shape[0] // 2, 2, y.shape[1])
    return torch.complex(y[:, 0], y[:, 1])


def _interleave(base: np.ndarray) -> np.ndarray:
    """The embedded rows 2i, 2i+1 of each row i of ``base``."""
    ri = np.empty(2 * len(base), dtype=np.int64)
    ri[0::2] = 2 * base
    ri[1::2] = 2 * base + 1
    return ri


def _diag_of_blocks(blocks: torch.Tensor, embed: bool) -> np.ndarray:
    """The diagonal of U from the diagonal blocks (nb, bs, bs) in
    elimination order. In the ring embedding the block of a complex pivot
    s = a+bi holds the scalar LU of [[a, −b], [b, a]]: F(2k, 2k) = a and
    F(2k+1, 2k) = b/a, so Im(s) = F(2k+1, 2k)·F(2k, 2k)."""
    d = torch.diagonal(blocks, dim1=1, dim2=2).reshape(-1).cpu().numpy()
    if not embed:
        return d
    bs = blocks.shape[-1]
    k = torch.arange(0, bs, 2, device=blocks.device)
    sub = blocks[:, k + 1, k].reshape(-1).cpu().numpy()
    re = d[0::2]
    return (re + 1j * (sub * re)).astype(np.complex64)


def _conj(t: torch.Tensor) -> torch.Tensor:
    """The conjugate of a complex tensor, materialised: a kernel reads the
    tensor's memory, which a lazy conjugate view does not change."""
    return torch.conj_physical(t)


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
    """Refuse a dtype, a value type or an executor that the port does
    not know (every one it knows runs on ``device``)."""
    if opts.dtype not in _DTYPES:
        raise ValueError(f"unknown dtype {opts.dtype!r}")
    if np.iscomplexobj(getattr(A, "data", A)) and \
            np.dtype(_DTYPES[opts.dtype]).kind != "c":
        raise ValueError(f"complex values need a complex dtype, not "
                         f"{opts.dtype!r}")
    if opts.executor not in (None, "clk", "tck", "flk", "pallas", "xla"):
        raise ValueError(f"unknown executor {opts.executor!r}")


def _embed_env() -> bool:
    """``SLU_TPU_COMPLEX=embed``: complex64 factors its real ring
    embedding (read as the JAX package reads it)."""
    return os.environ.get("SLU_TPU_COMPLEX", "") == "embed"


def _auto_low_pass(device: torch.device) -> bool:
    """Whether ``gemm_precision="auto"`` may arm the low pass on
    ``device``: on CUDA, the counterpart of the JAX package's Pallas path
    (its ``_use_pallas``); not on the CPU, whose plain versions stand for
    the JAX package's CPU (XLA) path, which factors at full precision."""
    return device.type == "cuda"


def _resolve_precision(opts: Options, device: torch.device, executor: str,
                       sticky: bool = False) -> str:
    """The pass precision of the factor's products, in the JAX package's
    strings (its driver.py:714-727, 781-795): "default" (one bf16 pass,
    float32 accumulation) or "highest". "auto" is "default" when
    refinement is configured, on a device where :func:`_auto_low_pass`
    arms it, unless an escalation made "highest" ``sticky``; "bf16" and
    "default" are "default"; anything else is "highest". The fused
    executors (clk, tck, flk) take the low pass; the level executor
    (``"pallas"``: "xla", float64, native complex) is always "highest"."""
    if executor not in ("clk", "tck", "flk"):
        return "highest"
    req = opts.gemm_precision or "auto"
    if req == "auto":
        armed = (not sticky and opts.iter_refine != IterRefine.NOREFINE
                 and _auto_low_pass(device))
        return "default" if armed else "highest"
    return "default" if req in ("bf16", "default") else "highest"


#: the factor module of each executor (each has ``factor(pool, thresh,
#: tapes, nb)`` and ``factor_level``) and the function that makes its tapes
_EXECUTORS = {"clk": (_clk, _clk.build_clk_tapes),
              "tck": (_tck, _tck.build_tck_tapes),
              "flk": (_flk, _flk.build_flk_tapes),
              "pallas": (_schur, _schur.build_level_tapes)}


def _executor(opts: Options, embed: bool = False) -> str:
    """The executor that runs, as the JAX package chooses it
    (driver.py:630-651, 728-797 there): the level executor for float64
    and the complex dtypes whatever ``executor`` names (the JAX package
    runs no fused kernel but in float32) and for ``executor="xla"`` (the
    port's counterpart of the level-batched XLA executor); otherwise clk
    for exact plans and flk for ILU plans unless an executor is named. tck
    is not rerouted: with an ILU plan ``build_tck_tapes`` raises. A
    ring-embedded complex64 factor (``embed``) is float32 and is chosen
    for as float32 is."""
    exc = opts.executor or "clk"
    if (opts.dtype != "float32" and not embed) or exc == "xla":
        return "pallas"
    if exc == "clk" and opts.ilu_level is not None:
        return "flk"
    return exc


def _parse_trans(trans) -> Trans:
    """``Trans``, the reference's letter codes 'N'/'T'/'C' or its integer
    ``trans_t`` codes 0/1/2; anything else raises rather than running the
    NOTRANS path."""
    if isinstance(trans, Trans):
        return trans
    if isinstance(trans, str) and trans in ("N", "T", "C"):
        return Trans(trans)
    if isinstance(trans, (int, np.integer)) and not isinstance(trans, bool) \
            and 0 <= trans <= 2:
        return list(Trans)[int(trans)]
    raise ValueError("invalid trans value; expected Trans.NOTRANS/TRANS/"
                     "CONJ, 'N'/'T'/'C', or 0/1/2")


def _perm_sign(perm: np.ndarray) -> float:
    """Permutation parity via cycle counting."""
    n = len(perm)
    seen = np.zeros(n, dtype=bool)
    sign = 1.0
    for i in range(n):
        if seen[i]:
            continue
        j, clen = i, 0
        while not seen[j]:
            seen[j] = True
            j = int(perm[j])
            clen += 1
        if clen % 2 == 0:
            sign = -sign
    return sign


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
        self.stat = stat or Stats()
        A = self._ingest_input(A)
        _check_supported(self.options, self.device, A)
        # the kernels and every reference product run in full FP32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.stat.device = self.device
        A = sp.csc_matrix(A)
        if A.shape[0] != A.shape[1]:
            raise ValueError("SparseLU requires a square matrix")
        self.n = A.shape[0]
        self.dtype = np.dtype(_DTYPES[self.options.dtype])
        self.refine_dtype = _resolve_refine_dtype(self.options)
        self.plan = self.executor = None
        self._factor(A, self.options.fact)

    # ------------------------------------------------------------------
    # preprocessing + factorization
    # ------------------------------------------------------------------

    def _ingest_input(self, A):
        """Input normalization hook. The single-device driver gathers
        NRLoc chunks on the host (the dGatherNRformat_loc3d role); the
        distributed drivers override it to keep partial input sharded."""
        from ..utils.nrloc import NRLocMatrix
        if isinstance(A, NRLocMatrix):
            return A.to_global()
        return A

    def _preprocess(self, A: sp.spmatrix, reuse_perms: bool = False,
                    reuse_colperm: bool = False) -> sp.csc_matrix:
        opts, stat = self.options, self.stat
        n = self.n

        if reuse_perms:
            # SamePattern_SameRowPerm: reuse Dr/Dc/Pr/Pc wholesale
            A3 = A.multiply(self.row_scale[:, None]) \
                  .multiply(self.col_scale[None, :]).tocsc()
            A3 = A3[self.rowperm, :][self.colperm, :][:, self.colperm]
            return self._expand_A(sp.csc_matrix(A3))

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
                rowperm = (self.rowperm if opts.user_rowperm is None
                           and hasattr(self, "rowperm") else
                           _check_user_perm(opts.user_rowperm, n,
                                            "user_rowperm"))
            else:
                rowperm = np.arange(n, dtype=np.int64)
        A2 = sp.csc_matrix(A1)[rowperm, :]

        with stat.phase("COLPERM"):
            if opts.col_perm == ColPerm.MY_PERMC and \
                    (opts.user_colperm is not None or not reuse_colperm):
                pc = _check_user_perm(opts.user_colperm, n, "user_colperm")
            elif reuse_colperm:
                pc = self.colperm
            else:
                pc = _ordering.get_perm_c(opts.col_perm, A2)
        A3 = sp.csc_matrix(A2[pc, :][:, pc])

        self.row_scale = np.asarray(R)
        self.col_scale = np.asarray(C)
        self.rowperm = np.asarray(rowperm, dtype=np.int64)
        self.colperm = np.asarray(pc, dtype=np.int64)
        if reuse_colperm:
            # SamePattern: the stored colperm already folds in the
            # alignment postorder; reapply the stored expansion
            return self._expand_A(A3)
        return self._align_blocks(A3)

    def _expand_A(self, A3: sp.csc_matrix) -> sp.csc_matrix:
        """Reapply a stored expansion (factor-reuse modes)."""
        if self._expand is None:
            return A3
        from ..ops.host import align as _align
        return _align.expand_matrix(A3, self._expand, self._n_e)

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
        # in matrix columns: the embedding packs two real columns per
        # complex one (the JAX package's _effective_bs)
        bs = opts.block_size // (2 if self._embed else 1)
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

    def _factor(self, A: sp.csc_matrix, fact: Fact = Fact.DOFACT):
        stat = self.stat
        if fact == Fact.FACTORED:
            raise ValueError("FACTORED requires an existing factorization")
        reuse_perms = fact == Fact.SAME_PATTERN_SAME_ROWPERM
        reuse_colperm = fact == Fact.SAME_PATTERN or reuse_perms
        if reuse_colperm and self.plan is None \
                and not hasattr(self, "colperm"):
            raise ValueError(f"{fact} requested but no prior factorization")
        self._A_orig = A
        # the embedding shapes the alignment (block width in complex
        # columns), so it is settled before the preprocessing
        self._embed = self._use_embed()
        A3 = self._preprocess(A, reuse_perms, reuse_colperm)
        # the processes of a sharded input receive the global norm by
        # broadcast (their A3 is partial or empty)
        if getattr(self, "_anorm_global", None) is not None:
            self._anorm = self._anorm_global
        else:
            self._anorm = float(np.abs(A3.data).max()) if A3.nnz else 1.0
        if self._embed:
            A3 = _embed_csc(A3)

        with stat.phase("SYMBFAC"):
            if reuse_perms and self.plan is not None:
                plan = self.plan
            else:
                plan = self._symbolic(A3)
                A3, plan = self._adapt_plan(A3, plan)
                # every tape is derived from the plan: drop them with it,
                # or a SamePattern refactor that changes the row
                # permutation solves against stale schedules (the JAX
                # package measured err 7e4 on Aᵀ while NOTRANS stayed
                # 5e-12, driver.py:360-368 there)
                self._ftapes = self._ltape = self._utape = None
                self._ttapes = None
        self._rows_idx = self._row_map(self._expand)

        self.plan = plan
        stat.counters["fill_blocks"] = plan.nslots
        stat.counters["factor_flops_model"] = plan.factor_flops
        from ..utils.profiling import record_schedule_counters
        record_schedule_counters(stat, plan)
        stat.peak_buffer_bytes = max(stat.peak_buffer_bytes,
                                     plan.pool_bytes(self._fdtype))

        self._device_factor(A3)
        stat.ops["FACT"] += plan.factor_flops

        # pdgstrf info>0 contract: with tiny-pivot replacement off, an
        # exactly singular leading minor leaves a zero/non-finite U(j,j)
        # (a batch's prototype holds no factor: its batch reads the tiny
        # pivots of every member)
        self.info = 0
        if not self.options.replace_tiny_pivot and self.pool is not None:
            du = self.diag_u()
            bad = np.flatnonzero(~np.isfinite(du) | (du == 0))
            if len(bad):
                self.info = int(bad[0]) + 1
        if self.pool is not None:
            self._debug_hooks(A3)

        self._coo_ref = _spmv.coo_arrays(A, self.refine_dtype, self.device)
        self._transforms()

    def _debug_hooks(self, A3=None) -> None:
        """The env-gated factor audits (the reference's CHECKLU and
        WRITELU/LUFILE debug hooks; the JAX package's driver.py:406-418),
        run after every factor that holds its pool: ``SLU_TPU_CHECKLU=1``
        records ‖L·U − A3‖ / ‖A3‖ in ``stat.counters["checklu_max_resid"]``
        (a dense product: small matrices only; a grid's sharded pool
        raises, as the JAX package's does), and ``SLU_TPU_WRITELU=<path>``
        dumps the factors (``utils.debug.dump_lu``)."""
        check = os.environ.get("SLU_TPU_CHECKLU", "") == "1"
        path = os.environ.get("SLU_TPU_WRITELU", "")
        if not (check or path):
            return
        from ..utils import debug
        if check:
            self.stat.counters["checklu_max_resid"] = float(
                debug.check_factorization(self, A3))
        if path:
            debug.dump_lu(self, path)

    def _symbolic(self, A3: sp.csc_matrix):
        return block_symbolic(A3, self.options.block_size,
                              ilu_level=self.options.ilu_level)

    #: subclasses that factor complex64 natively whatever the environment
    #: (the batch) opt out of the ring embedding
    _embed_ok = True
    #: whether this factor is the ring embedding of complex64 (settled
    #: when it factors, or read from a state)
    _embed = False

    def _use_embed(self) -> bool:
        """complex64 through the real ring embedding when
        ``SLU_TPU_COMPLEX=embed`` (read as the JAX package reads it; its
        default off the TPU, and the port's, is native complex)."""
        return self._embed_ok and self.dtype == np.complex64 and \
            _embed_env()

    @property
    def _fdtype(self) -> np.dtype:
        """The dtype of the factor pool: float32 in the ring embedding."""
        return np.dtype(np.float32) if self._embed else self.dtype

    def _row_map(self, expand) -> np.ndarray:
        """The pool rows where the n rows of a right-hand side land: the
        alignment's expansion (else the identity), each row as two
        interleaved real rows in the ring embedding."""
        base = expand if expand is not None \
            else np.arange(self.n, dtype=np.int64)
        return _interleave(base) if self._embed else base

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

    #: the distributed driver keeps its plan as the JAX package's does:
    #: the adaptive retry loop runs on one device only
    _adapt_ok = True

    def _adapt_plan(self, A3: sp.csc_matrix, plan):
        """Adaptive plan policy (host logic, as in the JAX package): when
        the plan's flop pad against the Gilbert–Ng–Peyton estimate exceeds
        ``adapt_pad_max``, or its pool exceeds ``hbm_budget_gb``, retry
        the other fill-reducing orderings (get_perm_c.c:500-546) and, for
        budget overruns, smaller block sizes, keeping the cheapest plan.
        Every decision lands in ``stat.counters['adapt_*']``."""
        opts, stat = self.options, self.stat
        if (opts.adapt_policy or "auto") == "off" or not self._adapt_ok \
                or self._embed:
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
        factor dtype's real type as the kernels compare in it (float32 for
        complex64, embedded or not)."""
        fi = np.finfo(self.dtype)
        t = (np.sqrt(fi.eps) * self._anorm
             if self.options.replace_tiny_pivot else 0.0)
        return float(fi.dtype.type(t))

    def _factor_tapes(self, A3: sp.csc_matrix):
        """Keep the factor's input values and build the executor's and
        the sweeps' tapes; those of an unchanged plan and executor are
        kept."""
        plan = self.plan
        self._a3_data = np.asarray(A3.data)     # the factor's input values
        exc = _executor(self.options, self._embed)
        if exc != self.executor:
            self._ftapes = None
        self.executor = exc
        t0 = time.perf_counter()
        if self._ftapes is None:
            self._ftapes = _EXECUTORS[exc][1](plan, self.device)
        if self._ltape is None:
            self._ltape = _sweep.build_sweep_tape(plan, "L", self.device)
            self._utape = _sweep.build_sweep_tape(plan, "U", self.device)
        self.stat.counters["dist_tapes_s"] = round(time.perf_counter() - t0,
                                                   3)

    def _device_factor(self, A3: sp.csc_matrix):
        """Assemble the pool on the device and run the executor's factor.
        The previous factors are released first, so a refactor holds one
        pool."""
        self.pool = self.linv = self.uinv = None
        stat, plan = self.stat, self.plan
        with stat.phase("DIST"):
            self._factor_tapes(A3)
            pool = _blocklu.init_pool(plan, A3.data, self._fdtype,
                                      self.device)
        mod = _EXECUTORS[self.executor][0]
        prec = self._prec_override or _resolve_precision(
            self.options, self.device, self.executor, self._prec_sticky)
        self._gemm_prec_used = prec
        stat.counters["gemm_precision"] = prec
        stat.counters["executor"] = self.executor
        if self.executor == "clk":
            stat.counters["clk_jobs"] = len(self._ftapes.host["job_src"])
        elif self.executor == "tck":
            # every job of the TPU kernel's stream (a LOAD and a STORE per
            # tile), without its NOP pads
            c = self._ftapes.host["counts"]
            stat.counters["tck_jobs"] = (c["gemm"] + c["finu"] + c["diag"]
                                         + c["trsm"] + 2 * c["tiles"])
        # the fused executors take the pass precision; the level executor
        # has no low pass (it resolves to "highest")
        kw = {"precision": prec} if self.executor != "pallas" else {}
        with stat.phase("FACT"):
            pool, linv, uinv, tiny = mod.factor(pool, self._thresh(),
                                                self._ftapes, plan.nb, **kw)
        self.pool, self.linv, self.uinv = pool, linv, uinv
        stat.tiny_pivots += int(tiny.item())

    #: the pass precision of the live factor ("highest" for a factor this
    #: instance did not compute, such as a restored state)
    _gemm_prec_used = "highest"
    #: set by an escalation: "auto" then resolves to "highest" for good
    _prec_sticky = False
    #: the precision an escalation's re-factor forces
    _prec_override = None
    #: the drivers that re-run their factor from stored values at another
    #: precision (the distributed one does not, as in the JAX package)
    _escalate_ok = True

    def _should_escalate(self, berr) -> bool:
        """True when a low-pass factor under "auto" left refinement
        stalled above 1000·eps of the residual dtype (the JAX package's
        ``_should_escalate``, driver.py:1547-1559 there: psgssvx_d2's
        escalate-one-precision policy)."""
        if not self._escalate_ok:
            return False
        if (self.options.gemm_precision or "auto") != "auto":
            return False
        if self._gemm_prec_used != "default":
            return False
        eps = float(np.finfo(self.refine_dtype).eps)
        return bool(np.max(berr) > 1000.0 * eps)

    def _refactor_values(self, precision: str) -> None:
        """Re-run the numeric factor on the stored input values with the
        products forced to ``precision`` (same plan, permutations and
        tapes); its time falls under FACT."""
        self._prec_override = precision
        try:
            self._device_factor(types.SimpleNamespace(data=self._a3_data))
        finally:
            self._prec_override = None

    def refactor(self, A_new, fact: Fact = Fact.SAME_PATTERN_SAME_ROWPERM
                 ) -> "SparseLU":
        """Refactor a matrix with the same sparsity pattern.

        ``SAME_PATTERN_SAME_ROWPERM`` reuses the permutations, the scalings
        and the whole symbolic plan (with its tapes); ``SAME_PATTERN``
        reuses the column order and the stored expansion and redoes
        equilibration and row matching. As in the JAX package, the
        previous factors are released before the new factor starts, so a
        refactor that fails midway leaves no factors and later solves
        raise."""
        if fact not in (Fact.SAME_PATTERN, Fact.SAME_PATTERN_SAME_ROWPERM):
            raise ValueError("refactor expects a SamePattern* mode")
        # NRLoc chunks are gathered or kept sharded as at construction
        A_new = self._ingest_input(A_new)
        _check_supported(self.options, self.device, A_new)
        self._factor(sp.csc_matrix(A_new), fact)
        return self

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

    def _to_pool_rows(self, v: torch.Tensor) -> torch.Tensor:
        """The (nb, bs, k) right-hand side in the factor dtype whose rows
        ``_rows_idx`` hold ``v`` (n, k) (embedded in the ring embedding),
        the others zero."""
        plan = self.plan
        fdt = _TORCH[self._fdtype]
        k = v.shape[1]
        if self._embed:
            v = _embed_rows(v)
        bp = torch.zeros((plan.n_pad, k), dtype=fdt, device=self.device)
        bp[self._t_ridx] = v.to(fdt)
        return bp.view(plan.nb, plan.bs, k)

    def _from_pool_rows(self, X: torch.Tensor, dtype) -> torch.Tensor:
        """Rows ``_rows_idx`` of a solved (nb, bs, k) X as (n, k) in
        ``dtype`` (read back from the ring embedding)."""
        y = X.reshape(self.plan.n_pad, X.shape[-1])[self._t_ridx]
        return (_unembed_rows(y) if self._embed else y).to(dtype)

    def _sweeps(self, X: torch.Tensor) -> torch.Tensor:
        """The L then U sweeps in place on the pool-row right-hand side X
        (the grid overrides this with its ranks' sweeps)."""
        return _solve_gemm.solve(self.pool, self.linv, self.uinv,
                                 self._ltape, self._utape, X)

    def _sweeps_t(self, X: torch.Tensor) -> torch.Tensor:
        """The Uᵀ then Lᵀ sweeps in place on X; the transposed tapes are
        built on the first call and kept with the plan."""
        if self._ttapes is None:
            self._ttapes = tuple(_solve_gemm.build_trans_tape(
                self.plan, w, self.device) for w in ("U", "L"))
        tu, tl = self._ttapes
        return _solve_gemm.solve_transposed(self.pool, self.uinv, self.linv,
                                            tu, tl, X)

    def _lu_solve(self, r: torch.Tensor) -> torch.Tensor:
        """x = A⁻¹ r through the factors: Dr/Pr/Pc transforms, the L and
        U sweeps in the factor dtype, and the back-transform, all on the
        device. ``r`` is (n, k); the result has r's dtype."""
        rs = self._t_rs.to(r.dtype)[:, None]
        y = self._from_pool_rows(self._sweeps(self._to_pool_rows(
            rs * r[self._t_prc])), r.dtype)
        x = torch.zeros((self.n, r.shape[1]), dtype=r.dtype,
                        device=self.device)
        x[self._t_pc] = self._t_cs.to(r.dtype)[:, None] * y
        return x

    def _lu_solve_t(self, r: torch.Tensor, conj: bool = False
                    ) -> torch.Tensor:
        """x = A⁻ᵀ r, the mirror of :meth:`_lu_solve`: b3[k] =
        Dc[pc[k]]·r[pc[k]] in, the Uᵀ then Lᵀ sweeps in the factor dtype,
        x[prc[k]] = Dr[prc[k]]·y[k] out, all on the device; the result has
        r's dtype. With ``conj``, x = A⁻ᴴ r = conj(A⁻ᵀ conj(r)) (the JAX
        package's native path, driver.py:940-955 there). The transposed
        sweep of a ring-embedded pool solves Aᴴ (embed(A)ᵀ = embed(Aᴴ)), so
        there it is A⁻ᵀ r that goes through conjugation."""
        if conj != self._embed and r.is_complex():
            return _conj(self._lu_solve_t(_conj(r), self._embed))
        cs = self._t_cs.to(r.dtype)[:, None]
        y = self._from_pool_rows(self._sweeps_t(self._to_pool_rows(
            cs * r[self._t_pc])), r.dtype)
        x = torch.zeros((self.n, r.shape[1]), dtype=r.dtype,
                        device=self.device)
        y = self._t_rs.to(r.dtype)[:, None] * y
        # x rounded to the working dtype, as the JAX package's
        # solve_transposed returns it: TRANS refinement then adds the same
        # rounded correction and takes the same steps (its embedded path
        # returns x unrounded)
        x[self._t_prc] = y if self._embed else \
            y.to(_TORCH[self.dtype]).to(r.dtype)
        return x

    def _apply(self, b, fn):
        """Run the solve ``fn`` on b in the factor dtype. A torch tensor
        comes back as a tensor on the device, anything else as a numpy
        array."""
        self._require_factors()
        as_tensor = isinstance(b, torch.Tensor)
        bt = torch.as_tensor(b, device=self.device)
        squeeze = bt.dim() == 1
        if squeeze:
            bt = bt[:, None]
        with self.stat.phase("SOLVE"):
            x = fn(bt.to(_TORCH[self.dtype]))
        x = x[:, 0] if squeeze else x
        return x if as_tensor else x.cpu().numpy()

    def solve(self, b, trans=Trans.NOTRANS):
        """Single LU solve (no refinement), the ``pdgstrs`` analog.
        ``trans`` takes ``Trans``, 'N'/'T'/'C' or 0/1/2 and raises
        ``ValueError`` on anything else."""
        trans = _parse_trans(trans)
        if trans != Trans.NOTRANS:
            return self.solve_transposed(b, conj=trans == Trans.CONJ)
        return self._apply(b, self._lu_solve)

    def solve_transposed(self, b, conj: bool = False):
        """Solve Aᵀx = b (Aᴴx = b with ``conj``, the same system for a
        real dtype) with the same factorization: a forward Uᵀ sweep, then
        a backward Lᵀ sweep with the transposed diagonal inverses; Aᴴ
        through conjugation of b and x."""
        return self._apply(b, lambda r: self._lu_solve_t(r, conj))

    def _berr_t(self, x: torch.Tensor, b: torch.Tensor,
                trans: Trans = Trans.NOTRANS):
        """Componentwise backward error with the safe1/safe2 guards
        (reference: pdgsrfs.c:189-231) on the device, of the operator A,
        Aᵀ (TRANS) or Aᴴ (CONJ); returns (berr, r), berr real."""
        A = self._coo_ref
        if trans == Trans.NOTRANS:
            ax = _spmv.spmv(A, x)
            denom = _spmv.abs_spmv(A, x.abs())
        else:
            ax = _spmv.spmv_t(A, x, conj=trans == Trans.CONJ)
            denom = _spmv.abs_spmv_t(A, x.abs())
        r = b - ax
        denom = denom + b.abs()
        nz = self._max_row_nnz() + 1
        safe1 = nz * np.finfo(np.float64).tiny
        safe2 = safe1 / np.finfo(np.float64).eps
        num = r.abs()
        val = torch.where(denom > safe2, num / torch.clamp(denom, min=safe1),
                          (num + safe1) / (denom + safe1))
        return val.amax(dim=0), r

    def _berr(self, x, b, trans: Trans = Trans.NOTRANS):
        """Host-facing backward error of (n, k) arrays; returns (berr, r)
        as numpy."""
        rdt = _TORCH[self.refine_dtype]
        berr, r = self._berr_t(
            torch.as_tensor(np.asarray(x), device=self.device).to(rdt),
            torch.as_tensor(np.asarray(b), device=self.device).to(rdt),
            _parse_trans(trans))
        return berr.cpu().numpy(), r.cpu().numpy()

    def _max_row_nnz(self) -> int:
        """The largest row count of A (the berr guards' safe1/safe2); the
        processes of a sharded input take the broadcast global one, which
        every process must share."""
        if getattr(self, "_nz_global", None) is not None:
            return self._nz_global
        return int(self._A_orig.getnnz(axis=1).max())

    def refine(self, b, x0, trans=Trans.NOTRANS):
        """Iterative refinement with the JAX package's precision
        escalation (its driver.py:1561-1573, psgssvx_d2's pattern): when a
        low-pass factor under ``gemm_precision="auto"`` leaves refinement
        stalled above 1000·eps (:meth:`_should_escalate`), the factor is
        re-run at ``"highest"`` on the stored input values (timed under
        FACT), ``"highest"`` stays for later refactors, the counter
        ``precision_escalated`` is set, and refinement runs again from the
        stalled x. An explicit ``"bf16"`` never escalates. The port reads
        no ``SLU_TPU_CLK_GEMM_PRECISION``, so the re-factor runs at the
        precision the counter reports (ADVICE.md item 3, where the JAX
        package lets that variable override it). Returns (x, berr) as
        numpy arrays."""
        x, berr = self._refine_impl(b, x0, trans)
        if self._should_escalate(berr):
            self.stat.counters["precision_escalated"] = 1
            self._prec_sticky = True     # refactors skip the low pass
            self._refactor_values("highest")
            x, berr = self._refine_impl(b, x, trans)
        return x, berr

    def _refine_impl(self, b, x0, trans=Trans.NOTRANS):
        """Iterative refinement, the ``pdgsrfs`` analog (pdgsrfs.c:
        129-251), with residuals in ``refine_dtype`` on the device.
        Returns (x, berr) as numpy arrays.

        NOTRANS keeps the JAX package's fused loop exactly: the first step
        always runs; after it, refinement goes on while some berr > eps,
        every berr ≤ rthresh·(previous berr) and fewer than
        ``max_refine_steps`` steps ran. TRANS/CONJ keep its host loop
        (``_refine_hostloop``), which tests berr ≤ eps and "not halving"
        before each step, so no step may run."""
        self._require_factors()
        trans = _parse_trans(trans)
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
            if trans == Trans.NOTRANS:
                xt, berr, it = self._refine_fused(xt, bt, eps)
            else:
                xt, berr, it = self._refine_hostloop(xt, bt, eps, trans)
        self.stat.refine_steps = it
        x = xt.cpu().numpy()
        return (x[:, 0] if squeeze else x), np.atleast_1d(berr.cpu().numpy())

    def _refine_fused(self, xt, bt, eps):
        opts = self.options
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
        return xt, berr, it

    def _refine_hostloop(self, xt, bt, eps, trans):
        opts = self.options
        conj = trans == Trans.CONJ
        # berr is real whatever the residual's dtype
        prev = torch.full((bt.shape[1],), float("inf"), dtype=bt.real.dtype,
                          device=self.device)
        for it in range(opts.max_refine_steps):
            berr, r = self._berr_t(xt, bt, trans)
            if bool((berr <= eps).all()) or \
                    bool((berr > opts.refine_rthresh * prev).all()):
                return xt, berr, it
            prev = berr
            xt = xt + self._lu_solve_t(r, conj)
        berr, _ = self._berr_t(xt, bt, trans)
        return xt, berr, opts.max_refine_steps

    # ------------------------------------------------------------------
    # condition estimate (pdlangs + pdgscon analog)
    # ------------------------------------------------------------------

    def rcond_1(self) -> float:
        """Reciprocal 1-norm condition estimate by the Hager/Higham
        iteration (LAPACK dlacn2, which the reference's gscon path wraps)
        over :meth:`solve` and :meth:`solve_transposed`, as the JAX
        package computes it: at most 5 power steps, stopping when the
        estimate stops increasing or the dual test |z|∞ ≤ zᵀx fires, then
        the alternating-sign probe. ``stat.counters['rcond_iters']`` holds
        the steps and ``'rcond_converged'`` whether a test fired before
        the cap."""
        n = self.n
        anorm = (self._anorm1_global
                 if getattr(self, "_anorm1_global", None) is not None
                 else langs("1", self._A_orig))
        if anorm == 0:
            return 0.0
        x = np.full(n, 1.0 / n)
        est = 0.0
        converged = 0
        it = 0
        for it in range(1, 6):
            y = self.solve(x)
            est_new = float(np.abs(y).sum())
            if it > 1 and est_new <= est:
                converged = 1          # the estimate stopped increasing
                break
            est = max(est, est_new)
            xi = np.sign(y)
            xi[xi == 0] = 1.0
            z = self.solve_transposed(xi)
            j = int(np.argmax(np.abs(z)))
            if np.abs(z[j]) <= float(np.real(np.vdot(z, x))):
                converged = 1          # a stationary point of the dual
                break
            x = np.zeros(n)
            x[j] = 1.0
        # alternating-sign probe (guards against underestimation)
        i = np.arange(n)
        v = np.where(i % 2, -1.0, 1.0) * (1.0 + i / max(n - 1, 1))
        est = max(est, 2.0 * np.abs(self.solve(v)).sum() / (3.0 * n))
        self.stat.counters["rcond_iters"] = it
        self.stat.counters["rcond_converged"] = converged
        return float(1.0 / (anorm * est)) if est > 0 else 0.0

    # ------------------------------------------------------------------
    # extras
    # ------------------------------------------------------------------

    def profile_levels(self):
        """Per-elimination-level device timings of the factor (the JAX
        package's ``profile_levels``, driver.py:1674-1712 there): the
        current factors are released first, the pool is rebuilt from the
        factor's input values and the level executor (``schur``) runs one
        level per step, timed by CUDA events on the card (a host clock on
        the CPU). Returns one dict per level: level, ms, steps, lpanels,
        upanels, gemms, gflops_model (in real operations: a complex
        multiply-add counts 8, four times a real one). The profiled factors
        become the live ones, so the instance stays solve-ready; a level's
        ms include its launches' overhead, so read the shape, not the
        sum."""
        if getattr(self, "_a3_data", None) is None:
            raise RuntimeError(
                "profile_levels needs the factorization input values, which "
                "this instance does not carry (restored by load_factors) — "
                "use a freshly factored SparseLU")
        self.pool = self.linv = self.uinv = None
        plan, dev = self.plan, self.device
        tp = (self._ftapes if self.executor == "pallas"
              else _schur.build_level_tapes(plan, dev))
        pool = _blocklu.init_pool(plan, self._a3_data, self._fdtype, dev)
        bs = plan.bs
        linv = torch.zeros((plan.nb, bs, bs), dtype=pool.dtype, device=dev)
        uinv = torch.zeros_like(linv)
        tiny = torch.zeros(1, dtype=torch.int32, device=dev)
        thresh = self._thresh()
        cptr = tp.host["cptr"]
        b3 = float(bs) ** 3 * (4.0 if self._fdtype.kind == "c" else 1.0)
        rows = []
        for lvl in range(tp.nlvl):
            if dev.type == "cuda":
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                _schur.factor_level(pool, linv, uinv, tiny, thresh, tp, lvl)
                ev[1].record()
                torch.cuda.synchronize(dev)
                ms = ev[0].elapsed_time(ev[1])
            else:
                t0 = time.perf_counter()
                _schur.factor_level(pool, linv, uinv, tiny, thresh, tp, lvl)
                ms = (time.perf_counter() - t0) * 1e3
            steps = int(tp.dptr[lvl + 1] - tp.dptr[lvl])
            lp = int(tp.lptr[lvl + 1] - tp.lptr[lvl])
            up = int(tp.uptr[lvl + 1] - tp.uptr[lvl])
            gm = int(cptr[tp.sptr[lvl + 1]] - cptr[tp.sptr[lvl]])
            fl = (2.0 / 3.0) * b3 * steps + b3 * (lp + up) + 2.0 * b3 * gm
            rows.append(dict(level=lvl, ms=ms, steps=steps, lpanels=lp,
                             upanels=up, gemms=gm,
                             gflops_model=fl / max(ms * 1e-3, 1e-12) / 1e9))
        self.pool, self.linv, self.uinv = pool, linv, uinv
        self.stat.counters["profiled_levels"] = len(rows)
        self.stat.counters["profiled_executor"] = "pallas"
        return rows

    def diag_u(self) -> np.ndarray:
        """Diagonal of U in elimination order (reference: pdGetDiagU.c);
        complex from a ring-embedded pool (:func:`_diag_of_blocks`)."""
        blocks = self.pool[torch.as_tensor(np.asarray(
            self.plan.diag_slot, dtype=np.int64), device=self.device)]
        return self._diag_sel(_diag_of_blocks(blocks, self._embed))

    def _diag_sel(self, d: np.ndarray) -> np.ndarray:
        """The entries of the matrix's columns among the padded ones."""
        return d[slice(0, self.n) if self._expand is None else self._expand]

    def logdet(self):
        """(sign or phase, log|det A|), the PYTHON/pdbridge.py logdet
        analog: the diagonal of U, the scalings and the parity of the row
        permutation (the symmetric column permutation cancels). The first
        is a real sign for a real dtype and the complex phase
        det A / |det A| for a complex one (the JAX package's logdet)."""
        cplx = self.dtype.kind == "c"
        du = self.diag_u().astype(np.complex128 if cplx else np.float64)
        logabs = float(np.sum(np.log(np.abs(du)))
                       - np.sum(np.log(self.row_scale))
                       - np.sum(np.log(self.col_scale)))
        # real signs multiply exactly; complex phases in complex128
        phase = np.prod(du / np.abs(du)) * _perm_sign(self.rowperm)
        return (complex(phase) if cplx else float(phase)), logabs

    @classmethod
    def from_numpy_state(cls, state: dict, device=None) -> "SparseLU":
        """A solve-ready object from plain numpy arrays, e.g. the state of
        a JAX-package ``SparseLU``: ``options`` (optional), ``rowperm``,
        ``colperm``, ``row_scale``, ``col_scale``, ``expand`` (None
        without alignment), every ``SymbolicPlan`` field under ``plan``
        (a dict), ``pool``, ``linv``, ``uinv`` (bucket-padded rows are
        accepted and cut), ``anorm``, ``embed`` (optional: the factors of
        a complex64 state are float32 ones of the ring embedding), and the
        COO of the original A as
        ``a_row``, ``a_col``, ``a_data`` with ``n``. It serves every solve
        (NOTRANS and transposed), ``refine``, ``rcond_1`` and ``logdet``,
        and a SamePattern* ``refactor``.

        A complex state's factors may be native ``(rows, bs, bs)`` complex
        arrays or the JAX package's planar ``(rows, 2, bs, bs)`` real ones
        (re, im), which the number of dimensions tells apart; with
        ``embed`` true (the TPU's ring embedding of complex64) they are
        the float32 factors of the 2n real rows."""
        lu = cls._restore(state, device)
        plan, fdt = lu.plan, _TORCH[lu._fdtype]

        def dev(a, rows):
            a = np.asarray(a)
            if a.ndim == 4:     # planar complex (rows, 2, bs, bs)
                a = a[:, 0] + 1j * a[:, 1]
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
        lu._ttapes = lu._ftapes = None   # built when needed
        lu.executor = _executor(lu.options, lu._embed)
        return lu

    @classmethod
    def _restore(cls, state: dict, device) -> "SparseLU":
        """Everything of :meth:`from_numpy_state` but the factors and the
        tapes: options, plan, transforms, the original A and its COO."""
        lu = cls.__new__(cls)
        lu.options = state.get("options") or Options()
        lu.device = _resolve_device(device)
        _check_supported(lu.options, lu.device, state["a_data"])
        lu.stat = Stats()
        lu.stat.device = lu.device
        lu.n = int(state["n"])
        lu.dtype = np.dtype(_DTYPES[lu.options.dtype])
        lu.refine_dtype = _resolve_refine_dtype(lu.options)
        lu._embed = bool(state.get("embed", False))
        if lu._embed and lu.dtype != np.complex64:
            raise ValueError("a ring-embedded state holds a complex64 "
                             f"factor, not {lu.dtype.name}")
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
        lu._n_e = (plan.n // (2 if lu._embed else 1)
                   if lu._expand is not None else None)
        lu._rows_idx = lu._row_map(lu._expand)
        lu._anorm = float(state.get("anorm", 1.0))
        lu._A_orig = sp.csc_matrix(
            (np.asarray(state["a_data"]),
             (np.asarray(state["a_row"]), np.asarray(state["a_col"]))),
            shape=(lu.n, lu.n))
        lu._a3_data = None
        lu._coo_ref = _spmv.coo_arrays(lu._A_orig, lu.refine_dtype,
                                       lu.device)
        lu._transforms()
        lu.info = 0
        return lu


def gssvx(A, b, options: Optional[Options] = None,
          lu: Optional[SparseLU] = None, *, device=None):
    """One-call expert driver (``pdgssvx`` analog). Returns (result, lu).

    Under DOFACT, factors A on ``device`` (default ``cuda``; ``"cpu"``
    runs the plain PyTorch versions of the kernels). With ``lu``,
    ``options.fact`` stages the pddrive1/2/3 patterns on ``lu``'s device:
    SAME_PATTERN and SAME_PATTERN_SAME_ROWPERM refactor ``lu`` with A's
    values, FACTORED only solves (and needs ``lu``). The solve, the
    refinement residuals and berr follow ``options.trans`` (A, Aᵀ or Aᴴ,
    pdgssvx.c:622); ``condition_number`` fills ``rcond``."""
    options = options or Options()
    stat = Stats()
    if options.fact == Fact.FACTORED:
        if lu is None:
            raise ValueError("FACTORED requires an existing SparseLU")
        lu.stat = stat
        stat.device = lu.device
    elif lu is not None and options.fact in (
            Fact.SAME_PATTERN, Fact.SAME_PATTERN_SAME_ROWPERM):
        lu.stat = stat
        stat.device = lu.device
        lu.options = apply_env_overrides(options)
        lu.refactor(A, fact=options.fact)
    else:
        lu = SparseLU(A, options=options, stat=stat, device=device)

    x = lu.solve(np.asarray(b), trans=options.trans)
    if options.iter_refine != IterRefine.NOREFINE:
        x, berr = lu.refine(b, x, trans=options.trans)
    else:
        xb = x[:, None] if x.ndim == 1 else x
        bb = np.asarray(b)
        bb = bb[:, None] if bb.ndim == 1 else bb
        berr, _ = lu._berr(xb, bb, trans=options.trans)
    rcond = None
    if options.condition_number:
        with stat.phase("RCOND"):
            rcond = lu.rcond_1()
    return SolveResult(x=x, berr=np.atleast_1d(berr), stat=stat,
                       info=lu.info, rcond=rcond), lu


# ---------------------------------------------------------------------------
# factor persistence (SolveOnly / checkpoint-resume analog)
# ---------------------------------------------------------------------------


def _bucket125(x: int, lo: int = 8) -> int:
    """The JAX package's ``blocklu.bucket125``: the smallest value ≥ x of
    the form 2^k·{1, 1.25, 1.5, 1.75}."""
    x = max(int(x), lo)
    k = max(0, int(np.floor(np.log2(x))))
    for base in (1.0, 1.25, 1.5, 1.75, 2.0):
        cand = int(np.ceil((2 ** k) * base))
        if cand >= x:
            return cand
    return 2 ** (k + 1)


def _bucket_fine(x: int, lo: int = 8) -> int:
    """The JAX package's ``blocklu.bucket_fine`` (1/32-octave steps above
    65,536)."""
    x = max(int(x), lo)
    if x <= 1 << 16:
        return _bucket125(x, lo)
    k = int(np.floor(np.log2(x)))
    step = 2 ** k / 32.0
    return int(np.ceil(np.ceil(x / step) * step))


def _padded(t: torch.Tensor, rows: int) -> np.ndarray:
    a = t.cpu().numpy()
    out = np.zeros((rows,) + a.shape[1:], dtype=a.dtype)
    out[: len(a)] = a
    return out


def save_factors(lu: SparseLU, path) -> None:
    """Persist a factorization (block pool, diagonal inverses, symbolic
    plan, permutations, scalings and the original A for refinement) in
    the JAX package's ``.npz`` layout: its keys, and its bucket-padded
    shapes of ``pool`` (``bucket_fine(nslots + 2, lo=64)`` rows) and of
    ``linv``/``uinv`` (``bucket125(nb) + 1`` rows), so that either package
    loads the other's checkpoint. A complex factor is saved as its native
    ``(rows, bs, bs)`` complex pool, which the JAX package reads as
    non-planar; a ring-embedded complex64 one as its float32 pool with
    ``embed`` set. A grid split over several processes gathers its ranks'
    factors through the window and writes from process 0 only; a
    ``dist_planning`` session refuses, as no process holds the A that the
    checkpoint embeds for refinement."""
    from ..parallel import multihost as _mh
    plan = lu.plan
    if getattr(lu, "_nrloc", None) is not None and \
            getattr(lu.options, "dist_planning", False):
        raise NotImplementedError(
            "save_factors from a dist_planning session is not supported: "
            "NO process holds the global A this checkpoint embeds for "
            "refinement (that is the point of dist_planning) — gather "
            "mode or a single-process session can checkpoint")
    npool = _bucket_fine(plan.nslots + 2, lo=64)
    ninv = _bucket125(plan.nb) + 1
    # the distributed driver gathers its per-rank factors into this layout
    pool, linv, uinv = (lu._export_factors() if hasattr(lu, "_export_factors")
                        else (lu.pool, lu.linv, lu.uinv))
    if _mh.process_count() > 1 and _mh.process_index() != 0:
        # only process 0 holds the global A of a sharded input
        return
    A = sp.csc_matrix(lu._A_orig)
    np.savez_compressed(
        path,
        pool=_padded(pool, npool), linv=_padded(linv, ninv),
        uinv=_padded(uinv, ninv),
        rowperm=lu.rowperm, colperm=lu.colperm,
        row_scale=lu.row_scale, col_scale=lu.col_scale,
        a_indptr=A.indptr, a_indices=A.indices, a_data=A.data,
        a_shape=np.asarray(A.shape),
        dtype=np.asarray(str(lu.options.dtype)),
        block_size=np.asarray(lu.options.block_size),
        anorm=np.asarray(lu._anorm),
        embed=np.asarray(bool(lu._embed)),
        expand=(np.asarray(lu._expand) if lu._expand is not None
                else np.empty(0, dtype=np.int64)),
        **{"plan_" + f.name: np.asarray(getattr(plan, f.name))
           for f in dataclasses.fields(plan)})


def load_factors(path, options: Optional[Options] = None, *,
                 device=None) -> SparseLU:
    """A solve-ready :class:`SparseLU` from a :func:`save_factors`
    checkpoint of either package, without refactoring (the SolveOnly
    path), on ``device`` (default ``cuda``, which raises without CUDA
    unless ``device="cpu"``). The sweep tapes are rebuilt; the transposed
    tapes are built at the first transposed solve. Complex checkpoints
    load in each of the JAX package's layouts: native, planar and the
    ring embedding of complex64 (:meth:`SparseLU.from_numpy_state`)."""
    z = np.load(path, allow_pickle=False)
    options = (options or Options()).replace(
        dtype=str(z["dtype"]), block_size=int(z["block_size"]))
    plan = {}
    for f in dataclasses.fields(SymbolicPlan):
        v = z["plan_" + f.name]
        plan[f.name] = v if v.ndim else v.item()
    A = sp.coo_matrix(sp.csc_matrix(
        (z["a_data"], z["a_indices"], z["a_indptr"]),
        shape=tuple(z["a_shape"])))
    expand = z["expand"] if "expand" in z.files else None
    return SparseLU.from_numpy_state(dict(
        options=options, n=int(z["a_shape"][0]), rowperm=z["rowperm"],
        colperm=z["colperm"], row_scale=z["row_scale"],
        col_scale=z["col_scale"], expand=expand, plan=plan, pool=z["pool"],
        linv=z["linv"], uinv=z["uinv"], anorm=float(z["anorm"]),
        embed=bool(z["embed"]) if "embed" in z.files else False,
        a_row=A.row, a_col=A.col, a_data=A.data), device=device)
