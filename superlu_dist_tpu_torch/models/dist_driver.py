"""The 2D block-cyclic distributed driver (``pdgssvx`` on a process grid).

Port of the JAX package's ``models/dist_driver.py``: the host pipeline of
:class:`SparseLU` (equilibrate → MC64 → column ordering → etree alignment
→ block symbolic), then a factor and solves distributed block-cyclically
over the ranks of a :class:`Grid2D`. Each rank holds its own pool, its
owner-local inverse tables and its receive buffers; the factor and the
sweeps are the hand-written kernels of ``parallel/dist2d_rdma.py``, whose
broadcasts are stores into the peers' buffers; refinement computes its
residuals in ``refine_dtype`` (float64 or complex128) with the
distributed SpMV (``dist2d.dist_spmv``, of A, Aᵀ or Aᴴ).

It serves float32, float64, complex64 and complex128, the NOTRANS, TRANS
and CONJ solves (``solve(b, trans)``, ``solve_transposed``,
``Options.trans``, and refinement with the transposed residual),
``rcond_1`` and ``condition_number``, ``diag_u`` and ``logdet``, every
``Fact`` reuse mode, ``save_factors`` (which writes a checkpoint that
loads as a single-device :class:`SparseLU`), ``from_numpy_state`` and
:meth:`DistributedSparseLU.profile_levels`.

Several processes (``parallel/multihost.py``, after
``multihost.initialize``) split the grid's ranks, each a contiguous share
on the one card: process 0 preprocesses and plans, then broadcasts
(:class:`multihost.PreprocessOnce`); every process factors and solves its
own ranks' jobs, storing into the others' buffers through the window
(``parallel/window.py``); sharded NRLoc input (``local=True`` chunks)
stays distributed (:class:`ShardedNRLocInput`), and with ``dist_planning``
no process ever holds the global values or pattern. The factors and x
are bit-equal to a single process's on the same grid.

Deliberate differences from the JAX package:

- Every rank sits on one device: the card (``device`` defaults to
  ``cuda``), or the CPU, where the plain PyTorch versions run, in one
  process or split over several. A grid over several cards raises
  ``NotImplementedError`` (ROADMAP.md, queue 1 item 8d), and so do
  processes on different cards.
- ``dist_executor="rdma"`` and ``"xla"`` (the default) run the same two
  kernels: inside one process a psum over the ranks and a put into the
  peers' buffers move the same blocks (``tests/test_rdma.py`` holds the
  JAX package's two executors equal to roundoff). Any other name raises
  ``ValueError``.
- Every element type runs the RDMA kernels, where the JAX package runs
  them in float32 only and its XLA grid executor otherwise. Complex is
  native (the kernels' element type is complex64 or complex128); with
  ``SLU_TPU_COMPLEX=embed`` complex64 takes the real ring embedding of
  the JAX package's TPU meshes on the float32 entries (the preprocessing
  is :class:`SparseLU`'s, the solves embed and read back as its do), and
  ``from_numpy_state`` reads such a grid state. Aᴴx = b is solved as x =
  conj(A⁻ᵀ conj(b)), as the single-device driver does (natively, through
  the transposed sweeps, in the embedding).
- ``profile_levels`` times the RDMA factor one level at a time (CUDA
  events on the card, a host clock on the CPU), and its factors become
  the live ones, as the single-device driver's do; the JAX package times
  prefixes of its XLA factor on copies of the pools.
- The refinement's SpMV shards hold whole rows (``dist2d.coo_shards``),
  where the JAX package's hold equal slices of A's COO: its sums are then
  the same bits from the whole A and from NRLoc chunks, in one process or
  several.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from ..parallel import dist2d as _dist2d
from ..parallel import dist2d_rdma as _rdma
from ..parallel import multihost as _mh
from ..parallel import window as _window
from ..parallel.grid import SEVERAL_CARDS, Grid2D
from ..utils.options import (IterRefine, Options, Trans,
                             apply_env_overrides)
from ..utils.stats import Stats
from .driver import (_TORCH, SolveResult, SparseLU, _diag_of_blocks,
                     _resolve_device)

DIST_EXECUTORS = ("rdma", "xla")


def _check_dist(opts: Options) -> None:
    """Refuse an executor name that the grid does not know."""
    if opts.dist_executor not in DIST_EXECUTORS:
        raise ValueError(f"unknown dist_executor {opts.dist_executor!r}; "
                         f"expected one of {DIST_EXECUTORS}")


def _check_processes(grid, device: torch.device) -> None:
    """A grid split over processes: its ranks must split evenly, and
    every process must sit on the same card (a collective)."""
    grid.owned_ranks()
    if _mh.process_count() > 1 and \
            len(set(_mh.allgather_obj(_mh.device_key(device)))) > 1:
        raise NotImplementedError(
            "processes of one grid on several cards are not ported yet "
            f"(ROADMAP.md, {SEVERAL_CARDS}): every process of a grid "
            "runs on one card")


class ShardedNRLocInput:
    """Mixin shared by the 2D and 3D grid drivers (the JAX package's):
    sharded NRLoc input (``local=True`` chunks, one set per process)
    stays distributed. Values gather ONLY to process 0 (the
    pdgssvx.c:768-794 gather role for rowperm/symbolic); the pools are
    built straight from the local chunks (``_pools0``, dReDistribute_A
    analog), whose entries every process stores into their owners' pools
    through the window. Host paths that need global values raise clear
    errors instead."""

    _nrloc = None

    def _sharded(self) -> bool:
        return self._nrloc is not None and _mh.process_count() > 1

    def _dist_planning_active(self) -> bool:
        return (self.options.dist_planning and self._nrloc is not None
                and _mh.process_count() > 1)

    def _validate_dist_planning(self) -> None:
        from ..utils.options import ColPerm, Equil, RowPerm
        o = self.options
        if (o.equil != Equil.NO
                or o.row_perm not in (RowPerm.NOROWPERM, RowPerm.MY_PERMR)
                or o.col_perm not in (ColPerm.NATURAL, ColPerm.MY_PERMC)
                or o.ilu_level is not None
                or "complex" in str(o.dtype)):
            raise ValueError(
                "dist_planning requires equil=NO, row_perm in "
                "{NOROWPERM, MY_PERMR}, col_perm in {NATURAL, MY_PERMC} "
                "a real dtype, and complete LU — equilibration/MC64/"
                "fill-reducing orderings read global values, and the "
                "complex ring embedding reshapes the block pattern "
                "(the reference's "
                "parallel-symbolic path has the same contract: it runs "
                "under a ParMETIS-supplied ordering, "
                "get_perm_c_parmetis.c:255)")

    def _ingest_input(self, A):
        from ..utils.nrloc import NRLocMatrix
        self._nrloc = None
        if isinstance(A, NRLocMatrix) and A.local:
            if _mh.process_count() == 1:
                raise ValueError("local=True NRLoc input requires "
                                 "multi-process execution")
            self._nrloc = A
            if self.options.dist_planning:
                # distributed planning: NO process assembles global
                # values or the scalar pattern — not even process 0.
                # Everything downstream works from local chunks + the
                # allgathered block keys (see _symbolic).
                self._validate_dist_planning()
                return A.to_partial_csc()
            # full precision with a dtype every process agrees on
            # regardless of its local nnz
            gdt = (np.complex128 if "complex" in self.options.dtype
                   else np.float64)
            rows, cols, vals = A.to_coo_arrays(gdt)
            Ag = _dist2d.gather_values_to0(rows, cols, vals, A.n, gdt)
            # process 0 preprocesses on the gathered matrix; the others
            # keep only their local rows (O(local nnz) host memory)
            return Ag if _mh.process_index() == 0 else A.to_partial_csc()
        return super()._ingest_input(A)

    def _preprocess(self, A, reuse_perms: bool = False,
                    reuse_colperm: bool = False):
        """Sharded-input preprocessing, all fact_t staging modes
        (DOFACT / SamePattern / SamePattern_SameRowPerm — the reference
        supports the full staging with distributed input,
        pdgssvx.c:506-2783): process 0 works on the gathered matrix and
        broadcasts; the others consume the broadcast and never build a
        global A3 — their pools come from local chunks in ``_pools0``."""
        if self._dist_planning_active():
            # every process runs the same cheap transforms locally — no
            # broadcast, no global matrix anywhere (psymbfact discipline)
            from ..utils.options import ColPerm, DiagScale, RowPerm
            n = self.n
            self.row_scale = np.ones(n)
            self.col_scale = np.ones(n)
            o = self.options
            self.rowperm = (np.asarray(o.user_rowperm, dtype=np.int64)
                            if o.row_perm == RowPerm.MY_PERMR
                            and o.user_rowperm is not None
                            else np.arange(n, dtype=np.int64))
            self.colperm = (np.asarray(o.user_colperm, dtype=np.int64)
                            if o.col_perm == ColPerm.MY_PERMC
                            and o.user_colperm is not None
                            else np.arange(n, dtype=np.int64))
            self.equed = DiagScale.NOEQUIL
            self._expand = None
            self._n_e = None
            # global norm extras from local chunks (O(1) scalars each)
            vals = np.abs(self._A_orig.data) if self._A_orig.nnz else \
                np.zeros(1)
            local = (float(vals.max(initial=0.0)),
                     int(self._A_orig.getnnz(axis=1).max(initial=0)),
                     np.asarray(np.abs(self._A_orig).sum(axis=0)).ravel())
            gathered = _mh.allgather_obj(local)
            self._anorm_global = max(g[0] for g in gathered) or 1.0
            self._nz_global = max(g[1] for g in gathered)
            self._anorm1_global = float(
                np.sum([g[2] for g in gathered], axis=0).max())
            return self._A_orig
        if self._sharded():
            if _mh.process_index() != 0:
                if reuse_perms:
                    # SamePattern_SameRowPerm: scales/perms are reused
                    # wholesale; only the new matrix's norm extras arrive
                    extras = _mh.bcast_obj()
                else:
                    # DOFACT / SamePattern: fresh scales + perms
                    (self.row_scale, self.col_scale, self.rowperm,
                     self.colperm, self._expand, self._n_e, self.equed,
                     extras) = _mh.bcast_obj()
                self._anorm_global = extras["anorm"]
                self._anorm1_global = extras["anorm1"]
                self._nz_global = extras["nz"]
                return sp.csc_matrix((self.n, self.n))
            if reuse_perms:
                # process 0: rebuild A3 from the gathered values with the
                # stored transforms, then broadcast the norm extras the
                # other processes need for a consistent pivot threshold
                A3 = super()._preprocess(A, reuse_perms, reuse_colperm)
                extras = dict(
                    anorm=float(np.abs(A3.data).max()) if A3.nnz else 1.0,
                    anorm1=float(np.abs(A).sum(axis=0).max()),
                    nz=int(A.getnnz(axis=1).max()))
                _mh.bcast_obj(extras)
                self._anorm_global = extras["anorm"]
                self._anorm1_global = extras["anorm1"]
                self._nz_global = extras["nz"]
                return A3
        return super()._preprocess(A, reuse_perms, reuse_colperm)

    def _symbolic(self, A3):
        if self._dist_planning_active():
            # each process contributes only its chunk's BLOCK keys
            # (O(a_blocks) total — the scalar pattern never moves);
            # every process then derives the identical plan locally
            from ..ops.host.symbolic import block_symbolic_from_keys
            bs = self.options.block_size
            nb = max(1, -(-self.n // bs))
            P = sp.coo_matrix(self._A_orig)
            ipc = np.empty(self.n, dtype=np.int64)
            ipc[self.colperm] = np.arange(self.n)
            irp = np.empty(self.n, dtype=np.int64)
            irp[self.rowperm] = np.arange(self.n)
            r3 = ipc[irp[P.row]]
            c3 = ipc[P.col]
            keys = np.unique((r3 // bs) * nb + (c3 // bs))
            a_keys = np.unique(np.concatenate(_mh.allgather_obj(keys)))
            self.stat.counters["dist_planning_blocks"] = int(len(a_keys))
            self.stat.counters["dist_planning_local_keys"] = int(len(keys))
            return block_symbolic_from_keys(self.n, bs, a_keys)
        return super()._symbolic(A3)

    def _refine_hostloop(self, xt, bt, eps, trans):
        if self._sharded():
            raise NotImplementedError(
                "host-loop refinement needs global A values; with sharded "
                "NRLoc input use real dtypes (in-mesh fused refinement) "
                "or pass a gathered matrix")
        return super()._refine_hostloop(xt, bt, eps, trans)

    def _berr(self, x, b, trans=Trans.NOTRANS):
        if self._sharded():
            raise NotImplementedError(
                "componentwise berr on the host needs global A; with "
                "sharded NRLoc input run refine() (in-mesh berr) instead")
        return super()._berr(x, b, trans)


def _grid_device(grid: Grid2D, device) -> torch.device:
    """The one device of every rank: the grid's, else ``device``, else
    the card."""
    if grid.devices is None:
        return _resolve_device(device)
    dev = _resolve_device(grid.rank_device(None))
    if device is not None and _resolve_device(device) != dev:
        raise ValueError(f"device {device} differs from the grid's {dev}")
    return dev


class DistributedSparseLU(ShardedNRLocInput, _mh.PreprocessOnce, SparseLU):
    """2D block-cyclic distributed factorization (pdgssvx analog) over
    the ranks of ``grid``. ``pool``, ``linv`` and ``uinv`` are lists with
    one tensor per rank (rank r·Pc + c at index r·Pc + c): the rank's
    ``(n_local, bs, bs)`` pool and its ``(dlen + 1, bs, bs)`` owner-local
    inverse tables."""

    #: the grid this driver partitions over
    _grid_type = Grid2D
    #: the plan is kept as built, as the JAX package's distributed driver
    #: does; alignment stays on
    _adapt_ok = False
    #: no precision escalation runs: the grid's factor is FP32 (or the
    #: working type), and reports "highest" (the JAX package's
    #: dist_driver.py:202)
    _escalate_ok = False

    def __init__(self, A, grid: Grid2D, options: Optional[Options] = None,
                 stat: Optional[Stats] = None, *, device=None):
        if not isinstance(grid, self._grid_type):
            raise TypeError(f"{type(self).__name__} takes a "
                            f"{self._grid_type.__name__}, not {grid!r}")
        self.grid = grid
        self._dplan_of = None
        self._fstate = None
        _check_dist(apply_env_overrides(options or Options()))
        dev = _grid_device(grid, device)
        _check_processes(grid, dev)
        super().__init__(A, options=options, stat=stat, device=dev)

    def _window(self) -> _window.Window:
        """A window over the grid's ranks (a collective)."""
        return _window.Window(self.grid.size, self.device)

    @contextlib.contextmanager
    def _fences(self, what: str):
        """Count the window fences and shared allocations of the enclosed
        work in ``stat.counters`` (``{what}_window_fences``,
        ``{what}_window_fence_ms``, ``{what}_window_allocs``,
        ``{what}_window_alloc_ms``; ``what`` is "fact" for the factor,
        "solve" for the sweeps and the SpMVs) when the ranks are split
        over processes."""
        tallies = {"fence": _window.FENCES, "alloc": _window.ALLOCS}
        before = {k: (t.count, t.seconds) for k, t in tallies.items()}
        yield
        if _mh.process_count() > 1:
            ctr = self.stat.counters
            for k, t in tallies.items():
                c0, s0 = before[k]
                n, ms = f"{what}_window_{k}s", f"{what}_window_{k}_ms"
                ctr[n] = ctr.get(n, 0) + t.count - c0
                ctr[ms] = ctr.get(ms, 0.0) + (t.seconds - s0) * 1e3

    # -- the factor on the grid ------------------------------------------

    def _build_tapes(self):
        """Partition the plan over the grid and build the kernels' job
        lists, once per plan (the transposed sweeps' at the first
        transposed solve, in ``_ttapes``, which a new plan drops)."""
        self.dplan = self._partition()
        self._ft = self._factor_tapes()
        self._lt, self._ut = (self._sweep_tapes(w) for w in "LU")
        self._ttapes = None
        self._dplan_of = self.plan

    def _partition(self):
        return _dist2d.partition_plan(self.plan, self.grid.nprow,
                                      self.grid.npcol)

    def _factor_tapes(self):
        return _rdma.build_factor_tapes(self.plan, self.dplan, self.device)

    def _sweep_tapes(self, which: str):
        """The job lists of sweep ``which`` ("L", "U", "LT", "UT")."""
        return _rdma.build_sweep_tapes(self.plan, self.dplan, which,
                                       self.device)

    def _build_coo_shards(self):
        """The COO of the current A split over the ranks in runs of whole
        rows, and of whole columns, for the distributed residuals of A and
        of Aᵀ / Aᴴ (re-made per factorization, so a refactor refines
        against its own values); this process's ranks' only when the ranks
        are split over processes, from its own chunks when the input is
        sharded (which refines NOTRANS only, as the JAX package does)."""
        ndev, own = self.grid.size, self.grid.owned_ranks()
        self._spmv_win = self._window()
        if self._sharded():
            self._coo_shards = _dist2d.make_coo_shards_nrloc(
                self._nrloc.chunks, self.n, ndev, own, self.refine_dtype,
                self.device)
            self._coo_shards_t = None
            return
        self._coo_shards, self._coo_shards_t = (
            _dist2d.coo_shards(self._A_orig, ndev, self.refine_dtype,
                               self.device, transpose=t, ranks=own)
            for t in (False, True))

    def _nrloc_entries(self, offsets):
        """This process's entries of a sharded input mapped to their
        owners by ``offsets`` (``dist2d.nrloc_entry_offsets`` or its 3D
        twin); process 0 adds the padding diagonal."""
        return offsets(self.plan, self.dplan, self._nrloc.chunks,
                       self.row_scale, self.col_scale, self.rowperm,
                       self.colperm, self._expand, self._n_e, self.n,
                       embed=self._embed,
                       with_identity=_mh.process_index() == 0)

    def _pools0(self, win=None) -> list:
        """The per-rank pools of the factor's input values, tensors of
        the window ``win`` (a new one when None): this process's ranks'
        from A3, or every rank's from this process's chunks of a sharded
        input."""
        win = win or self._window()
        if self._sharded():
            dev, off, val = self._nrloc_entries(_dist2d.nrloc_entry_offsets)
            return _dist2d.init_local_pools_nrloc(
                self.plan, self.dplan, win, dev, off, val, self._fdtype)
        return _dist2d.init_local_pools(self.plan, self.dplan, self._a3_data,
                                        self._fdtype, self.device, win)

    def _set_factors(self, st):
        self._fstate = st
        self.pool, self.linv, self.uinv = st.pool, st.linv, st.uinv

    def _dist_counters(self) -> dict:
        """The partition's counters of the DIST phase."""
        return self.dplan.comm_volume(np.dtype(self._fdtype).itemsize)

    def _run_factor(self, pools, win):
        """Factor ``pools`` (tensors of the window ``win``); returns the
        factor's state and its tiny-pivot count (the sum over the ranks)
        as a device scalar."""
        st = _rdma.rdma_factor(pools, self._thresh(), self._ft, win=win)
        return st, torch.stack(st.tiny).sum()

    def _factor_level(self, st, thresh, level: int) -> None:
        """One level of the factor (:meth:`profile_levels`)."""
        _rdma.rdma_factor_level(st, thresh, self._ft, level)

    def _level_row(self, level: int) -> dict:
        """A :meth:`profile_levels` row's counts of ``level``: steps,
        panels and Schur products, summed over the ranks."""
        ft = self._ft
        b = ft.host["b_side"][ft.bptr[level, 0]:ft.bptr[level, -1]]
        cptr = ft.host["cptr"]
        return dict(steps=int(ft.aptr[level, -1] - ft.aptr[level, 0]),
                    lpanels=int((b == 0).sum()), upanels=int((b == 1).sum()),
                    gemms=int(cptr[ft.sptr[level, -1]]
                              - cptr[ft.sptr[level, 0]]))

    def _recv(self, recv, names) -> dict:
        """Per-rank counters by kind, shaped as the grid and the levels."""
        return _rdma.stacked_recv(recv, self.grid.nprow, self.grid.npcol,
                                  names, getattr(self.grid, "npdep", 1))

    def _release_factors(self):
        """Drop the factors, and their window (a collective)."""
        if self._fstate is not None:
            self._fstate.win.close()
        self.pool = self.linv = self.uinv = self._fstate = None

    def _device_factor(self, A3: sp.csc_matrix):
        self._release_factors()
        stat, plan = self.stat, self.plan
        self._a3_data = np.asarray(A3.data)
        with stat.phase("DIST"):
            if self._dplan_of is not plan:
                self._build_tapes()
            win = self._window()
            pools = self._pools0(win)
            self._build_coo_shards()
        stat.counters.update(self._dist_counters())
        stat.counters["executor"] = self.executor = "rdma"
        stat.counters["dist_executor"] = self.options.dist_executor
        stat.counters["gemm_precision"] = "highest"
        with stat.phase("FACT"), self._fences("fact"):
            st, tiny = self._run_factor(pools, win)
        self._set_factors(st)
        stat.tiny_pivots += int(tiny)

    def factor_recv(self) -> dict:
        """The factor's receive counts as (pr, pc, nlvl) arrays by kind
        (``rcv_li``, ``rcv_ui``, ``rcv_l``, ``rcv_u``), as the puts tallied
        them; equal to ``build_rdma_recv_tapes`` of the plan."""
        return self._recv(self._fstate.recv, _rdma.FACTOR_RECV)

    def profile_levels(self):
        """Per-elimination-level device timings of the distributed factor
        (the JAX package's ``profile_levels``, dist_driver.py:622-686
        there): the current factors are released, the per-rank pools are
        rebuilt from the factor's input values and each level's
        ``rdma_diag``, ``rdma_panel`` and ``rdma_schur`` launches run as
        one step, timed by CUDA events on the card (a host clock on the
        CPU). Returns one dict per level: level, ms, steps, lpanels,
        upanels, gemms, summed over the ranks. The profiled factors
        become the live ones, so the instance stays solve-ready."""
        if getattr(self, "_a3_data", None) is None:
            raise RuntimeError(
                "profile_levels needs the factorization input values, which "
                "this instance does not carry (restored from a state) — use "
                "a freshly factored DistributedSparseLU")
        self._release_factors()
        ft, dev, win = self._ft, self.device, self._window()
        st = _rdma.new_factor_state(self._pools0(win), ft, win)
        thresh = self._thresh()
        rows = []
        for lvl in range(ft.nlvl):
            if dev.type == "cuda":
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                self._factor_level(st, thresh, lvl)
                ev[1].record()
                torch.cuda.synchronize(dev)
                ms = ev[0].elapsed_time(ev[1])
            else:
                t0 = time.perf_counter()
                self._factor_level(st, thresh, lvl)
                ms = (time.perf_counter() - t0) * 1e3
            rows.append(dict(level=lvl, ms=ms, **self._level_row(lvl)))
        st.win.fence()      # every rank's factors final, as rdma_factor's
        self._set_factors(st)
        self.stat.counters["profiled_levels"] = len(rows)
        return rows

    # -- solves ----------------------------------------------------------

    def _sweeps(self, X: torch.Tensor) -> torch.Tensor:
        """The L and U sweeps on every rank's replicated X (the transforms
        are :meth:`SparseLU._lu_solve`'s)."""
        with self._fences("solve"):
            X, rl, ru = _rdma.rdma_solve(self.pool, self.linv, self.uinv,
                                         self._lt, self._ut, X)
        self._solve_recv = (rl, ru)
        return X

    def _sweeps_t(self, X: torch.Tensor) -> torch.Tensor:
        """The transposed sweeps (Uᵀ with the ranks' uinv, then Lᵀ with
        their linv) of :meth:`SparseLU._lu_solve_t`; the transposed tapes
        are built on the first call and kept with the plan."""
        if self._ttapes is None:
            self._ttapes = tuple(self._sweep_tapes(w) for w in ("LT", "UT"))
        lt, ut = self._ttapes
        with self._fences("solve"):
            X, rl, ru = _rdma.rdma_solve(self.pool, self.linv, self.uinv,
                                         lt, ut, X)
        self._solve_recv_t = (rl, ru)
        return X

    def solve_recv(self, transpose: bool = False) -> tuple:
        """The last solve's receive counts (of the last transposed solve
        with ``transpose``): for the L and the U sweep (the Lᵀ and the Uᵀ)
        a dict of (pr, pc, nlvl) arrays ``rcv_part`` and ``rcv_x``."""
        got = self._solve_recv_t if transpose else self._solve_recv
        return tuple(self._recv(r, _rdma.SOLVE_RECV) for r in got)

    def _berr_t(self, x: torch.Tensor, b: torch.Tensor,
                trans: Trans = Trans.NOTRANS):
        """Componentwise backward error of :meth:`SparseLU._berr_t`, with
        op(A)·x and |op(A)|·|x| by the distributed SpMV over the ranks'
        COO shards (the JAX package's in-mesh ``berr_of``), of A, or of
        the transposed shards for Aᵀ and Aᴴ."""
        shards = self._coo_shards if trans == Trans.NOTRANS \
            else self._coo_shards_t
        with self._fences("solve"):
            r = b - _dist2d.dist_spmv(shards, x, self.n,
                                      conj=trans == Trans.CONJ,
                                      win=self._spmv_win)
            denom = _dist2d.dist_spmv(shards, x.abs(), self.n,
                                      absolute=True,
                                      win=self._spmv_win) + b.abs()
        nz = self._max_row_nnz() + 1
        safe1 = nz * np.finfo(np.float64).tiny
        safe2 = safe1 / np.finfo(np.float64).eps
        num = r.abs()
        val = torch.where(denom > safe2, num / torch.clamp(denom, min=safe1),
                          (num + safe1) / (denom + safe1))
        return val.amax(dim=0), r

    # -- extras ----------------------------------------------------------

    def _slot_owner(self):
        """Each global slot's rank and local slot."""
        return np.asarray(self.dplan.owner_dev), \
            np.asarray(self.dplan.local_slot)

    def _inv_rows(self) -> np.ndarray:
        """Each step's row in the inverse tables of its diagonal block's
        rank."""
        return np.asarray(self.dplan.dinv_idx)

    def _owned(self, slots):
        """For global slots ``slots``: each rank's (positions in
        ``slots``, local slots) of the ones it owns."""
        own, loc = self._slot_owner()
        own, loc = own[slots], loc[slots]
        for e in range(self.grid.size):
            sel = np.flatnonzero(own == e)
            if len(sel):
                yield e, sel, loc[sel]

    def diag_u(self) -> np.ndarray:
        """Diagonal of U in elimination order, from the diagonal blocks
        gathered from their owners (reference: pdGetDiagU.c); complex from
        a ring-embedded factor, as :meth:`SparseLU.diag_u` reads it."""
        plan, dev = self.plan, self.device
        blocks = torch.empty((plan.nb, plan.bs, plan.bs),
                             dtype=self.pool[0].dtype, device=dev)
        for e, sel, loc in self._owned(np.asarray(plan.diag_slot)):
            blocks[torch.as_tensor(sel, device=dev)] = \
                self.pool[e][torch.as_tensor(loc, device=dev)]
        return self._diag_sel(_diag_of_blocks(blocks, self._embed))

    def _export_factors(self):
        """The per-rank factors gathered into the single-device layout
        (pool rows by global slot, with the zero and trash slots at
        nslots and nslots + 1; inverses by elimination step), so that
        ``save_factors`` writes a checkpoint that loads as a single-device
        :class:`SparseLU`."""
        plan, dev = self.plan, self.device
        bs, nb = plan.bs, plan.nb
        pool = torch.zeros((plan.nslots + 2, bs, bs),
                           dtype=self.pool[0].dtype, device=dev)
        for e, sel, loc in self._owned(np.arange(plan.nslots)):
            pool[torch.as_tensor(sel, device=dev)] = \
                self.pool[e][torch.as_tensor(loc, device=dev)]
        linv = torch.zeros((nb, bs, bs), dtype=pool.dtype, device=dev)
        uinv = torch.zeros_like(linv)
        idx = self._inv_rows()
        for e, sel, _ in self._owned(np.asarray(plan.diag_slot)):
            s = torch.as_tensor(sel, device=dev)
            i = torch.as_tensor(idx[sel], device=dev)
            linv[s] = self.linv[e][i]
            uinv[s] = self.uinv[e][i]
        return pool, linv, uinv

    @classmethod
    def from_numpy_state(cls, state: dict, grid: Grid2D,
                         device=None) -> "DistributedSparseLU":
        """A solve-ready distributed object from plain numpy arrays, e.g.
        the state of a JAX-package ``DistributedSparseLU``: the fields of
        :meth:`SparseLU.from_numpy_state` (plan, transforms, the COO of A)
        with the per-rank factors ``pool`` of shape (pr, pc, n_local, bs,
        bs) and ``linv``/``uinv`` of shape (pr, pc, dlen + 1, bs, bs), in
        any of the four dtypes (complex as native complex arrays, the JAX
        package's grid layout off the TPU), or, with ``embed`` true, the
        float32 factors of the ring embedding of complex64 (the TPU
        meshes' layout). The plan is partitioned again, and its
        ``n_local`` and ``dlen`` must agree with the arrays'."""
        options = apply_env_overrides(state.get("options") or Options())
        _check_dist(options)
        dev = _grid_device(grid, device)
        _check_processes(grid, dev)
        lu = cls._restore(dict(state, options=options), dev)
        lu.grid = grid
        lu._fstate = None
        lu._build_tapes()
        pool = np.asarray(state["pool"])
        linv, uinv = np.asarray(state["linv"]), np.asarray(state["uinv"])
        pr, pc = grid.shape
        want = (pr, pc, lu.dplan.n_local)
        if pool.shape[:3] != want:
            raise ValueError(f"pool has shape {pool.shape[:3]} + blocks, the "
                             f"partition needs {want}")
        for name, a in (("linv", linv), ("uinv", uinv)):
            if a.shape[:3] != (pr, pc, lu._ft.dlen + 1):
                raise ValueError(f"{name} has shape {a.shape[:3]} + blocks, "
                                 f"the partition needs "
                                 f"{(pr, pc, lu._ft.dlen + 1)}")
        fdt, win = _TORCH[lu._fdtype], lu._window()

        def ranks(a):
            a = a.reshape((pr * pc,) + a.shape[2:])
            out = win.alloc(a.shape[1:], fdt)
            for d in win.ranks:
                out[d].copy_(torch.tensor(a[d], dtype=fdt))
            return out

        lu.pool, lu.linv, lu.uinv = ranks(pool), ranks(linv), ranks(uinv)
        win.fence()
        lu.executor = "rdma"
        lu._build_coo_shards()
        return lu


def gssvx_dist(A, b, grid: Grid2D, options: Optional[Options] = None, *,
               device=None):
    """Distributed one-call driver: factor A over ``grid``, solve and
    refine. Returns (SolveResult, DistributedSparseLU). ``device``
    defaults to ``cuda``; ``"cpu"`` runs the plain PyTorch versions. The
    solve, the refinement residuals and berr follow ``options.trans`` (A,
    Aᵀ or Aᴴ, pdgssvx.c:622); ``condition_number`` fills ``rcond``."""
    return _gssvx_on(DistributedSparseLU, A, b, grid, options, device)


def _gssvx_on(cls, A, b, grid, options, device):
    """Factor A over ``grid`` with the driver ``cls``, solve and refine
    (:func:`gssvx_dist`)."""
    options = options or Options()
    stat = Stats()
    lu = cls(A, grid, options=options, stat=stat, device=device)
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

