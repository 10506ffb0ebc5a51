"""The 2D block-cyclic distributed driver (``pdgssvx`` on a process grid).

Port of the JAX package's ``models/dist_driver.py``: the host pipeline of
:class:`SparseLU` (equilibrate → MC64 → column ordering → etree alignment
→ block symbolic), then a factor and solves distributed block-cyclically
over the ranks of a :class:`Grid2D`. Each rank holds its own pool, its
owner-local inverse tables and its receive buffers; the factor and the
sweeps are the hand-written kernels of ``parallel/dist2d_rdma.py``, whose
broadcasts are stores into the peers' buffers; refinement computes its
float64 residuals with the distributed SpMV (``dist2d.dist_spmv``).

Deliberate differences from the JAX package:

- One process drives every rank, and every rank sits on one device: the
  card (``device`` defaults to ``cuda``), or the CPU, where the plain
  PyTorch versions run. A grid over several cards raises
  ``NotImplementedError`` (ROADMAP.md, queue 1 item 8d).
- ``dist_executor="rdma"`` and ``"xla"`` (the default) run the same two
  kernels: inside one process a psum over the ranks and a put into the
  peers' buffers move the same blocks (``tests/test_rdma.py`` holds the
  JAX package's two executors equal to roundoff). Any other name raises
  ``ValueError``.
- float32 only, as the JAX package's RDMA path; float64 and complex
  (queue 1 items 8b and 4), the transposed solve, ``rcond_1`` and
  ``condition_number`` (item 8a), ``profile_levels`` (item 8c), sharded
  NRLoc input and several processes (item 10) raise
  ``NotImplementedError`` naming their item.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from ..parallel import dist2d as _dist2d
from ..parallel import dist2d_rdma as _rdma
from ..parallel.grid import Grid2D
from ..utils.options import (Fact, IterRefine, Options, Trans,
                             apply_env_overrides)
from ..utils.stats import Stats
from .driver import (_TORCH, SolveResult, SparseLU, _parse_trans,
                     _resolve_device)

#: the ROADMAP items of what the grid does not serve yet
_TRANS_ITEM = "queue 1 item 8a"
_F64_ITEM = "queue 1 item 8b"
_PROFILE_ITEM = "queue 1 item 8c"
_MULTIPROC_ITEM = "queue 1 item 10"

DIST_EXECUTORS = ("rdma", "xla")


def _todo(what: str, item: str):
    raise NotImplementedError(
        f"{what} on a process grid is not ported yet (ROADMAP.md, {item})")


def _check_dist(opts: Options, A) -> None:
    """Refuse what the grid does not serve yet (see the module doc)."""
    if opts.dtype in ("complex64", "complex128") or \
            np.iscomplexobj(getattr(A, "data", A)):
        _todo("complex dtypes", "queue 1 items 4 and 8b")
    if opts.dtype != "float32":
        _todo(f"dtype {opts.dtype!r}", _F64_ITEM)
    if opts.dist_executor not in DIST_EXECUTORS:
        raise ValueError(f"unknown dist_executor {opts.dist_executor!r}; "
                         f"expected one of {DIST_EXECUTORS}")
    if _parse_trans(opts.trans) != Trans.NOTRANS:
        _todo("the transposed solve (Options.trans)", _TRANS_ITEM)
    if opts.condition_number:
        _todo("the condition estimate (condition_number)", _TRANS_ITEM)
    if opts.dist_planning or getattr(A, "local", False):
        _todo("sharded NRLoc input (dist_planning, local chunks)",
              _MULTIPROC_ITEM)
    if torch.distributed.is_available() and \
            torch.distributed.is_initialized() and \
            torch.distributed.get_world_size() > 1:
        _todo("a grid over several processes", _MULTIPROC_ITEM)


def _grid_device(grid: Grid2D, device) -> torch.device:
    """The one device of every rank: the grid's, else ``device``, else
    the card."""
    if grid.devices is None:
        return _resolve_device(device)
    dev = _resolve_device(grid.rank_device(None))
    if device is not None and _resolve_device(device) != dev:
        raise ValueError(f"device {device} differs from the grid's {dev}")
    return dev


class DistributedSparseLU(SparseLU):
    """2D block-cyclic distributed factorization (pdgssvx analog) over
    the ranks of ``grid``. ``pool``, ``linv`` and ``uinv`` are lists with
    one tensor per rank (rank r·Pc + c at index r·Pc + c): the rank's
    ``(n_local, bs, bs)`` pool and its ``(dlen + 1, bs, bs)`` owner-local
    inverse tables."""

    #: the plan is kept as built, as the JAX package's distributed driver
    #: does; alignment stays on and no precision escalation runs
    _adapt_ok = False

    def __init__(self, A, grid: Grid2D, options: Optional[Options] = None,
                 stat: Optional[Stats] = None, *, device=None):
        self.grid = grid
        self._dplan_of = None
        _check_dist(apply_env_overrides(options or Options()), A)
        super().__init__(A, options=options, stat=stat,
                         device=_grid_device(grid, device))

    def refactor(self, A_new, fact: Fact = Fact.SAME_PATTERN_SAME_ROWPERM
                 ) -> "DistributedSparseLU":
        _check_dist(self.options, A_new)
        return super().refactor(A_new, fact)

    # -- the factor on the grid ------------------------------------------

    def _build_tapes(self):
        """Partition the plan over the grid and build the kernels' job
        lists, once per plan."""
        plan, dev = self.plan, self.device
        self.dplan = _dist2d.partition_plan(plan, self.grid.nprow,
                                            self.grid.npcol)
        self._ft = _rdma.build_factor_tapes(plan, self.dplan, dev)
        self._lt = _rdma.build_sweep_tapes(plan, self.dplan, "L", dev)
        self._ut = _rdma.build_sweep_tapes(plan, self.dplan, "U", dev)
        self._dplan_of = plan

    def _build_coo_shards(self):
        """The COO of the current A, split evenly over the ranks, for the
        distributed residual (re-made per factorization, so a refactor
        refines against its own values)."""
        self._coo_shards = _dist2d.coo_shards(
            self._A_orig, self.grid.size, self.refine_dtype, self.device)

    def _device_factor(self, A3: sp.csc_matrix):
        self.pool = self.linv = self.uinv = self._fstate = None
        stat, plan = self.stat, self.plan
        self._a3_data = np.asarray(A3.data)
        with stat.phase("DIST"):
            if self._dplan_of is not plan:
                self._build_tapes()
            pools = _dist2d.init_local_pools(plan, self.dplan, A3.data,
                                             self.dtype, self.device)
            self._build_coo_shards()
        stat.counters.update(self.dplan.comm_volume(
            np.dtype(self.dtype).itemsize))
        stat.counters["executor"] = self.executor = "rdma"
        stat.counters["dist_executor"] = self.options.dist_executor
        stat.counters["gemm_precision"] = "highest"
        with stat.phase("FACT"):
            st = _rdma.rdma_factor(pools, self._thresh(), self._ft)
        self._fstate = st
        self.pool, self.linv, self.uinv = st.pool, st.linv, st.uinv
        # the tiny-pivot sum over the ranks, in rank order
        stat.tiny_pivots += int(sum(int(t.item()) for t in st.tiny))

    def factor_recv(self) -> dict:
        """The factor's receive counts as (pr, pc, nlvl) arrays by kind
        (``rcv_li``, ``rcv_ui``, ``rcv_l``, ``rcv_u``), as the puts tallied
        them; equal to ``build_rdma_recv_tapes`` of the plan."""
        return _rdma.stacked_recv(self._fstate.recv, self.grid.nprow,
                                  self.grid.npcol, _rdma.FACTOR_RECV)

    # -- solves ----------------------------------------------------------

    def _lu_solve(self, r: torch.Tensor) -> torch.Tensor:
        """x = A⁻¹ r: the transforms of :meth:`SparseLU._lu_solve`, then
        the L and U sweeps on every rank's replicated X."""
        plan = self.plan
        fdt = _TORCH[self.dtype]
        k = r.shape[1]
        rs = self._t_rs.to(r.dtype)[:, None]
        bp = torch.zeros((plan.n_pad, k), dtype=fdt, device=self.device)
        bp[self._t_ridx] = (rs * r[self._t_prc]).to(fdt)
        X, rl, ru = _rdma.rdma_solve(self.pool, self.linv, self.uinv,
                                     self._lt, self._ut,
                                     bp.view(plan.nb, plan.bs, k))
        self._solve_recv = (rl, ru)
        y = X.reshape(plan.n_pad, k)[self._t_ridx].to(r.dtype)
        x = torch.zeros((self.n, k), dtype=r.dtype, device=self.device)
        x[self._t_pc] = self._t_cs.to(r.dtype)[:, None] * y
        return x

    def solve_recv(self) -> tuple:
        """The last solve's receive counts: for the L and the U sweep a
        dict of (pr, pc, nlvl) arrays ``rcv_part`` and ``rcv_x``."""
        pr, pc = self.grid.nprow, self.grid.npcol
        return tuple(_rdma.stacked_recv(r, pr, pc, _rdma.SOLVE_RECV)
                     for r in self._solve_recv)

    def solve(self, b, trans=Trans.NOTRANS):
        if _parse_trans(trans) != Trans.NOTRANS:
            _todo("the transposed solve", _TRANS_ITEM)
        return super().solve(b)

    def solve_transposed(self, b, conj: bool = False):
        _todo("the transposed solve", _TRANS_ITEM)

    def _lu_solve_t(self, r):
        _todo("the transposed solve", _TRANS_ITEM)

    def rcond_1(self) -> float:
        _todo("the condition estimate (rcond_1)", _TRANS_ITEM)

    def profile_levels(self):
        _todo("profile_levels", _PROFILE_ITEM)

    def _berr_t(self, x: torch.Tensor, b: torch.Tensor,
                trans: Trans = Trans.NOTRANS):
        """Componentwise backward error of :meth:`SparseLU._berr_t`, with
        A·x and |A|·|x| by the distributed SpMV over the ranks' COO
        shards (the JAX package's in-mesh ``berr_of``)."""
        if trans != Trans.NOTRANS:
            _todo("the transposed residual", _TRANS_ITEM)
        r = b - _dist2d.dist_spmv(self._coo_shards, x, self.n)
        denom = _dist2d.dist_spmv(self._coo_shards, x.abs(), self.n,
                                  absolute=True) + b.abs()
        nz = self._max_row_nnz() + 1
        safe1 = nz * np.finfo(np.float64).tiny
        safe2 = safe1 / np.finfo(np.float64).eps
        num = r.abs()
        val = torch.where(denom > safe2, num / torch.clamp(denom, min=safe1),
                          (num + safe1) / (denom + safe1))
        return val.amax(dim=0), r

    # -- extras ----------------------------------------------------------

    def _owned(self, slots):
        """For global slots ``slots``: each rank's (positions in
        ``slots``, local slots) of the ones it owns."""
        dp = self.dplan
        own = np.asarray(dp.owner_dev)[slots]
        loc = np.asarray(dp.local_slot)[slots]
        for e in range(self.grid.size):
            sel = np.flatnonzero(own == e)
            if len(sel):
                yield e, sel, loc[sel]

    def diag_u(self) -> np.ndarray:
        """Diagonal of U in elimination order, gathered from the owners of
        the diagonal blocks (reference: pdGetDiagU.c)."""
        plan, dev = self.plan, self.device
        d = torch.empty((plan.nb, plan.bs), dtype=self.pool[0].dtype,
                        device=dev)
        for e, sel, loc in self._owned(np.asarray(plan.diag_slot)):
            d[torch.as_tensor(sel, device=dev)] = torch.diagonal(
                self.pool[e][torch.as_tensor(loc, device=dev)],
                dim1=1, dim2=2)
        d = d.reshape(-1).cpu().numpy()
        return d[slice(0, self.n) if self._expand is None else self._expand]

    def _export_factors(self):
        """The per-rank factors gathered into the single-device layout
        (pool rows by global slot, with the zero and trash slots at
        nslots and nslots + 1; inverses by elimination step), so that
        ``save_factors`` writes a checkpoint that loads as a single-device
        :class:`SparseLU`."""
        plan, dp, dev = self.plan, self.dplan, self.device
        bs, nb = plan.bs, plan.nb
        pool = torch.zeros((plan.nslots + 2, bs, bs),
                           dtype=self.pool[0].dtype, device=dev)
        for e, sel, loc in self._owned(np.arange(plan.nslots)):
            pool[torch.as_tensor(sel, device=dev)] = \
                self.pool[e][torch.as_tensor(loc, device=dev)]
        linv = torch.zeros((nb, bs, bs), dtype=pool.dtype, device=dev)
        uinv = torch.zeros_like(linv)
        idx = np.asarray(dp.dinv_idx)
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
        bs) and ``linv``/``uinv`` of shape (pr, pc, dlen + 1, bs, bs). The
        plan is partitioned again, and its ``n_local`` and ``dlen`` must
        agree with the arrays'."""
        options = apply_env_overrides(state.get("options") or Options())
        _check_dist(options, state["a_data"])
        lu = cls._restore(dict(state, options=options),
                          _grid_device(grid, device))
        lu.grid = grid
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
        fdt = _TORCH[lu.dtype]

        def ranks(a):
            return [torch.tensor(a[r, c], dtype=fdt, device=lu.device)
                    for r in range(pr) for c in range(pc)]

        lu.pool, lu.linv, lu.uinv = ranks(pool), ranks(linv), ranks(uinv)
        lu._fstate = None
        lu.executor = "rdma"
        lu._build_coo_shards()
        return lu


def gssvx_dist(A, b, grid: Grid2D, options: Optional[Options] = None, *,
               device=None):
    """Distributed one-call driver: factor A over ``grid``, solve and
    refine. Returns (SolveResult, DistributedSparseLU). ``device``
    defaults to ``cuda``; ``"cpu"`` runs the plain PyTorch versions."""
    options = options or Options()
    stat = Stats()
    lu = DistributedSparseLU(A, grid, options=options, stat=stat,
                             device=device)
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

