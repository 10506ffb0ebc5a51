"""The 3D communication-avoiding driver (``pdgssvx3d`` on a Pz × Pr × Pc
grid).

Port of the JAX package's ``models/driver3d.py``: the host pipeline of
:class:`SparseLU` (equilibrate → MC64 → column ordering → etree alignment
→ block symbolic), then the factor and the solves of
``parallel/dist3d.py`` over the ranks of a :class:`Grid3D`, all on one
device, in one process or split over several: each layer factors its
subtrees of the elimination forest on the 2D grid's hand-written kernels
(``csrc/rdma.cu``), the ancestors are reduced over the layers, and every
layer factors the top on its replicas (``anc25d="replicated"``) or each
layer its share of the top's Schur products (``"zsplit"``). It is
:class:`DistributedSparseLU` on that partition, and serves what it
serves: float32, float64, complex64 (natively, or the real ring embedding
under ``SLU_TPU_COMPLEX=embed``) and complex128; every ``Trans`` solve
(Aᴴx = b as x = conj(A⁻ᵀ conj(b))); refinement with residuals from a
distributed SpMV whose COO shards cover all Pz·Pr·Pc ranks, summed in
rank order; ``rcond_1`` and ``condition_number``; the ``Fact`` modes and
``refactor``; ``diag_u``, ``logdet`` and ``save_factors`` (the canonical
single-device layout, ancestors from layer 0);
:meth:`Distributed3DSparseLU.profile_levels`; and, as the 2D driver,
grids whose ranks are split over several processes on the one card,
sharded NRLoc input and ``dist_planning`` (its mixins
``ShardedNRLocInput`` and ``multihost.PreprocessOnce``), the reductions
over the layers on the process that owns each layer-0 rank.

As in the JAX package, the plan is kept as built and alignment stays on
(its ``_align_standdown`` returns False; this port's single-device driver
never stands alignment down), and no precision escalation runs.

Deliberate differences from the JAX package:

- ``diag_u`` of a ring-embedded factor reads Im(U_kk) as F(2k+1, 2k)·
  F(2k, 2k), as the port's other drivers do; the JAX package's 3D driver
  reads F(2k+1, 2k) alone (its driver3d.py:425-428), which is b/a, not b.
- ``from_numpy_state`` of a 3D grid state raises: ``save_factors`` writes
  the single-device checkpoint, which ``load_factors`` reads.
- Ranks on several cards raise ``NotImplementedError`` naming ROADMAP.md
  queue 1 item 8d.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..parallel import dist3d as _dist3d
from ..parallel.grid import Grid3D
from ..utils.options import Options, apply_env_overrides
from ..utils.stats import Stats
from .dist_driver import DistributedSparseLU, _gssvx_on


class Distributed3DSparseLU(DistributedSparseLU):
    """3D (z × r × c) distributed factorization over the ranks of
    ``grid``, rank (z·Pr + r)·Pc + c at that index of ``pool``, ``linv``
    and ``uinv``: its ``(n_local [+ max_tact], bs, bs)`` pool (zsplit's
    delta rows after the slots) and its inverse tables by d-tape
    position. ``profile_levels`` times one level of the combined
    schedule per step (the ancestor reduction inside the first top
    level's, zsplit's delta inside its level's); its rows carry
    ``phase`` ("layer" or "top") and count each step and Schur product
    once, as the JAX package's (driver3d.py:283-340 there) do."""

    _grid_type = Grid3D

    def __init__(self, A, grid: Grid3D, options: Optional[Options] = None,
                 stat: Optional[Stats] = None, *, device=None):
        mode = apply_env_overrides(options or Options()).anc25d
        if mode not in _dist3d.ANC25D:
            raise ValueError(f"unknown anc25d {mode!r}; expected one of "
                             f"{_dist3d.ANC25D}")
        super().__init__(A, grid, options=options, stat=stat, device=device)

    # -- the partition and its tapes -------------------------------------

    def _partition(self):
        g = self.grid
        return _dist3d.partition_plan3d(self.plan, g.npdep, g.nprow, g.npcol,
                                        anc25d=self.options.anc25d)

    def _factor_tapes(self):
        self._dinv = _dist3d.inverse_rows(self.plan, self.dplan)
        return _dist3d.build_factor_tapes3d(self.plan, self.dplan,
                                            self.device)

    def _sweep_tapes(self, which: str):
        return _dist3d.build_sweep_tapes3d(self.plan, self.dplan, which,
                                           self.device)

    def _pools0(self, win=None) -> list:
        win = win or self._window()
        extra = self._ft.ndelta
        if self._sharded():
            dev, off, val = self._nrloc_entries(
                _dist3d.nrloc_entry_offsets3d)
            return _dist3d.init_local_pools3d_nrloc(
                self.plan, self.dplan, win, dev, off, val, self._fdtype,
                extra=extra)
        return _dist3d.init_local_pools3d(
            self.plan, self.dplan, self._a3_data, self._fdtype, self.device,
            extra=extra, win=win)

    def _dist_counters(self) -> dict:
        """The JAX package's DIST counters (its driver3d.py:58-101):
        ``comm_volume``, ``anc_steps``, ``layer{z}_steps`` and, under
        zsplit, ``anc25d_zsplit_psum_bytes``."""
        dp, item = self.dplan, np.dtype(self._fdtype).itemsize
        out = dict(dp.comm_volume(item))
        if dp.anc25d == "zsplit":
            out["anc25d_zsplit_psum_bytes"] = int(
                dp.ntop * (dp.max_tact + 1) * dp.bs * dp.bs * item)
        out["anc_steps"] = float(np.sum(dp.step_layer < 0))
        for z in range(dp.pz):
            out[f"layer{z}_steps"] = float(np.sum(dp.step_layer == z))
        return out

    # -- the factor ------------------------------------------------------

    def _run_factor(self, pools, win):
        return _dist3d.rdma_factor3d(pools, self._thresh(), self._ft,
                                     win=win)

    def _factor_level(self, st, thresh, level: int) -> None:
        _dist3d.factor_level3d(st, thresh, self._ft, level)

    def _level_row(self, level: int) -> dict:
        """The counts of the 2D rows, with ``phase`` "layer" or "top"; a
        top level's steps and panels are on every layer and count once,
        and so are its Schur products unless zsplit shares them out (the
        JAX package's driver3d.py:326-332)."""
        row = super()._level_row(level)
        top = level >= self._ft.max_p1
        if top:
            pz = self._ft.pz
            for k in ("steps", "lpanels", "upanels"):
                row[k] //= pz
            if not self._ft.zsplit:
                row["gemms"] //= pz
        return dict(phase="top" if top else "layer", **row)

    # -- extras ----------------------------------------------------------

    def _slot_owner(self):
        return _dist3d.slot_ranks(self.plan, self.dplan), \
            np.asarray(self.dplan.slot_local)

    def _inv_rows(self) -> np.ndarray:
        return self._dinv

    @classmethod
    def from_numpy_state(cls, state: dict, grid, device=None):
        raise NotImplementedError(
            "a 3D grid state does not restore: save_factors writes the "
            "single-device checkpoint, which load_factors reads")


def gssvx3d(A, b, grid: Grid3D, options: Optional[Options] = None, *,
            device=None):
    """3D one-call driver: factor A over ``grid``, solve and refine.
    Returns (SolveResult, Distributed3DSparseLU). ``device`` defaults to
    ``cuda``; ``"cpu"`` runs the plain PyTorch versions. The solve, the
    refinement residuals and berr follow ``options.trans``;
    ``condition_number`` fills ``rcond``."""
    return _gssvx_on(Distributed3DSparseLU, A, b, grid, options, device)
