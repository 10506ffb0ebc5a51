"""The 2D and 3D process grids of the distributed drivers.

Counterpart of the JAX package's ``parallel/grid.py`` (``superlu_gridinit``
analog, reference: SRC/prec-independent/superlu_grid.c:37-230). There the
grid is a ``jax.sharding.Mesh`` whose axes carry the collectives; here it
is a map from each rank (r, c) of the Pr × Pc grid, or (z, r, c) of the
Pz × Pr × Pc grid, to a torch device. Every rank sits on the driver's
device: the card by default, the CPU in the tests. One process drives
every rank, or the ranks are split over the P processes of a
``torch.distributed`` group (``parallel/multihost.py``): rank d belongs
to process d // (size / P), a contiguous share, as the JAX package's
mesh orders devices process-major (so ``Grid3D(2, 2, 2)`` over two
processes gives each one layer). Every process of a grid sits on the one
card; ranks on several cards are not served yet (ROADMAP.md, queue 1
item 8d).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

#: the ROADMAP item that serves a grid spread over several cards
SEVERAL_CARDS = "queue 1 item 8d"


class _Grid:
    """What both grids share: ``devices`` (None, or one device per rank,
    all the same) and the device every rank runs on."""

    devices = None

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    def owned_ranks(self) -> range:
        """The ranks this process drives (all of them in one process)."""
        return range(*process_share(self.size))

    def process_of(self, rank: int) -> int:
        """The process that drives ``rank``."""
        return rank // (self.size // _processes(self.size))

    def rank_device(self, default) -> torch.device:
        """The device every rank runs on: the grid's own, else
        ``default`` (the driver's)."""
        if self.devices is None:
            return torch.device(default)
        return self.devices[0]


class Grid2D(_Grid):
    """Pr × Pc logical process grid. ``devices`` optionally names the
    device of each rank, rank r·Pc + c first; they must all be one
    device. Without ``devices`` every rank takes the driver's device."""

    def __init__(self, nprow: int, npcol: int,
                 devices: Optional[Sequence] = None):
        if nprow < 1 or npcol < 1:
            raise ValueError(f"grid {nprow}x{npcol} needs at least one row "
                             "and one column")
        self.nprow = nprow
        self.npcol = npcol
        self.devices = _one_device(self.shape, devices)

    @property
    def shape(self):
        return (self.nprow, self.npcol)

    def __repr__(self):
        return f"Grid2D({self.nprow}x{self.npcol})"


class Grid3D(_Grid):
    """Pz × Pr × Pc grid (``superlu_gridinit3d`` analog, the JAX
    package's ``Grid3D``): Pz layers of a Pr × Pc grid, rank (z·Pr + r)·Pc
    + c. Each layer factors its own subtrees of the elimination forest and
    the ancestors are reduced over the layers (``parallel/dist3d.py``).
    ``devices`` as for :class:`Grid2D`: every rank sits on one device."""

    def __init__(self, npdep: int, nprow: int, npcol: int,
                 devices: Optional[Sequence] = None):
        if min(npdep, nprow, npcol) < 1:
            raise ValueError(f"grid {npdep}x{nprow}x{npcol} needs at least "
                             "one layer, row and column")
        self.npdep = npdep
        self.nprow = nprow
        self.npcol = npcol
        self.devices = _one_device(self.shape, devices)

    @property
    def shape(self):
        return (self.npdep, self.nprow, self.npcol)

    def __repr__(self):
        return f"Grid3D({self.npdep}x{self.nprow}x{self.npcol})"


def _one_device(shape, devices):
    """The grid's devices (None for the driver's), which must all be one
    device."""
    if devices is None:
        return None
    devices = [torch.device(d) for d in devices]
    need = int(np.prod(shape))
    dims = "x".join(map(str, shape))
    if need > len(devices):
        raise ValueError(f"grid {dims} needs {need} devices, have "
                         f"{len(devices)}")
    devices = devices[:need]
    if len(set(map(_canonical, devices))) > 1:
        raise NotImplementedError(
            f"ranks on several devices ({sorted(set(map(str, devices)))})"
            f" are not ported yet (ROADMAP.md, {SEVERAL_CARDS}): "
            "every rank of a grid runs on one device")
    return devices


def _processes(size: int) -> int:
    """The processes that split a grid of ``size`` ranks, which must
    divide it."""
    from .multihost import process_count
    nproc = process_count()
    if size % nproc:
        raise ValueError(f"a grid of {size} ranks does not split evenly "
                         f"over {nproc} processes")
    return nproc


def process_share(size: int) -> tuple:
    """This process's ranks [lo, hi) of a grid of ``size`` ranks."""
    from .multihost import process_index
    per = size // _processes(size)
    lo = process_index() * per
    return lo, lo + per


def _canonical(d: torch.device) -> str:
    """``cuda`` and ``cuda:<current>`` name one card."""
    if d.type == "cuda" and d.index is None and torch.cuda.is_available():
        return f"cuda:{torch.cuda.current_device()}"
    return str(d)
