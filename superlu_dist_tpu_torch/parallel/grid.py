"""The 2D process grid of the distributed driver.

Counterpart of the JAX package's ``parallel/grid.py`` (``superlu_gridinit``
analog, reference: SRC/prec-independent/superlu_grid.c:37-230). There the
grid is a ``jax.sharding.Mesh`` whose axes carry the collectives; here it
is a map from each rank (r, c) of the Pr × Pc grid to a torch device, and
one process drives every rank (the JAX package's 2D driver is single-
controller too). Every rank sits on the driver's device: the card by
default, the CPU in the tests. Ranks on several cards are not served yet
(ROADMAP.md, queue 1 item 8d).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

#: the ROADMAP item that serves a grid spread over several cards
SEVERAL_CARDS = "queue 1 item 8d"


class Grid2D:
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
        self.devices = None
        if devices is not None:
            devices = [torch.device(d) for d in devices]
            if nprow * npcol > len(devices):
                raise ValueError(
                    f"grid {nprow}x{npcol} needs {nprow * npcol} devices, "
                    f"have {len(devices)}")
            devices = devices[: nprow * npcol]
            if len(set(map(_canonical, devices))) > 1:
                raise NotImplementedError(
                    f"ranks on several devices ({sorted(set(map(str, devices)))})"
                    f" are not ported yet (ROADMAP.md, {SEVERAL_CARDS}): "
                    "every rank of a grid runs on one device")
            self.devices = devices

    @property
    def shape(self):
        return (self.nprow, self.npcol)

    @property
    def size(self) -> int:
        return self.nprow * self.npcol

    def rank_device(self, default) -> torch.device:
        """The device every rank runs on: the grid's own, else
        ``default`` (the driver's)."""
        if self.devices is None:
            return torch.device(default)
        return self.devices[0]

    def __repr__(self):
        return f"Grid2D({self.nprow}x{self.npcol})"


def _canonical(d: torch.device) -> str:
    """``cuda`` and ``cuda:<current>`` name one card."""
    if d.type == "cuda" and d.index is None and torch.cuda.is_available():
        return f"cuda:{torch.cuda.current_device()}"
    return str(d)
