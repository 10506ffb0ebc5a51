"""Rank buffers that every process of a grid reaches.

The grid's kernels (``parallel/dist2d_rdma.py``) put blocks by storing
into the peer ranks' buffers, whose pointers they read from a device
table. When the ranks of a grid are split over several processes
(``parallel/multihost.py``, all on the one card), a :class:`Window` makes
every rank's buffers reachable from every process:

- each process allocates its own ranks' tensors;
- it exports them: a CUDA IPC handle on the card (PyTorch's
  ``UntypedStorage._share_cuda_``, which carries the offset of the tensor
  in its ``cudaMalloc`` segment and keeps the segment alive while a peer
  maps it), a shared-memory file on the CPU (``torch.from_file(...,
  shared=True)`` in a directory that process 0 makes under the temporary
  directory);
- it allgathers the handles and opens the peers' as tensors, so the
  pointer tables hold the own ranks' pointers and the peers' mappings;
- :meth:`Window.fence`: synchronize the stream, then a barrier, after
  which every store of every process before it is visible;
- :meth:`Window.close`: a barrier, then the window drops the peers'
  mappings and its own tensors, so nothing is freed while a peer still
  maps it.

On the CPU, the plain versions of the kernels take turns within a phase
(:meth:`Window.turns`): process after process, in process order, with a
barrier between turns, which keeps the single-process order of every
store and makes their counter increments race-free. On the card each
process launches its own ranks' jobs, and the kernels' atomics count.

Under one process a window is plain allocation: no handle, no fence, no
cost. The fences are counted and timed in :data:`FENCES`, the shared
allocations (with their handle exchange) in :data:`ALLOCS`.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
import time

import torch

from . import multihost as _mh
from .grid import process_share


class Tally:
    """How many times a step of this process's windows ran, and the
    seconds it took."""

    def __init__(self):
        self.count = 0
        self.seconds = 0.0

    def reset(self) -> None:
        self.count, self.seconds = 0, 0.0

    def add(self, t0: float) -> None:
        """One more, which started at ``time.perf_counter()`` ``t0``."""
        self.count += 1
        self.seconds += time.perf_counter() - t0


#: the fences (the stream's synchronize and the barrier)
FENCES = Tally()
#: the shared allocations (the tensors, their handles' allgather and the
#: peers' openings)
ALLOCS = Tally()

#: the directory of this process group's shared-memory files (CPU)
_DIR = None


def _shm_dir() -> str:
    """The directory of the CPU windows' files: made once by process 0
    under the temporary directory, its name broadcast (a collective)."""
    global _DIR
    if _DIR is None:
        d = None
        if _mh.process_index() == 0:
            d = tempfile.mkdtemp(prefix="slu_window_")
            atexit.register(shutil.rmtree, d, True)
        _DIR = _mh.bcast_obj(d)
    return _DIR


class Window:
    """The buffers of a grid of ``ndev`` ranks on ``device``, of which
    this process owns ``[lo, hi)`` (:func:`grid.process_share`). Every
    call is collective: all processes make the same calls in the same
    order."""

    _serial = 0

    def __init__(self, ndev: int, device):
        self.ndev = ndev
        self.device = torch.device(device)
        self.lo, self.hi = process_share(ndev)
        self.shared = _mh.process_count() > 1
        self._held = []
        self._scratch = {}

    @property
    def ranks(self) -> range:
        return range(self.lo, self.hi)

    def alloc(self, shape, dtype) -> list:
        """One zeroed tensor of ``shape`` and ``dtype`` per rank (index =
        rank): this process's own, and the peers' opened through their
        handles."""
        if not self.shared:
            return [torch.zeros(shape, dtype=dtype, device=self.device)
                    for _ in range(self.ndev)]
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            # free the own blocks of earlier windows that no peer maps any
            # more (the caching allocator keeps a shared block until then)
            torch.cuda.ipc_collect()
        own = {d: self._new(shape, dtype) for d in self.ranks}
        if self.device.type == "cuda":
            # the zeros are written before a peer can store into them
            torch.cuda.synchronize(self.device)
        handles = _mh.allgather_obj({d: h for d, (_, h) in own.items()})
        out = [None] * self.ndev
        for d, (t, _) in own.items():
            out[d] = t
        for p, hs in enumerate(handles):
            if p != _mh.process_index():
                for d, h in hs.items():
                    out[d] = self._open(h, shape, dtype)
        if self.device.type == "cpu":
            # every peer has mapped the files: the names can go
            _mh.barrier()
            for t, h in own.values():
                if h is not None:
                    os.unlink(h)
        self._held.append(out)
        ALLOCS.add(t0)
        return out

    def _new(self, shape, dtype):
        """This process's tensor of one rank, and its handle."""
        numel = 1
        for s in shape:
            numel *= s
        if self.device.type == "cuda":
            t = torch.zeros(shape, dtype=dtype, device=self.device)
            return t, t.untyped_storage()._share_cuda_()
        if numel == 0:
            return torch.zeros(shape, dtype=dtype), None
        Window._serial += 1
        path = os.path.join(_shm_dir(), f"p{_mh.process_index()}_"
                            f"{Window._serial}")
        t = torch.from_file(path, shared=True, size=numel, dtype=dtype)
        return t.view(shape), path

    def _open(self, handle, shape, dtype) -> torch.Tensor:
        """A peer's tensor from its handle; a handle that does not open
        raises."""
        if self.device.type == "cuda":
            st = torch.UntypedStorage._new_shared_cuda(*handle)
            t = torch.empty(0, dtype=dtype, device=self.device)
            return t.set_(st, 0, shape)
        if handle is None:
            return torch.zeros(shape, dtype=dtype)
        numel = 1
        for s in shape:
            numel *= s
        return torch.from_file(handle, shared=True, size=numel,
                               dtype=dtype).view(shape)

    def scratch(self, key, shape, dtype) -> list:
        """Per-rank buffers kept under ``key`` for reuse: two sets taken
        in turn, so that a buffer is written again only after a fence that
        follows every process's reads of its last contents."""
        pair = self._scratch.get(key)
        if pair is None:
            pair = self._scratch[key] = [self.alloc(shape, dtype),
                                         self.alloc(shape, dtype), 0]
        pair[2] ^= 1
        return pair[pair[2]]

    def fence(self) -> None:
        """Every store of every process so far is visible to all: this
        process's stream synchronized, then a barrier. Free under one
        process."""
        if not self.shared:
            return
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        _mh.barrier()
        FENCES.add(t0)

    def each_turn(self):
        """Yields once, in this process's turn: processes run one after
        another in process order, the stream synchronized and a barrier
        after each turn, so the stores keep the single-process order. The
        last barrier ends the turns for everyone."""
        if not self.shared:
            yield
            return
        for p in range(_mh.process_count()):
            if p == _mh.process_index():
                yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            _mh.barrier()

    def turns(self):
        """This process's ranks, yielded in its turn (:meth:`each_turn`):
        the rank loops of the plain versions on the CPU."""
        for _ in self.each_turn():
            yield from self.ranks

    def close(self) -> None:
        """Release the window: a barrier (no peer still reads or writes),
        then the peers' mappings and the own tensors are dropped."""
        if self.shared:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            _mh.barrier()
        self._held.clear()
        self._scratch.clear()
