"""Several processes on one grid (the JAX package's ``parallel/multihost.py``).

The reference is a distributed-memory solver: every rank holds a shard
and MPI carries the collectives (superlu_gridinit splits MPI_COMM_WORLD,
SRC/prec-independent/superlu_grid.c:37-230). In this port a grid's ranks
are split over the processes of a ``torch.distributed`` group with the
gloo backend: every process owns a contiguous share of the ranks
(``parallel/grid.py``), and the ranks' buffers are reached through
``parallel/window.py`` (CUDA IPC on the card, shared-memory files on the
CPU), so the kernels of ``parallel/dist2d_rdma.py`` store into another
process's buffers as they store into their own. gloo carries only host
objects (permutations, plans, buffer handles) and barriers, never a block
of a factor. NCCL is not used: it refuses two ranks of one communicator
on one device, and every process of a grid sits on the one card.

- :func:`initialize`: connect this process (superlu_gridinit's MPI_Init
  role). It is never called implicitly.
- :func:`process_count`, :func:`process_index`: 1 and 0 when no process
  group is up, so a single process pays nothing.
- :func:`bcast_obj`, :func:`allgather_obj`, :func:`gather_obj`,
  :func:`barrier`.
- :class:`PreprocessOnce`: process 0 preprocesses and symbolically
  factors, then broadcasts (the pdgssvx3d.c:628-959 pattern).

The JAX package's ``replicate`` and ``shard`` (host arrays to global jax
Arrays) and ``gather_sharded_blocks`` have no counterpart: the port has
no global arrays, each process keeps its own ranks' tensors, and the
owner-gather of a checkpoint reads the other processes' blocks through
the window.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["initialize", "process_count", "process_index", "bcast_obj",
           "allgather_obj", "gather_obj", "barrier", "PreprocessOnce"]


class PreprocessOnce:
    """Driver mixin: host preprocessing runs ONCE on process 0 and is
    broadcast — equilibration, MC64/HWPM, ordering, alignment, symbolic
    (the layer-0-preprocess-then-MPI_Bcast pattern of pdgssvx3d,
    reference: SRC/double/pdgssvx3d.c:628-959). Single-process: plain
    inheritance, zero overhead."""

    def _preprocess(self, A, reuse_perms: bool = False,
                    reuse_colperm: bool = False):
        import scipy.sparse as sp
        if process_count() == 1 or reuse_perms:
            # local preprocessing recomputes everything from THIS A —
            # stale broadcast norms from a previous factorization would
            # otherwise set the tiny-pivot threshold / rcond scale from
            # the old matrix's values
            self._anorm_global = None
            self._anorm1_global = None
            self._nz_global = None
            return super()._preprocess(A, reuse_perms, reuse_colperm)
        if process_index() == 0:
            A3 = super()._preprocess(A, reuse_perms, reuse_colperm)
            extras = dict(
                anorm=float(np.abs(A3.data).max()) if A3.nnz else 1.0,
                anorm1=float(np.abs(A).sum(axis=0).max()),
                nz=int(A.getnnz(axis=1).max()))
            bcast_obj((self.row_scale, self.col_scale, self.rowperm,
                       self.colperm, self._expand, self._n_e,
                       self.equed, extras))
            self._anorm_global = extras["anorm"]
            self._anorm1_global = extras["anorm1"]
            self._nz_global = extras["nz"]
            return A3
        (self.row_scale, self.col_scale, self.rowperm, self.colperm,
         self._expand, self._n_e, self.equed, extras) = bcast_obj()
        self._anorm_global = extras["anorm"]
        self._anorm1_global = extras["anorm1"]
        self._nz_global = extras["nz"]
        A3 = A.multiply(self.row_scale[:, None]) \
             .multiply(self.col_scale[None, :]).tocsc()
        A3 = A3[self.rowperm, :][self.colperm, :][:, self.colperm]
        return self._expand_A(sp.csc_matrix(A3))

    def _symbolic(self, A3):
        if process_count() == 1:
            return super()._symbolic(A3)
        if process_index() == 0:
            plan = super()._symbolic(A3)
            bcast_obj(plan)
            return plan
        return bcast_obj()


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Connect this process to the others (MPI_Init role): a gloo process
    group on a TCP store at ``coordinator_address`` ("host:port", process
    0 listens there). Without arguments the ``torch.distributed``
    environment variables (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK)
    name them."""
    if coordinator_address is None:
        dist.init_process_group("gloo", init_method="env://")
        return
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def _up() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if _up() else 1


def process_index() -> int:
    return dist.get_rank() if _up() else 0


def barrier() -> None:
    """Wait until every process got here (no-op in a single process)."""
    if process_count() > 1:
        dist.barrier()


def allgather_obj(obj):
    """Allgather one picklable object per process; every process returns
    the list [obj_0, ..., obj_{P-1}] in process order (the MPI_Allgatherv
    role behind distributed planning — payloads are block-level keys,
    O(a_blocks), never the scalar pattern)."""
    if process_count() == 1:
        return [obj]
    out = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def gather_obj(obj):
    """Gather one picklable object per process to process 0, which gets
    the list in process order; the others get None."""
    if process_count() == 1:
        return [obj]
    out = [None] * process_count() if process_index() == 0 else None
    dist.gather_object(obj, out, dst=0)
    return out


def bcast_obj(obj=None):
    """Broadcast a picklable object from process 0 to every process
    (pdgssvx3d's MPI_Bcast of perms/scalars, pdgssvx3d.c:850-959).

    Process 0 passes the object; the others pass None and receive it.
    Single-process: returns ``obj`` unchanged."""
    if process_count() == 1:
        return obj
    box = [obj if process_index() == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def device_key(device: torch.device) -> str:
    """What names this process's card among the processes: its UUID (the
    CPU is one place for every process)."""
    if device.type != "cuda":
        return "cpu"
    return str(torch.cuda.get_device_properties(device).uuid)
