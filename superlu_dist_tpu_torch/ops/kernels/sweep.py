"""The level-set schedule of the triangular sweeps, and row 3's plain
version.

Counterpart of the JAX package's whole-sweep solve kernel
(``pallas_exec._sweep_kernel`` through ``build_solve_fn_pallas_fused``)
and of the level loop of ``blocklu._solve_core``: every contribution into
block row I, and I's diagonal apply, sit in I's level, and every source
row is at a lower level (``ops/host/symbolic.py::_level_schedule``). This
module holds the tapes (a CSR by destination in level order, each chain
cut into chunks) and :func:`sweep_level_plain`; the card runs the sweeps
through ``solve_gemm.py`` (``csrc/solve_gemm.cu``'s two passes per
level), the NOTRANS solve by ``solve_gemm.solve``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..host.symbolic import SymbolicPlan

#: CTAs that the products of one level should fill when it has enough of
#: them: two per SM of an H100 (132 SMs). ``chunk_chains`` cuts chains so.
CHUNK_CTAS = 2 * 132


@dataclasses.dataclass
class SweepTape:
    """One sweep's levels: the block rows ``rows[dptr[l]:dptr[l+1]]`` of
    level l; row b's contributions are ``cslot``/``csrc`` over
    ``rowptr[b]:rowptr[b+1]`` (a CSR by destination, in level order).
    Each row's chain is cut into chunks in tape order: row b's chunks are
    ``chunkptr[b]:chunkptr[b+1]``, chunk q's triples ``cptr[q]:cptr[q+1]``
    (``solve_gemm.cu``'s first pass runs one CTA per chunk); level l's
    chunks are ``qptr[l]:qptr[l+1]``. ``dptr`` and ``qptr`` are host
    arrays, the rest int32 device tensors; ``scratch`` caches the partial
    sums' buffers of ``solve_gemm.py`` by (dtype, nrhs, device), and
    ``levels`` the launch arguments of :meth:`launch_levels`."""

    nlvl: int
    dptr: np.ndarray
    rows: torch.Tensor
    rowptr: torch.Tensor
    cslot: torch.Tensor
    csrc: torch.Tensor
    host: dict
    chunkptr: torch.Tensor
    cptr: torch.Tensor
    qptr: np.ndarray
    scratch: dict = dataclasses.field(default_factory=dict, repr=False)
    levels: list | None = dataclasses.field(default=None, repr=False)

    @property
    def max_chunks(self) -> int:
        """The most chunks of one level."""
        return int(np.diff(self.qptr).max(initial=0))

    def launch_levels(self) -> list:
        """Per level, the two passes' arguments as plain ints, made once
        (the tensors never move): (address of the level's ``cptr``, its
        chunks, address of its ``rows``, address of its ``chunkptr``, its
        first chunk, its rows)."""
        if self.levels is None:
            cp, rw, ch = (t.data_ptr() for t in (self.cptr, self.rows,
                                                  self.chunkptr))
            q, d = self.qptr.tolist(), self.dptr.tolist()
            self.levels = [(cp + 4 * q[i], q[i + 1] - q[i], rw + 4 * d[i],
                            ch + 4 * d[i], q[i], d[i + 1] - d[i])
                           for i in range(self.nlvl)]
        return self.levels


def build_sweep_tape(plan: SymbolicPlan, which: str, device) -> SweepTape:
    p = plan
    if which == "L":
        gslot, gsrc, gdst = p.lsol_gslot, p.lsol_gsrc, p.lsol_gdst
        dptr, rows, nlvl = p.lsol_dptr, p.lsol_diag, p.lsol_nlvl
    else:
        gslot, gsrc, gdst = p.usol_gslot, p.usol_gsrc, p.usol_gdst
        dptr, rows, nlvl = p.usol_dptr, p.usol_diag, p.usol_nlvl
    return csr_tape(p.nb, gslot, gsrc, gdst, dptr, rows, nlvl, device)


def chunk_chains(rowptr, dptr, chunk=None, empty: bool = False):
    """Cut each destination's chain of ``rowptr`` into chunks of at most
    c products, in tape order and of near-equal sizes. Per level, c is
    ``chunk`` (an int, or an array of one length per level), or else the
    level's products over CHUNK_CTAS (at least 1), so that a level with
    enough products fills the card and its longest chains spread over
    many CTAs. A chain of no products has no chunk, or with ``empty`` one
    empty chunk. Returns (chunkptr, cptr, qptr)."""
    rowptr = np.asarray(rowptr, dtype=np.int64)
    dptr = np.asarray(dptr, dtype=np.int64)
    lens = np.diff(rowptr)
    per_level = rowptr[dptr[1:]] - rowptr[dptr[:-1]]
    c = np.maximum(1, per_level // CHUNK_CTAS) if chunk is None else \
        np.broadcast_to(np.asarray(chunk, dtype=np.int64), per_level.shape)
    c_row = np.repeat(c, np.diff(dptr))
    nk = np.maximum(-(-lens // c_row), 1 if empty else 0)
    chunkptr = np.concatenate([[0], np.cumsum(nk)])
    row = np.repeat(np.arange(len(lens)), nk)
    i = np.arange(chunkptr[-1]) - chunkptr[row]
    start = rowptr[row] + i * lens[row] // nk[row]
    cptr = np.concatenate([start, rowptr[-1:]])
    return chunkptr, cptr, chunkptr[dptr]


def csr_tape(nb, gslot, gsrc, gdst, dptr, rows, nlvl, device,
             chunk: int | None = None) -> SweepTape:
    """A :class:`SweepTape` from a level schedule: the (slot, src, dst)
    triples, and the block rows ``rows[dptr[l]:dptr[l+1]]`` of level l;
    ``chunk`` fixes the chunk length (:func:`chunk_chains`)."""
    rows = np.asarray(rows, dtype=np.int64)
    gdst = np.asarray(gdst, dtype=np.int64)
    dptr = np.asarray(dptr, dtype=np.int64)
    # position of each block row in the level-ordered row list; sort the
    # contributions by it (stable: the plan's order within a row stays)
    where = np.empty(nb, dtype=np.int64)
    where[rows] = np.arange(len(rows))
    o = np.argsort(where[gdst], kind="stable")
    rowptr = np.zeros(len(rows) + 1, dtype=np.int64)
    rowptr[1:] = np.cumsum(np.bincount(where[gdst], minlength=len(rows)))
    chunkptr, cptr, qptr = chunk_chains(rowptr, dptr, chunk)
    host = dict(rows=rows, rowptr=rowptr,
                cslot=np.asarray(gslot, dtype=np.int64)[o],
                csrc=np.asarray(gsrc, dtype=np.int64)[o],
                chunkptr=chunkptr, cptr=cptr)

    def dev(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int32), device=device)

    return SweepTape(nlvl=int(nlvl), dptr=dptr, rows=dev(rows),
                     rowptr=dev(rowptr), cslot=dev(host["cslot"]),
                     csrc=dev(host["csrc"]), host=host,
                     chunkptr=dev(chunkptr), cptr=dev(cptr), qptr=qptr)


def sweep_level_plain(pool, dinv, X, tape: SweepTape, level: int) -> None:
    """One level of a sweep, in place on ``X`` (nb, bs, nrhs):
    X[I] = dinv[I]·(X[I] − Σ pool[slot]·X[src]) for the level's rows (the
    plain version of ``solve_gemm.solve_level`` with ``transpose=False``,
    operation for operation)."""
    h = tape.host
    lo, hi = int(tape.dptr[level]), int(tape.dptr[level + 1])
    if hi == lo:
        return
    c0, c1 = int(h["rowptr"][lo]), int(h["rowptr"][hi])
    dev = X.device
    if c1 > c0:
        cnt = np.diff(h["rowptr"][lo:hi + 1])
        dst = torch.as_tensor(np.repeat(h["rows"][lo:hi], cnt), device=dev)
        sl = torch.as_tensor(h["cslot"][c0:c1], device=dev)
        src = torch.as_tensor(h["csrc"][c0:c1], device=dev)
        X.index_add_(0, dst, pool[sl] @ X[src], alpha=-1)
    r = torch.as_tensor(h["rows"][lo:hi], device=dev)
    X[r] = dinv[r] @ X[r]
